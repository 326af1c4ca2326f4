"""What the card ran, read from a ``torch.profiler`` Chrome trace.

The rules are copies of ``savgol_tpu_torch.utils.profiling``'s
``trace_events`` / ``device_events`` and of ``chip_smoke.py::idle_share``,
so that the program cannot move them: a device operation is a complete
("X") event of a kernel, a copy or a fill; it belongs to a host window
when the runtime or driver call that launched it, found by the launch's
correlation id, started in that window (the trace may place the operation
itself a fraction of a millisecond off the host's spans); the card is busy
in the union of those operations; and a take in which the profiler
delivered no operation of the card at all is taken again.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
from typing import Callable

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
ANNOTATION = "user_annotation"


def take(run: Callable[[], None], attempts: int = 3) -> tuple[list, int]:
    """Trace ``run()`` with CPU and CUDA activity and return ``(events,
    takes)``: the Chrome trace's ``traceEvents`` and the takes it needed.
    A take holding no device operation is retaken, up to ``attempts``. The
    trace file lives in a fresh directory under ``TMPDIR``, removed here."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    tmp = tempfile.mkdtemp(prefix="gpubench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        for n in range(1, attempts + 1):
            with torch.profiler.profile(activities=acts) as prof:
                run()
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
            if device_ops(events):
                break
        return events, n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def spans(events: list, name: str) -> list[tuple[float, float]]:
    """``(start, end)`` in us of the host spans ``name`` (the benchmark's
    ``record_function`` annotations), in order."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == ANNOTATION
                  and e.get("name") == name)


def device_ops(events: list) -> list:
    """The card's operations, in the order they started."""
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in DEVICE_CATEGORIES),
                  key=lambda e: e["ts"])


def launched_in(events: list, windows: list[tuple[float, float]]
                ) -> list[list]:
    """For each host window ``(t0, t1)`` (sorted, disjoint), the device
    operations whose launching call started in it."""
    starts = [w[0] for w in windows]
    by_corr: dict = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES
                and "correlation" in e.get("args", {})):
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] < windows[i][1]:
                by_corr[e["args"]["correlation"]] = i
    out: list[list] = [[] for _ in windows]
    for e in device_ops(events):
        i = by_corr.get(e.get("args", {}).get("correlation"))
        if i is not None:
            out[i].append(e)
    return out


def busy_intervals(ops: list, t0: float, t1: float
                   ) -> list[tuple[float, float]]:
    """The union of the operations' intervals, clipped to ``[t0, t1]``."""
    merged: list[list[float]] = []
    for e in sorted(ops, key=lambda e: e["ts"]):
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_share(ops: list, t0: float, t1: float) -> float:
    """The share of ``[t0, t1]`` in which the card ran none of ``ops``."""
    busy = sum(b - a for a, b in busy_intervals(ops, t0, t1))
    return 1.0 - busy / (t1 - t0)


def idle_gaps(ops: list, t0: float, t1: float,
              host: dict[str, list[tuple[float, float]]]
              ) -> list[tuple[str, float]]:
    """Every stretch of ``[t0, t1]`` in which the card ran none of
    ``ops``, as ``(label, us)``: the label is the host span of ``host``
    (name -> sorted spans) open where the stretch began, or "between"."""
    gaps, end = [], t0
    for a, b in busy_intervals(ops, t0, t1) + [(t1, t1)]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    starts = {name: [s[0] for s in ss] for name, ss in host.items()}
    out = []
    for g0, g1 in gaps:
        label = "between"
        for name, ss in host.items():
            i = bisect.bisect_right(starts[name], g0) - 1
            if i >= 0 and g0 < ss[i][1]:
                label = name
                break
        out.append((label, g1 - g0))
    return out


def per_call(ctx: dict) -> tuple[int, int, float] | None:
    """``(calls, operations, device us)`` of the traced window's calls: the
    device operations launched inside the ``enqueue`` spans, and the sum of
    their durations; None where the trace holds no call or no operation."""
    calls = ctx["calls"]
    if not calls:
        return None
    ops = [e for group in launched_in(ctx["events"], calls) for e in group]
    if not ops:
        return None
    return len(calls), len(ops), sum(e["dur"] for e in ops)


def roofline_share(ctx: dict, function: str) -> float | None:
    """The call's function bound over the mean device time of all its
    operations, in %, in the cells of ``function``; else None."""
    if ctx["function"] != function:
        return None
    got = per_call(ctx)
    if got is None:
        return None
    calls, _, us = got
    return 100.0 * ctx["bound_s"] / (us * 1e-6 / calls)
