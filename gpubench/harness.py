"""One run of one cell: set-up, the measured window, the traced window and
the check against the plain reference.

The window is a closed loop of identical calls with ``inflight`` of them
outstanding: the host submits a call and records an event after it; once
``inflight`` calls are outstanding it waits on the oldest call's event
before it submits the next. A call's latency runs from the host clock just
before its submission to the return of that wait. The inputs are row
blocks (or frame blocks) of one resident tensor, taken in turn; the
program allocates its outputs. After ``seconds`` no call is submitted and
the outstanding ones are waited for; the window ends when the last returns.

Set-up builds the program, makes the inputs on the card from the seed and
runs ``warmup_calls`` calls of the window's one shape, so that nothing is
built or compiled inside the window. With ``trace`` a second, traced
window of ``TRACE_SECONDS`` follows the first, under ``torch.profiler``,
with the benchmark's host spans ``enqueue`` (a call and its event) and
``wait`` (the wait on an event); the per-layer readers read it.

The outputs of ``CHECK_CALLS`` calls of the window, drawn from the seed
(a reservoir sample), are kept and compared with the plain reference once
the window has closed, the peak memory has been read and the program is
freed.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import random
import select
import statistics
import subprocess
import sys
import time
from typing import Callable, Optional

import torch

from gpubench import layout, roofline, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "savgol_tpu")
TRACE_SECONDS = 1.0     # the traced window, after the measured one
CHECK_CALLS = 2         # calls of the window compared with the reference


def forbidden_modules(names=None) -> list[str]:
    """Of ``names`` (default: the loaded modules), the top-level names,
    compared whole, that are JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    reference: object
    entry: object = None

    @classmethod
    def load(cls, name: str, *, with_entry: bool = True) -> "Cell":
        wl = layout.workload(name)
        cfg = layout.config(wl["config"])
        return cls(name, wl, cfg, layout.reference(cfg["function"]),
                   layout.entry(wl["config"]) if with_entry else None)

    @property
    def call_shape(self) -> tuple:
        r = self.workload["resident"]
        return (self.workload["per_call"], *r[1:])

    @property
    def elements_per_call(self) -> int:
        return math.prod(self.call_shape)


class _Done:
    """A CPU run's stand-in for a CUDA event: the work is done when the
    call returns."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


@dataclasses.dataclass
class Window:
    calls: int = 0
    t0: float = 0.0
    t1: float = 0.0
    latency_s: list = dataclasses.field(default_factory=list)
    host_s: list = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Loop:
    """The closed loop over one cell's inputs: ``call`` on the blocks of
    ``views`` in turn, ``inflight`` outstanding."""

    def __init__(self, call: Callable, views: list, inflight: int,
                 device: torch.device, first_block: int = 0):
        self.call, self.views, self.inflight = call, views, inflight
        self.block = first_block % len(views)
        cuda = device.type == "cuda"
        self.events = [torch.cuda.Event() if cuda else _Done()
                       for _ in range(inflight)]
        self.submitted = 0

    def run(self, *, seconds: Optional[float] = None,
            calls: Optional[int] = None, keep: int = 0,
            rng: Optional[random.Random] = None,
            annotate: bool = False) -> Window:
        """Submit calls for ``seconds`` (or ``calls`` of them), then wait
        for the outstanding ones. ``keep``: how many (input, output) pairs
        to keep, a reservoir sample by ``rng``."""
        rf = torch.profiler.record_function
        w = Window()
        pending: collections.deque = collections.deque()
        n = 0

        def retire():
            ev, ts, x, y = pending.popleft()
            if annotate:
                with rf("wait"):
                    ev.synchronize()
            else:
                ev.synchronize()
            w.latency_s.append(time.perf_counter() - ts)
            if keep:
                k = w.calls
                if k < keep:
                    w.kept.append((x, y))
                else:
                    j = rng.randrange(k + 1)
                    if j < keep:
                        w.kept[j] = (x, y)
            w.calls += 1

        w.t0 = time.perf_counter()
        deadline = None if seconds is None else w.t0 + seconds
        while True:
            if len(pending) == self.inflight:
                retire()
            if (time.perf_counter() >= deadline if deadline is not None
                    else n >= calls):
                break
            x = self.views[self.block]
            self.block = (self.block + 1) % len(self.views)
            ev = self.events[self.submitted % self.inflight]
            if annotate:
                with rf("enqueue"):
                    ts = time.perf_counter()
                    y = self.call(x)
                    th = time.perf_counter()
                    ev.record()
            else:
                ts = time.perf_counter()
                y = self.call(x)
                th = time.perf_counter()
                ev.record()
            w.host_s.append(th - ts)
            pending.append((ev, ts, x, y))
            self.submitted += 1
            n += 1
        while pending:
            retire()
        w.t1 = time.perf_counter()
        return w


class Clocks:
    """``nvidia-smi`` sampling the card's SM clock, power and temperature
    beside a window (a copy of ``savgol_tpu_torch.utils.timing.
    clocks_during``'s sampler). The sampler is stopped and waited for in
    :meth:`stop`; where there is no ``nvidia-smi`` nothing is sampled."""

    FIELDS = ("clocks.sm", "power.draw", "power.limit", "temperature.gpu",
              "clocks_throttle_reasons.active")

    def __init__(self):
        """Starts the sampler and waits (5 s at most) for its first
        sample, so that its start falls in no window."""
        self.first = ""
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "-i", "0",
                 "--query-gpu=" + ",".join(self.FIELDS),
                 "--format=csv,noheader,nounits", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True)
        except OSError:
            self.proc = None
            return
        if select.select([self.proc.stdout], [], [], 5.0)[0]:
            self.first = self.proc.stdout.readline()

    def stop(self) -> dict:
        if self.proc is None:
            return {"samples": 0}
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = [[v.strip() for v in line.split(",")]
                for line in (self.first + out).splitlines()
                if line.count(",") == len(self.FIELDS) - 1]
        rec: dict = {"samples": len(rows)}
        try:
            for i, key in enumerate(("sm_mhz", "power_w", "power_limit_w",
                                     "temp_c")):
                vals = [float(r[i]) for r in rows]
                rec[key] = {"median": statistics.median(vals),
                            "min": min(vals), "max": max(vals)}
            reasons = 0
            for r in rows:
                reasons |= int(r[4], 16)
            rec["throttle"] = hex(reasons)
        except (ValueError, IndexError, statistics.StatisticsError):
            pass
        return rec


def process_start() -> Optional[float]:
    """This process's start on ``CLOCK_BOOTTIME`` (s), from
    ``/proc/self/stat``, or None where it cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def boottime() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    return statistics.quantiles(values, n=100, method="inclusive")[
        round(q) - 1] if len(values) > 1 else values[0]


def read_layers(cell: Cell, events: list, window: Window) -> dict:
    """The per-layer metrics of a traced window: each reader's reading
    with its ``UNIT``, leaving out the readers that find nothing to
    read."""
    span = trace.spans(events, "traced window")
    ctx = {
        "function": cell.config["function"],
        "bound_s": roofline.bound_s(*cell.reference.bound(cell.config,
                                                          cell.call_shape)),
        "events": events,
        "calls": trace.spans(events, "enqueue"),
        "window": span[0] if span else None,
        "entry_host_s": window.host_s,
    }
    out = {}
    for name, mod in layout.layer_metrics().items():
        v = mod.read(ctx)
        if v is not None:
            out[name] = {"value": v, "unit": mod.UNIT}
    return out


def breakdown(events: list) -> tuple[dict, dict]:
    """(the ``breakdown`` of the result line, a summary for an earlier
    line): the device operations that took most time, by name, and the
    longest idle gaps, each by the host span open where it began."""
    (t0, t1), = trace.spans(events, "traced window")
    ops = trace.launched_in(events, [(t0, t1)])[0]
    by_name: dict = collections.defaultdict(float)
    for e in ops:
        by_name[e["name"]] += e["dur"] * 1e-6
    gaps = trace.idle_gaps(ops, t0, t1, {"enqueue": trace.spans(events,
                                                                "enqueue"),
                                         "wait": trace.spans(events, "wait")})
    totals: dict = collections.defaultdict(lambda: [0, 0.0])
    for label, us in gaps:
        totals[label][0] += 1
        totals[label][1] += us * 1e-6
    busy = sum(b - a for a, b in trace.busy_intervals(ops, t0, t1)) * 1e-6
    out = {"device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
           "idle_gaps": [[label, us * 1e-6] for label, us in
                         sorted(gaps, key=lambda g: -g[1])[:10]]}
    summary = {"window_s": (t1 - t0) * 1e-6, "busy_s": busy,
               "device_ops": len(ops),
               "idle_by_span": {k: {"gaps": v[0], "seconds": v[1]}
                                for k, v in totals.items()}}
    return out, summary


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, *, call: Optional[Callable] = None,
        started: Optional[float] = None, stamps: Optional[dict] = None,
        emit: Callable = print) -> dict:
    """One run; returns the result line's object. ``call`` replaces the
    program's entry (the control, or a fault in the tests). ``started``:
    the process's start on ``CLOCK_BOOTTIME``, from which ``setup_s``
    runs; ``stamps``: the moments (``CLOCK_BOOTTIME``) of the set-up's
    steps before this call, printed beside the others; ``emit`` prints the
    earlier lines."""
    wl, cfg, ref = cell.workload, cell.config, cell.reference
    cuda = device.type == "cuda"
    t_start = boottime() if started is None else started
    phases = {k: t - t_start for k, t in (stamps or {}).items()}
    phases["run_entered"] = boottime() - t_start
    program = None
    if call is None:
        program = cell.entry.make(cfg, device)
        entry_call = cell.entry.call

        def call(x):
            return entry_call(program, x)

    phases["program_made"] = boottime() - t_start
    data = ref.make_data(tuple(wl["resident"]), cfg, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    phases["data_made"] = boottime() - t_start
    k = wl["per_call"]
    views = [data[b * k:(b + 1) * k] for b in range(data.shape[0] // k)]
    loop = Loop(call, views, wl["inflight"], device,
                first_block=seed % len(views))
    loop.run(calls=wl["warmup_calls"])
    setup_s = boottime() - t_start
    clocks = Clocks() if cuda else None     # between set-up and window
    rng = random.Random(seed)
    w = loop.run(seconds=seconds, keep=CHECK_CALLS, rng=rng)
    clock_rec = clocks.stop() if clocks is not None else {"samples": 0}
    emit_window = {
        "window": {"calls": w.calls, "seconds": w.seconds,
                   "latency_ms": {"n": len(w.latency_s),
                                  "p50": percentile(w.latency_s, 50) * 1e3,
                                  "p95": percentile(w.latency_s, 95) * 1e3},
                   "entry_host_ms_p50": percentile(w.host_s, 50) * 1e3},
        "setup_s_at": {**phases, "warmed_up": setup_s},
        "clocks": clock_rec}
    emit(emit_window)

    dev: dict = {"platform": "gpu" if cuda else device.type,
                 "kind": torch.cuda.get_device_name(device) if cuda
                 else "cpu",
                 "count": 1}
    result: dict = {}
    if traced:
        def traced_window():
            with torch.profiler.record_function("traced window"):
                return loop.run(seconds=TRACE_SECONDS, annotate=True)
        events, takes = trace.take(traced_window)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if traced:
        metrics = read_layers(cell, events, w)
        out, summary = breakdown(events)
        emit({"trace": {**summary, "takes": takes}})
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = out
    else:
        metrics = {
            "throughput": {"value": w.calls * cell.elements_per_call
                           / w.seconds / 1e9, "unit": "Gelem/s"},
            "latency_p95_ms": {"value": percentile(w.latency_s, 95) * 1e3,
                               "unit": "ms"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    dev["memory_peak_bytes"] = peak

    # the check: the program freed, the reference in blocks
    kept, attempted = w.kept, w.calls
    del program, call, loop, w
    if cuda:
        torch.cuda.synchronize(device)
    t_check = time.perf_counter()
    check, failed, extra = judge(cell, kept)
    extra["check_s"] = time.perf_counter() - t_check
    for name, c in check.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return {"correct": failed == 0 and len(kept) > 0,
            "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": dev, **result, "compared": extra, "check": check}


def judge(cell: Cell, kept: list) -> tuple[dict, int, dict]:
    """Each kept call against the reference: ``(check, failed, extra)``,
    ``check`` each compared number's largest reading over the calls beside
    its limit, ``failed`` the calls with a number past its limit, ``extra``
    the reference's other counts summed."""
    limits = cell.config["limits"]
    worst = {name: 0.0 for name in limits}
    extra: dict = collections.defaultdict(int)
    failed = 0
    for pair in kept:
        numbers = cell.reference.compare([pair], cell.config)
        bad = False
        for name, lim in limits.items():
            v = numbers.get(name, math.inf)
            worst[name] = max(worst[name], v)
            bad |= not v <= lim
        failed += bad
        for k, v in numbers.items():
            if k not in limits:
                extra[k] += v
    extra["calls_compared"] = len(kept)
    # JSON has no infinity: a number that is not finite is given as null
    check = {name: {"value": worst[name] if math.isfinite(worst[name])
                    else None, "limit": lim}
             for name, lim in limits.items()}
    return check, failed, dict(extra)
