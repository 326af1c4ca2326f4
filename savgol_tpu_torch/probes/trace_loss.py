"""How often a ``utils.profiling.trace`` session loses the card's activity,
and how far the trace places the card's operations from the host calls
that launched them.

Traces the four calls that ``chip_smoke.py`` phase 39 reads idle shares
from (one headline ``Savgol1D.apply``, (128, 1,048,576) f32, and 20 back to
back; one 65,536-sample stream chunk and 20), each call ``--sessions``
times, a session each, after a first untraced call. In ``take`` mode a
session is one take of ``profiling.trace``; in ``retake`` mode it goes
through ``profiling.trace_events`` (up to three takes). Prints one JSON
line a call and mode: the sessions that held no device operation at all
(``empty``), the takes (``takes``: count of sessions by takes needed), the
kernels launched in the traced window (``kernels``: count of sessions by
that number, matched by launch as ``profiling.device_events(ev, window)``
does), the sessions in which the kernels that start inside the window are
not those launched in it (``by_start_differs``), and the least gap in us
from a launch to its operation's start over all sessions (``lag_min_us``,
negative where the trace puts an operation before its launch)::

    python -m savgol_tpu_torch.probes.trace_loss [--sessions 25]
"""

from __future__ import annotations

import argparse
import collections
import json
import tempfile

import torch

from savgol_tpu_torch._build import BUILD_DIR
from savgol_tpu_torch.utils import profiling


def _session(call, reps: int, retake: bool) -> tuple[list, int]:
    def run():
        call()
        torch.cuda.synchronize()
        with torch.profiler.record_function("traced call"):
            for _ in range(reps):
                call()
            torch.cuda.synchronize()

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as log:
        return profiling.trace_events(run, log, attempts=3 if retake else 1)


def read(events: list) -> dict:
    """One session's figures: whether it held any device operation, the
    kernels launched in the traced window, whether the kernels that start
    in the window differ from them, and the launch-to-start gaps (us)."""
    call = next(e for e in events if e.get("name") == "traced call"
                and e.get("cat") == "user_annotation")
    t0, t1 = call["ts"], call["ts"] + call["dur"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("ph") == "X"
                and e.get("cat") in profiling.LAUNCH_CATEGORIES
                and "correlation" in e.get("args", {})}
    ops = profiling.device_events(events, (t0, t1))
    by_launch = [e["name"] for e in ops if e["cat"] == "kernel"]
    by_start = [e["name"] for e in profiling.device_events(events)
                if e["cat"] == "kernel" and t0 <= e["ts"] < t1]
    return {"any": bool(profiling.device_events(events)),
            "kernels": len(by_launch), "differs": by_start != by_launch,
            "lags": [e["ts"] - launches[e["args"]["correlation"]]
                     for e in ops]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe traces the card: no CUDA device")
    import savgol_tpu_torch as sgt
    from savgol_tpu_torch import stream as ts

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(128, 1 << 20, generator=g, device=dev)
    f = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4), device=dev)
    st = ts.chunk_init(12, device=dev)
    chunk = torch.randn(65_536, generator=g, device=dev)
    calls = {"apply": lambda: f.apply(x),
             "chunk": lambda: ts.stream_process_chunk(
                 st, chunk, f.center_weights, f.edge_weights, f.dt_inv)}
    print(torch.cuda.get_device_name(0))
    for mode in ("take", "retake"):
        for (name, call) in calls.items():
            for reps in (1, 20):
                empty, differs, lags = 0, 0, []
                takes, kernels = collections.Counter(), collections.Counter()
                for _ in range(args.sessions):
                    events, n = _session(call, reps, mode == "retake")
                    r = read(events)
                    takes[n] += 1
                    kernels[r["kernels"]] += 1
                    empty += not r["any"]
                    differs += r["differs"]
                    lags += r["lags"]
                print(json.dumps({
                    "mode": mode, "call": name, "reps": reps,
                    "sessions": args.sessions, "empty": empty,
                    "takes": dict(takes), "kernels": dict(kernels),
                    "by_start_differs": differs,
                    "lag_min_us": min(lags) if lags else None}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
