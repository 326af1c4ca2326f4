"""Device timing with CUDA events (counterpart of
``savgol_tpu.utils.profiling.benchmark``).

PyTorch returns before the card finishes, so a host clock measures the
enqueue. :func:`cuda_time_ms` records an event pair around each call and
reports the median of the intervals. Before each timed call it overwrites
a buffer larger than the H100's 50 MB L2 cache, so every call finds its
input in device memory, as a caller streaming fresh data would. The
interval holds whatever of the call's host work the card waits for: where
a call's host work outlasts the card's, it is what a caller waits for, and
that is how entry points are timed. :func:`device_ms` times a kernel
instead: it also keeps the card busy while the host enqueues the call, so
its interval is the card's time alone.
:func:`clocks_during` reads the card's SM clock and power draw while a
call runs back to back (the data sheet's peaks assume its top clock).
:func:`host_ms` times the host instead: how long a call takes to enqueue
its work, which bounds a call whose device work is shorter.
:func:`cudnn_ms` times a library yardstick under the settings cuDNN can be
run with, and :func:`bound` gives the least time the card could take.
"""


from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

__all__ = ["cuda_time_ms", "device_ms", "host_ms", "cudnn_ms", "bound",
           "clocks_during", "HBM_BPS", "PEAK_FLOPS"]

_FLUSH_BYTES = 256 << 20
# ~1 ms of the card's time at the H100's 1.98 GHz SM clock
_SPIN_CYCLES = 2_000_000

# H100 SXM data sheet: the memory rate, and the dense peak rate of each
# operand type (f32 and f64 outside the tensor cores; bf16 products summed
# in f32 on the tensor cores)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12, "bf16": 989e12}


def _event_ms(fn: Callable[[], object], warmup: int, reps: int,
              spin: int) -> float:
    flush = torch.empty(_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_time_ms(fn: Callable[[], object], *, warmup: int = 3,
                 reps: int = 10) -> float:
    """Median milliseconds between CUDA events around ``fn()`` over
    ``reps`` calls after ``warmup`` untimed ones: the card's time, and the
    part of the host's enqueue it waits for. Needs a card; raises without
    one."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    return _event_ms(fn, warmup, reps, 0)


def device_ms(fn: Callable[[], object], *, warmup: int = 3,
              reps: int = 10) -> float:
    """Median device milliseconds of ``fn()``, as :func:`cuda_time_ms`, but
    with the card kept busy for about a millisecond (``torch.cuda._sleep``)
    before each timed call, so that the host has enqueued the call's
    launches before its start event runs: the interval is the card's time
    for them, not the host's enqueue (a wrapper's host work, ~0.1-0.4 ms,
    outruns the flush alone). For kernels and their yardsticks; an entry
    point is timed by :func:`cuda_time_ms`. Needs a card; raises without
    one."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    return _event_ms(fn, warmup, reps, _SPIN_CYCLES)


def clocks_during(fn: Callable[[], object], seconds: float = 2.0) -> dict:
    """The card's SM clock (MHz), power draw (W) and temperature (C) while
    ``fn()`` runs back to back for about ``seconds``: the medians of
    ``nvidia-smi``'s samples every 100 ms, the first 0.3 s (before the load)
    left out, their count, and the OR of the clock-throttle reasons they
    report (``nvidia-smi -q -d PERFORMANCE`` names the bits: 0x4 the power
    cap, 0x20 / 0x40 thermal slowdown). Needs a card; the sampler is
    stopped before it returns."""
    import subprocess
    if not torch.cuda.is_available():
        raise RuntimeError("clocks_during needs a CUDA device")
    fn()
    torch.cuda.synchronize()
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    rows = [[v.strip() for v in line.split(",")] for line in out.splitlines()
            if line.count(",") == 3]
    rows = rows[3:] or rows
    if not rows:
        return {"samples": 0}
    reasons = 0
    for r in rows:
        try:
            reasons |= int(r[3], 16)
        except ValueError:
            pass
    return {"sm_mhz": statistics.median(float(r[0]) for r in rows),
            "power_w": statistics.median(float(r[1]) for r in rows),
            "temp_c": statistics.median(float(r[2]) for r in rows),
            "throttle": hex(reasons), "samples": len(rows)}


def host_ms(fn: Callable[[], object], *, warmup: int = 10,
            reps: int = 200) -> float:
    """Mean host milliseconds a call of ``fn()`` takes to return, over
    ``reps`` calls enqueued back to back with no synchronisation between
    them. Needs a card; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("host_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def cudnn_ms(call: Callable[[], object],
             call_nhwc: Callable[[], object] | None = None) -> dict:
    """Device milliseconds (:func:`device_ms`) of a cuDNN call at its
    default algorithm pick ("default") and with ``cudnn.benchmark`` on,
    which times cuDNN's algorithms at the first call of a shape and keeps
    the fastest ("benchmark"); ``call_nhwc``, the same call on
    channels_last tensors, with it on too ("benchmark channels_last").
    "best" is the least of them. The setting is restored after."""
    flag = torch.backends.cudnn.benchmark
    t = {"default": device_ms(call)}
    try:
        torch.backends.cudnn.benchmark = True
        t["benchmark"] = device_ms(call)
        if call_nhwc is not None:
            t["benchmark channels_last"] = device_ms(call_nhwc)
    finally:
        torch.backends.cudnn.benchmark = flag
    t["best"] = min(t.values())
    return t


def bound(nbytes: float, flops: float, kind: str = "f32") -> dict:
    """{"bound_ms", "bound_by"}: the least time the card could take for a
    function that moves ``nbytes`` (each input read once, each output
    written once) and does ``flops`` operations of type ``kind`` (an FMA
    counted as two), the larger of the two times."""
    t_b = nbytes / HBM_BPS * 1e3
    t_o = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}
