"""Device timing with CUDA events (counterpart of
``savgol_tpu.utils.profiling.benchmark``).

PyTorch returns before the card finishes, so a host clock measures the
enqueue. :func:`cuda_time_ms` records an event pair around each call and
reports the median of the device-side intervals. Before each timed call it
overwrites a buffer larger than the H100's 50 MB L2 cache, so every call
finds its input in device memory, as a caller streaming fresh data would.
:func:`host_ms` times the host instead: how long a call takes to enqueue
its work, which bounds a call whose device work is shorter.
"""


from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

__all__ = ["cuda_time_ms", "host_ms"]

_FLUSH_BYTES = 256 << 20


def cuda_time_ms(fn: Callable[[], object], *, warmup: int = 3,
                 reps: int = 10) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` calls after
    ``warmup`` untimed ones. Needs a card; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    flush = torch.empty(_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
