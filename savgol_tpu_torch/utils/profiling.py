"""Profiling and timing utilities (counterpart of
``savgol_tpu.utils.profiling``).

:func:`trace` records a ``torch.profiler`` trace, the card's kernels
included where there is one. :func:`benchmark` times calls on the host
clock and waits for the card. :func:`benchmark_chained` times the chained
k-difference: chains of k and 2k calls, each feeding the next, so the
difference cancels what a chain pays once. For a kernel's device time, use
:func:`savgol_tpu_torch.utils.timing.device_ms`.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable

import torch

__all__ = ["trace", "benchmark", "benchmark_chained", "RATIO_BAND"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Record CPU activity, and CUDA activity where a card is present,
    while the block runs; on exit write the Chrome trace to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto). Yields the
    ``torch.profiler.profile``, for ``key_averages()``::

        with profiling.trace("build/sg_trace"):
            f.apply(x)
            torch.cuda.synchronize()
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _wait(out) -> None:
    """Wait for the card where ``out`` (a tensor, or a tuple or list of
    them, as ``stream_process_chunk`` returns) lies on one."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _wait(o)


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 3):
    """Wall-time ``fn(*args)`` after ``warmup`` calls (the kernels' build
    and first launches), waiting for the card at the end.

    Returns (seconds_per_call, last_output).
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait(out)
    return (time.perf_counter() - t0) / iters, out


# t(2k)/t(k) must sit near 2 for the k-difference to mean anything. Lower
# bound 1.4, not ~1.6: a genuine per-chain fixed cost F lowers the ratio to
# (F + 2ks)/(F + ks) < 2 while the k-difference still cancels F exactly; at
# ratio 1.4 the difference amplifies timing noise ~5x (acceptable at
# iters >= 5); ratios near 1.0 mean the chain's steps did not run as steps
# and the difference is garbage.
RATIO_BAND = (1.4, 2.7)


def benchmark_chained(fn: Callable, x, *rest, iters: int = 5, k: int = 4,
                      feedback: Callable | None = None,
                      feedback_scale: float = 1e-3,
                      return_info: bool = False):
    """Per-step seconds of ``fn`` by the chained k-difference.

    A chain of ``kk`` steps calls ``fn(v, *rest)`` and feeds its output
    back in (``feedback(y, template)``, by default ``y`` times
    ``feedback_scale`` in the template's dtype), so no two calls see the
    same input. The chains of k and 2k steps run eagerly (PyTorch has no
    ``lax.scan``), each ``iters`` times after one untimed run, waiting for
    the card after the last; the result is ``(t(2k) - t(k)) / k``, which
    cancels what a chain pays once. Each step still pays its host work and
    the feedback's own operations; pass ``feedback=lambda y, t: y`` where
    ``fn``'s output can be its next input as it is.

    ``fn(x, *rest)`` must map ``x`` to a same-shaped tensor under the
    default feedback; pass ``feedback(y, template) -> next_input`` for
    geometry-changing bodies (e.g. re-pad a VALID output).

    The k-scaling ratio is checked against ``RATIO_BAND`` and a warning
    line is printed to stderr when it fails. ``return_info=True`` returns
    ``(per_step, ratio, chain_k)``, ``chain_k`` the k-step chain as a
    callable of the input, instead of just ``per_step``.
    """
    if feedback is None:
        def feedback(y, template):
            return (y * feedback_scale).to(template.dtype)

    def chain(kk):
        def run(v):
            template = v
            for _ in range(kk):
                v = feedback(fn(v, *rest), template)
            return v
        return run

    times = {}
    for kk in (k, 2 * k):
        run = chain(kk)
        out = run(x)
        _wait(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = run(out)
        _wait(out)
        times[kk] = (time.perf_counter() - t0) / iters

    per_step = (times[2 * k] - times[k]) / k
    ratio = times[2 * k] / max(times[k], 1e-12)
    if not RATIO_BAND[0] <= ratio <= RATIO_BAND[1]:
        print(f"  !! k-scaling suspect: t({2 * k})/t({k}) = {ratio:.2f}",
              file=sys.stderr)
    if return_info:
        return per_step, ratio, chain(k)
    return per_step
