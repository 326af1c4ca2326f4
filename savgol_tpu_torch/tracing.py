"""The port's spans: ``torch.profiler`` annotations at the four places
where a call spends its host time, recorded only while a profiler session
is recording.

A span is a ``torch.profiler.record_function`` range. The profiler keeps it
in memory and writes it with the session's trace, on the same clock as the
card's activity in that trace, so a reader can line up what the host was
doing with what the card ran. A span's parent is the enclosing span on the
same thread.

There is no switch: a span is recorded exactly when a ``torch.profiler``
session with CPU activity is recording. With none, a site costs one check
of the profiler's state (:func:`on`): no ``record_function`` is made, and
no ``with`` statement is entered (a Python context manager's own
``__enter__`` / ``__exit__`` would cost ~0.3 us, several times the check).
So a site opens and closes its span in this form::

    span = tracing.begin("savgol.launch") if tracing.on() else None
    try:
        ...
    finally:
        tracing.end(span)

``SPANS`` names every span of the port, outermost first:

- ``savgol.apply``: the body of a public entry point (``savgol_apply``,
  ``savgol_apply_valid``, ``savgol2d_apply``, ``savgol2d_apply_stack``,
  ``scipy_compat.savgol_filter``; ``Savgol1D.apply`` and
  ``Savgol2D.apply`` go through them). A call is its outermost
  ``savgol.apply``: the complex-input route nests a second.
- ``savgol.taps``: a call's preparation of its taps on the host side:
  dtype cast, the ``dt_inv`` or scale fold, ``.contiguous()``; in
  ``scipy_compat``, the lookup of its held device weights, which a miss
  builds on the host and uploads (counted in ``scipy_compat.WEIGHTS``);
  under ``method="bf16"``, the rounding of each tap tensor to bf16
  (``ops.cuda_conv.bf16_taps``, two casts a tensor, counted in
  ``ops.cuda_conv.ROUNDED["taps"]``). An f64 caller's samples rounded to
  bf16 storage before it lie in ``savgol.apply`` alone and count in
  ``ROUNDED["storage"]``.
- ``savgol.pad``: a pad made outside any kernel, whose device operations
  the card runs before the kernel (``ops.cuda_conv.pad_last``: the
  ``scipy_compat`` mode ``constant`` and ``mirror`` under
  ``method="bf16"``, and every padded plain version), which counts one pad
  in ``ops.cuda_conv.PADS``. A pad that K2 maps while it stages is no
  span; it counts in ``ops.cuda_conv.MAPPED``.
- ``savgol.launch``: the call into the kernel library that enqueues one
  kernel (library lookup, device guard, stream query, the foreign call),
  which counts one launch in its module's ``LAUNCHES``
  (``ops.cuda_conv._enqueue``).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["SPANS", "on", "begin", "end"]

SPANS = ("savgol.apply", "savgol.taps", "savgol.pad", "savgol.launch")

# Whether a profiler session is recording on this thread or process-wide:
# a C function, the cheapest check there is.
on = torch._C._autograd._profiler_enabled


def begin(name: str) -> torch.profiler.record_function:
    """Open the span ``name`` and return it, for :func:`end`. Call only
    where :func:`on` is true."""
    span = torch.profiler.record_function(name)
    span.__enter__()
    return span


def end(span: Optional[torch.profiler.record_function]) -> None:
    """Close a span from :func:`begin`; None (no session was recording)
    does nothing."""
    if span is not None:
        span.__exit__(None, None, None)
