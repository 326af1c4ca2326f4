"""The least time one NVIDIA H100 could take for a call's function.

Copied from ``savgol_tpu_torch.utils.roofline`` (its ``bound`` and its
1D and separable-2D counts), so that the program cannot move the
yardstick. The rates are NVIDIA's data sheet for the H100 SXM at its 700 W
limit (not measured): 3.35 TB/s of HBM, 67 TFLOP/s in f32 on the CUDA
cores. A bound counts each input byte read once and each output byte
written once, and the fewest operations an exact implementation of the
function needs (an FMA counted as two), whatever a kernel does: so the
same call reads the same bound whichever kernels run it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(hbm_bytes: float, f32_flops: float) -> float:
    """The larger of the bytes' time and the operations' time."""
    return max(hbm_bytes / HBM_BYTES_PER_S, f32_flops / F32_FLOPS_PER_S)


def sg1d(rows: int, samples: int, taps: int, item_bytes: int = 4
         ) -> tuple[float, float]:
    """``(bytes, operations)`` of a same-length 1D apply of ``rows`` x
    ``samples`` with ``taps`` taps: one input and one output of
    ``item_bytes`` a sample, an FMA a tap a sample."""
    elements = rows * samples
    return 2 * item_bytes * elements, 2 * taps * elements


def sg2d(pixels: int, height: int, width: int, rank: int,
         item_bytes: int = 4) -> tuple[float, float]:
    """``(bytes, operations)`` of a same-shape 2D apply over ``pixels``
    output pixels of a ``height`` x ``width`` stencil of separable rank
    ``rank``: one input and one output of ``item_bytes`` a pixel, a
    column and a row pass a rank term, 2 rank (height + width) operations
    a pixel. The rank is the stencil's own, which the reference works out
    (``references/sg2d.py::rank``), not the taps a dense kernel runs."""
    return 2 * item_bytes * pixels, 2 * rank * (height + width) * pixels
