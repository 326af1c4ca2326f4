"""savgol_tpu_torch — the PyTorch / CUDA port of ``savgol_tpu`` for one
NVIDIA H100.

It imports ``torch`` and numpy, never JAX. The batched 1D path is ported:
host-f64 weights, the same-length POLYNOMIAL apply (CUDA kernel K1) and the
VALID correlation (CUDA kernel K3), and the :class:`Savgol1D` module. So is
the 2D path: host-f64 2D stencils, :class:`Savgol2D`, ``savgol2d_apply``,
the stacked gradient / Hessian and the Laplacian, on a dense (K2D-dense) and
a separable (K2D-sep) 2D correlation kernel. So is the masked
(missing-data) path: ``savgol_apply_masked`` (1D, normal and double-word
"qr" solvers) and ``savgol2d_apply_masked``, on the plane-Cholesky solve
kernels (K8a, K8b) and the fused masked kernels (K9 in 1D, K10 in 2D). So
is the irregular-sampling path: ``savgol_apply_nonuniform`` (filtering at
arbitrary sample positions) and ``savgol_resample`` (evaluation at arbitrary
query positions), on the fused double-word nonuniform fit kernel (K11, with
its plane-stack mode) and the resample gather-evaluate kernel (K12). So are
the padded-boundary and filter-bank 1D paths: the REFLECT / PERIODIC /
CONSTANT apply on the fused-pad kernel K2, :class:`SavgolBank` and the
(n, m) sweep (``savgol_tpu_torch.ops.sweep``) on the K-stencil bank kernel
K4, and the scipy drop-in ``savgol_tpu_torch.scipy_compat``, whose
``savgol_filter`` and ``savgol_coeffs`` the package also exports. So is the
multi-rank overlap-save path, ``savgol_tpu_torch.parallel`` on
``torch.distributed``: ``apply_sharded``, ``apply2d_sharded`` and the
masked / nonuniform ``*_apply_sharded``, SPMD over a mesh of ranks, their
halos sent point to point or, with ``halo="rdma"``, stored into the
neighbours' memory by the ring halo-exchange kernel K13. ``method="bf16"``,
the throughput mode, runs K1, K2, K3 and K2D-dense in their bf16 mode
(bf16 operands, f32 sums) on every 1D and 2D entry point that takes a
``method``; ``savgol_tpu_torch.probes`` holds the kernels that attribute
its time, and P1, the double-buffered VALID correlation. So is streaming:
:class:`SavgolStream` and the functional ``stream_*`` core, whose chunked
step and whole-sequence apply run the VALID correlation kernel K3. The
kernels are built with ``nvcc`` at their first call on a
CUDA tensor; CPU tensors take their plain PyTorch versions.

Beside them: the weight generators on the device, ``savgol_weights`` and
``savgol2d_weights`` (and ``Savgol1D.create_on_device``); the coefficient
exporter, ``savgol_tpu_torch.utils.export.generate_header`` and its
command line, ``python -m savgol_tpu_torch.cli``; the ctypes loader of the
host C++ engine in ``native/``, ``savgol_tpu_torch.native``, an
independent oracle; the card's cost model, ``savgol_tpu_torch.utils.
roofline`` (the one home of the kernels' bounds); and
``savgol_tpu_torch.utils.profiling`` (``torch.profiler`` traces and
timers).

Quick start::

    import torch
    import savgol_tpu_torch as sgt

    f = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4), device="cuda")
    y = f.apply(x)                          # x: (..., N) tensor on the card
    f2 = sgt.Savgol2D.create(sgt.Savgol2DConfig(5, 5, 3), device="cuda")
    img = f2.apply(images)                  # images: (..., R, C)
    y = sgt.savgol_apply_nonuniform(x, t, half_window=12, poly_order=4)
    sm, vel, acc = sgt.SavgolBank.smooth_and_derivatives(
        12, 4, 2, device="cuda").apply(x)
    s = sgt.SavgolStream(sgt.SavgolConfig(6, 3), device="cuda")
    y = s.push_full(0.5)                    # emissions so far, on the card
    for out in s.process_chunked(chunks):   # one K3 launch a chunk
        ...

    # on each rank of an initialised process group, on its own block:
    from savgol_tpu_torch import parallel
    mesh = parallel.make_mesh(("batch", "seq"))
    y = parallel.apply_sharded(x_block, f.center_weights, f.edge_weights,
                               half_window=12, mesh=mesh, halo="rdma")
"""

from savgol_tpu_torch.config import (
    Boundary2D,
    BoundaryMode,
    MAX_DERIVATIVE,
    MAX_HALF_WINDOW,
    MAX_POLY_ORDER,
    Savgol2DConfig,
    SavgolConfig,
    deriv1,
    deriv2,
    num_terms_2d,
    smooth,
)
from savgol_tpu_torch.models import (Savgol1D, Savgol2D, SavgolBank,
                                     SavgolStream)
from savgol_tpu_torch.ops.apply import savgol_apply, savgol_apply_valid
from savgol_tpu_torch.ops.masked import (savgol2d_apply_masked,
                                         savgol_apply_masked)
from savgol_tpu_torch.ops.nonuniform import (savgol_apply_nonuniform,
                                             savgol_resample)
from savgol_tpu_torch.ops.apply2d import (
    savgol2d_apply,
    savgol2d_apply_stack,
    savgol2d_gradient,
    savgol2d_hessian,
    savgol2d_laplacian,
)
from savgol_tpu_torch.scipy_compat import savgol_coeffs, savgol_filter
from savgol_tpu_torch.stream import (
    ChunkState,
    StreamState,
    chunk_init,
    stream_apply,
    stream_flush,
    stream_flush_chunked,
    stream_flush_leading,
    stream_init,
    stream_process_chunk,
    stream_push,
    stream_push_full,
    stream_reset,
)
from savgol_tpu_torch.ops.weights import (monomial_index,
                                          savgol2d_weights,
                                          savgol2d_weights_np,
                                          savgol_all_weights_np,
                                          savgol_weights,
                                          savgol_weights_np)

__version__ = "0.6.0"

__all__ = [
    "BoundaryMode", "Boundary2D", "SavgolConfig", "Savgol2DConfig",
    "MAX_HALF_WINDOW", "MAX_POLY_ORDER", "MAX_DERIVATIVE",
    "smooth", "deriv1", "deriv2", "num_terms_2d",
    "Savgol1D", "Savgol2D", "SavgolBank", "SavgolStream",
    "savgol_weights", "savgol_weights_np", "savgol_all_weights_np",
    "savgol2d_weights", "savgol2d_weights_np", "monomial_index",
    "savgol_apply", "savgol_apply_valid",
    "savgol2d_apply", "savgol2d_apply_stack", "savgol2d_gradient",
    "savgol2d_hessian", "savgol2d_laplacian",
    "savgol_apply_masked", "savgol2d_apply_masked",
    "savgol_apply_nonuniform", "savgol_resample",
    "savgol_filter", "savgol_coeffs",
    "StreamState", "stream_init", "stream_reset", "stream_push",
    "stream_push_full", "stream_flush", "stream_flush_leading",
    "stream_apply", "ChunkState", "chunk_init", "stream_process_chunk",
    "stream_flush_chunked",
]
