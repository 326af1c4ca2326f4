"""Multi-rank Savitzky-Golay: overlap-save sharding with halo exchange
(counterpart of ``savgol_tpu.parallel.sharded``).

JAX runs one process that sees every device and ``shard_map`` cuts a global
array. PyTorch runs one process a rank, so these functions are SPMD: every
rank calls them on its own block of the global array, under an initialised
process group, with a mesh from :func:`make_mesh`. :func:`shard` cuts a
global tensor into a rank's block by its mesh coordinates and :func:`gather`
puts blocks back together; the checks that need the global shape ("must
divide evenly over S shards") live there.

  * **Data parallel** over a batch axis: a rank already holds its batch
    block, so nothing crosses that axis.
  * **Sequence parallel** over the sample axis: the filter is a local
    stencil of radius ``half_window``, so a rank only needs ``n`` halo
    samples from each neighbour of its ring (the sub-group of the mesh's
    sequence axis). Two sends, then purely local compute.

Boundary handling composes with the ring exchange as in the JAX package:
PERIODIC rides the ring; REFLECT / CONSTANT: the first / last ranks replace
their outer halo with local virtual samples; POLYNOMIAL: they refit their
first / last ``n`` outputs with the edge weights on their local window.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from savgol_tpu_torch.config import BoundaryMode
from savgol_tpu_torch.ops.apply import (_correlate, _ensure_float, _scale_of,
                                        _use_kernel)
from savgol_tpu_torch.ops.cuda_conv import _edge_sums, scalar_like
from savgol_tpu_torch.ops.cuda_halo import halo_exchange_plain
from savgol_tpu_torch.parallel.ici_halo import (exchange_last,
                                                halo_exchange_rdma)

__all__ = ["apply_sharded", "make_mesh", "shard", "gather"]

_HALOS = ("ppermute", "rdma")


def make_mesh(axis_names=("batch", "seq"), shape=None, device_type=None):
    """A ``DeviceMesh`` over every rank of the initialised process group.

    The default shape puts all ranks on the LAST axis (sequence sharding);
    pass ``shape`` to split, e.g. ``(2, 4)`` for 2-way batch x 4-way
    sequence on 8 ranks. ``device_type`` defaults to ``"cuda"`` where a
    card is present, else ``"cpu"``. Collective: every rank calls it.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call torch.distributed.init_process_group first")
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (dist.get_world_size(),)
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh builds a mesh of cards by default, and "
                "torch.cuda.is_available() is False: pass device_type=\"cpu\" "
                "for a mesh of CPU ranks")
        device_type = "cuda"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def mesh_axis(mesh, name: str):
    """(ring group, this rank's coordinate, ring size) of mesh axis
    ``name``; the coordinate takes the place of ``lax.axis_index``."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"{name!r} is not a mesh dimension of {names}")
    return (mesh.get_group(name), mesh.get_local_rank(name),
            mesh.size(names.index(name)))


def _spec_dims(spec: Sequence[Optional[str]], ndim: int):
    if len(spec) > ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than the "
                         f"tensor's {ndim} axes")
    return [(d, a) for d, a in enumerate(spec) if a is not None]


def shard(x: torch.Tensor, mesh, spec: Sequence[Optional[str]]):
    """This rank's block of the global tensor ``x``: axis ``d`` is cut over
    mesh axis ``spec[d]`` (a name, or None to keep it whole; a short spec
    keeps the trailing axes whole), by the rank's coordinates. Raises where
    an axis does not divide evenly."""
    for d, name in _spec_dims(spec, x.dim()):
        _, idx, size = mesh_axis(mesh, name)
        if x.shape[d] % size != 0:
            raise ValueError(f"axis {d} ({x.shape[d]}) must divide evenly "
                             f"over {size} shards of mesh axis {name!r}")
        step = x.shape[d] // size
        x = x.narrow(d, idx * step, step)
    return x.contiguous()


def gather(local: torch.Tensor, mesh, spec: Sequence[Optional[str]]):
    """The global tensor from every rank's block (the inverse of
    :func:`shard`, blocks of unequal size along a cut axis included), on the
    CPU on every rank. A collective over the whole group, through the host:
    for checks and tests, not for speed."""
    dims = _spec_dims(spec, local.dim())
    key = tuple(mesh_axis(mesh, name)[1] for _, name in dims)
    blocks = [None] * dist.get_world_size()
    dist.all_gather_object(blocks, (key, local.detach().cpu()))
    by_key = dict(blocks)     # replicas along uncut axes hold equal blocks

    def build(prefix, k):
        if k == len(dims):
            return by_key[prefix]
        d, name = dims[k]
        size = mesh_axis(mesh, name)[2]
        return torch.cat([build(prefix + (i,), k + 1) for i in range(size)],
                         dim=d)

    return build((), 0)


def _halo_exchange(x_local: torch.Tensor, n: int, group):
    """``(left_halo, right_halo)``, each (..., n): the left ring
    neighbour's ``n`` trailing samples and the right one's ``n`` leading
    samples (wrap-around), by point-to-point sends. Differentiable: the
    backward sends the cotangents back the other way."""
    return exchange_last(x_local, n, group, halo_exchange_plain)


def _local_apply(x_local, center_w, edge_w, n, boundary, dt_inv, lead_sign,
                 ring, kernel: bool, halo: str, bf16: bool):
    """A rank's body: halo exchange, the local VALID correlation (kernel
    K3 for a CUDA tensor, in its bf16 mode for ``bf16``), and the outer
    ranks' edge fixes."""
    group, idx, size = ring
    ws = 2 * n + 1
    nloc = x_local.shape[-1]
    if nloc < ws:
        raise ValueError(
            f"local shard length ({nloc}) must be >= window size ({ws}); "
            "use fewer sequence shards or longer input")
    is_first, is_last = idx == 0, idx == size - 1

    exchange = halo_exchange_rdma if halo == "rdma" else _halo_exchange
    left, right = exchange(x_local, n, group)
    if boundary is not BoundaryMode.PERIODIC:
        # Outer ranks see wrapped (wrong) halos; substitute local virtual
        # samples (REFLECT duplicates the edge sample; CONSTANT clamps;
        # POLYNOMIAL's are replaced below).
        if boundary is BoundaryMode.REFLECT:
            vleft = x_local[..., :n].flip(-1)
            vright = x_local[..., -n:].flip(-1)
        else:
            vleft = x_local[..., :1].expand(left.shape)
            vright = x_local[..., -1:].expand(right.shape)
        left = vleft if is_first else left
        right = vright if is_last else right

    xp = torch.cat([left, x_local, right], dim=-1)
    if bf16:
        # the JAX package's sharded bf16 route: K3 in bf16 on the unscaled
        # taps, the outer edge rows exact in the compute dtype, then
        # * dt_inv (not the single-device route's fused bf16 edge rows)
        dt = _scale_of(dt_inv, x_local)
        y = _correlate(xp, center_w, kernel, bf16=True)
    else:
        # dt_inv folded into the (tiny) taps, as kernel K1 folds it, instead
        # of a pass over the output
        dt = scalar_like(dt_inv, x_local)
        y = _correlate(xp, center_w.to(dt.dtype) * dt, kernel)  # (..., nloc)

    if boundary is BoundaryMode.POLYNOMIAL:
        # the edge rows as products and sums (no matmul, so no TF32),
        # written over the n outputs they replace
        ew = edge_w.to(y.dtype) if bf16 else edge_w.to(dt.dtype) * dt
        if is_first:
            y[..., :n] = _edge_sums(ew, x_local[..., :ws].flip(-1)) \
                * lead_sign
        if is_last:
            y[..., nloc - n:] = _edge_sums(ew,
                                           x_local[..., nloc - ws:]).flip(-1)
    return y * dt.to(y.dtype) if bf16 else y


def apply_sharded(
    x: torch.Tensor,
    center_w: torch.Tensor,
    edge_w: Optional[torch.Tensor] = None,
    *,
    half_window: int,
    mesh,
    boundary: BoundaryMode = BoundaryMode.POLYNOMIAL,
    dt_inv: float | torch.Tensor = 1.0,
    derivative: int = 0,
    reference_edge_sign: bool = False,
    seq_axis: str = "seq",
    batch_axis: Optional[str] = "batch",
    method: str = "auto",
    halo: str = "ppermute",
) -> torch.Tensor:
    """Same-length filter of this rank's block ``x`` ((..., N_local) or
    (N_local,)) of a global (..., N) array whose sample axis is cut over
    ``mesh[seq_axis]`` (and whose leading axis may be cut over
    ``mesh[batch_axis]``, across which nothing is sent).

    Semantics identical to :func:`savgol_tpu_torch.ops.apply.savgol_apply`
    on the global array; communication is two neighbour sends of
    ``half_window`` samples a rank. ``method`` as for the single-device
    call (the local correlation runs kernel K3 for a CUDA tensor; "bf16"
    runs it in its bf16 mode and, as the JAX package's sharded route, fits
    the outer POLYNOMIAL edge rows exactly in the compute dtype and
    multiplies by ``dt_inv`` after). ``halo``
    selects the exchange: ``"ppermute"`` (point-to-point sends on the
    group's backend) or ``"rdma"`` (kernel K13, see
    :mod:`savgol_tpu_torch.parallel.ici_halo`); both give identical
    results. Differentiable in ``x``.
    """
    del batch_axis     # a rank already holds its batch block
    if halo not in _HALOS:
        raise ValueError(f"halo must be 'ppermute' or 'rdma', got {halo!r}")
    if not isinstance(boundary, BoundaryMode):
        boundary = BoundaryMode(boundary)
    n = int(half_window)
    kernel = _use_kernel(method, x)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    lead_sign = 1.0
    if not reference_edge_sign and int(derivative) % 2 == 1:
        lead_sign = -1.0
    y = _local_apply(_ensure_float(x, center_w), center_w, edge_w, n,
                     boundary, dt_inv, lead_sign, mesh_axis(mesh, seq_axis),
                     kernel, halo, method == "bf16")
    return y[0] if squeeze else y
