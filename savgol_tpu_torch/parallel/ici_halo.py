"""Ring halo exchange by one-sided stores into the neighbours' memory
(counterpart of ``savgol_tpu.parallel.ici_halo``).

The default route of :mod:`savgol_tpu_torch.parallel.sharded` exchanges the
overlap-save halos with ``torch.distributed`` point-to-point sends
(``halo="ppermute"``). This module is the hand-rolled route
(``halo="rdma"``): kernel K13 (``csrc/halo_ring.cu``, wrapper
``ops/cuda_halo.py``), one launch a rank that stores its blocks into its
neighbours' receive slots through CUDA IPC mappings and waits for theirs.
It runs wherever the ranks' CUDA tensors can see each other's memory: one
card a rank on one host, or several ranks sharing one card, where NCCL
cannot run at all. CPU tensors take the kernel's plain version, the same
point-to-point sends.

Call these on each rank's own block, under an initialised process group;
``group`` is the ring (a mesh axis' group). Both are differentiable: the
backward is the same exchange with the directions swapped, as the JAX
package's custom VJPs are, and a ring of one is the identity, with no
launch.
"""

from __future__ import annotations

import torch

from savgol_tpu_torch.ops.cuda_halo import halo_exchange_cuda

__all__ = ["halo_exchange_rdma", "halo_exchange_rdma_rows"]


class _RowHalo(torch.autograd.Function):
    """``(top, bottom)``: the upper ring neighbour's last ``ny`` rows
    (axis -2) and the lower one's first ``ny``, through ``exchange(tail,
    head, group)``. A row block of a contiguous ``(..., R, C)`` tensor is
    one ``(-1, C)`` block per send, so each direction is one message."""

    @staticmethod
    def forward(ctx, x, ny: int, group, exchange):
        ctx.ny, ctx.group, ctx.exchange = ny, group, exchange
        ctx.shape = x.shape
        C = x.shape[-1]
        tail = x[..., -ny:, :].reshape(-1, C)
        head = x[..., :ny, :].reshape(-1, C)
        top, bot = exchange(tail, head, group)
        hshape = x.shape[:-2] + (ny, C)
        return top.reshape(hshape), bot.reshape(hshape)

    @staticmethod
    def backward(ctx, g_top, g_bot):
        ny, (R, C) = ctx.ny, ctx.shape[-2:]
        gt, gb = g_top.reshape(-1, C), g_bot.reshape(-1, C)
        # The forward sent my tail rows down and my head rows up, so my
        # top-halo cotangent returns to my upper neighbour's tail and my
        # bottom-halo cotangent to my lower neighbour's head: the same
        # exchange fed (tail=g_bot, head=g_top) delivers my head rows'
        # gradient first and my tail rows' second.
        g_head, g_tail = ctx.exchange(gb, gt, ctx.group)
        nlead = gt.shape[0] // ny
        gx = g_top.new_zeros((nlead, R, C))
        gx[:, :ny] += g_head.reshape(nlead, ny, C)
        gx[:, -ny:] += g_tail.reshape(nlead, ny, C)
        return gx.reshape(ctx.shape), None, None, None


def exchange_rows(x: torch.Tensor, ny: int, group, exchange):
    """``(top, bottom)`` halo rows of ``x`` (..., R, C) over ``exchange``."""
    return _RowHalo.apply(x, int(ny), group, exchange)


def exchange_last(x: torch.Tensor, n: int, group, exchange):
    """``(left, right)`` halos of the last axis of ``x`` (..., N), each
    (..., n), over ``exchange``: the row exchange of ``x[..., None]``, whose
    (rows * n, 1) blocks hold the same bytes as (rows, n)."""
    top, bot = _RowHalo.apply(x.unsqueeze(-1), int(n), group, exchange)
    return top.squeeze(-1), bot.squeeze(-1)


def halo_exchange_rdma(x_local: torch.Tensor, n: int, group):
    """``(left_halo, right_halo)``, each (..., n): the left ring
    neighbour's ``n`` trailing samples and the right one's ``n`` leading
    samples, with wrap-around, on kernel K13 for CUDA tensors. Same
    contract as ``sharded._halo_exchange``."""
    return exchange_last(x_local, n, group, halo_exchange_cuda)


def halo_exchange_rdma_rows(x_local: torch.Tensor, ny: int, group):
    """``(top_halo, bottom_halo)``, each (..., ny, C): the upper ring
    neighbour's last ``ny`` rows and the lower one's first ``ny``, on
    kernel K13 for CUDA tensors. Same contract as
    ``sharded2d._halo_rows``."""
    return exchange_rows(x_local, ny, group, halo_exchange_cuda)
