"""The ring halo-exchange kernel of the port (K13, ``csrc/halo_ring.cu``),
its plain version and its launch count (counterpart of
``savgol_tpu.parallel.ici_halo._halo_call``).

Both take this rank's ``tail`` and ``head`` blocks (same shape and dtype)
and a process group read as a ring, and return ``(left, right)``: the left
neighbour's ``tail`` and the right neighbour's ``head``, with wrap-around.

* The plain version is ``dist.batch_isend_irecv`` of the two blocks, on any
  backend that can send the tensors: ``gloo`` for CPU tensors, NCCL for a
  group with one card a rank. ``gloo`` cannot send a CUDA tensor, and this
  module raises rather than hand it one.
* The kernel takes CUDA tensors. Each rank shares one device buffer (two
  receive slots of each side and two arrival words) with its neighbours
  once, through CUDA IPC handles. ``halo_send`` stores this rank's blocks
  into the neighbours' slots and signals them. A rank that has its card to
  itself then waits for its neighbours on the SMs in the same launch and
  copies its slots out: one launch an exchange (the SM route). A rank that
  shares its card with another rank of the ring (several processes on one
  card, which the card time-slices) leaves the wait to its stream's front
  end, where it holds no SM, and ``halo_recv`` copies the slots out: two
  launches an exchange (the stream route). The ring's ranks tell each
  other their cards when the buffers are shared, and each picks its route.

A ring of one is the identity and launches nothing. A CPU tensor takes the
plain version; a CUDA tensor launches the kernels or raises, and a device
without 64-bit stream memory operations raises when its ring is made.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from savgol_tpu_torch._build import library
from savgol_tpu_torch.ops.cuda_conv import _enqueue, _plain_or_cuda

__all__ = ["LAUNCHES", "TIMEOUT_S", "ROUTE", "reset_launches", "release",
           "halo_exchange_cuda", "halo_exchange_plain"]

# Kernel launches since the last reset_launches(), by kernel. Only the line
# that launches a kernel adds to its count: an exchange launches halo_send,
# and halo_recv on the stream route.
LAUNCHES = {"halo_send": 0, "halo_recv": 0}

# A wait for the neighbours past this fails the exchange: halo_send traps on
# the SM route, the library's watchdog releases the stream's wait and
# halo_recv traps on the stream route (csrc/halo_ring.cu). Ranks that share
# one card wait for each other's time slices, well under it. Read at each
# exchange.
TIMEOUT_S = 10.0

# None: each rank's route as its ring's cards decide (the stream route where
# another rank of the ring shares its card); "sms" or "stream": that route
# for every exchange. Read at each exchange; the routes share one protocol,
# so the ranks of a ring may take different ones.
ROUTE = None

_FLAG_BYTES = 512    # csrc/halo_ring.cu kFlagBytes
_PARITIES = 2        # csrc/halo_ring.cu kParities
_ALIGN = 256
# halo_ring_check's answers other than 0
_UNSUPPORTED = {
    1: "cuStreamBatchMemOp or cuDeviceGetAttribute was not found",
    2: "the device does not support 64-bit stream memory operations "
       "(CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS is 0)",
    3: "cuDeviceGetAttribute could not say whether the device supports "
       "64-bit stream memory operations"}

# (group, device, bytes a side) -> _Ring
_RINGS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _neighbours(group) -> tuple[int, int, int]:
    """(ring size, global rank of the left neighbour, of the right one)."""
    size = dist.get_world_size(group)
    me = dist.get_rank(group)
    return (size, dist.get_global_rank(group, (me - 1) % size),
            dist.get_global_rank(group, (me + 1) % size))


def _check_pair(tail: torch.Tensor, head: torch.Tensor, name: str) -> None:
    if tail.shape != head.shape or tail.dtype != head.dtype \
            or tail.device != head.device:
        raise ValueError(f"{name}: tail {tuple(tail.shape)} {tail.dtype} on "
                         f"{tail.device} and head {tuple(head.shape)} "
                         f"{head.dtype} on {head.device} must match")


def halo_exchange_plain(tail: torch.Tensor, head: torch.Tensor,
                        group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(left, right)`` by point-to-point sends: ``tail`` to the right
    neighbour, ``head`` to the left one (counterpart of the two
    ``lax.ppermute`` sends of ``savgol_tpu.parallel.sharded._halo_exchange``).
    """
    name = "halo_exchange_plain"
    _check_pair(tail, head, name)
    size, left, right = _neighbours(group)
    if size == 1:
        return tail.clone(), head.clone()
    if tail.device.type == "cuda" and dist.get_backend(group) == "gloo":
        raise ValueError(
            f"{name}: a gloo group cannot send CUDA tensors; use a group with "
            "one card a rank (NCCL), or the kernel (halo='rdma')")
    tail, head = tail.contiguous(), head.contiguous()
    left_in, right_in = torch.empty_like(tail), torch.empty_like(head)
    # a ring of two has one neighbour on both sides: the tags keep the
    # two directions apart
    ops = [dist.P2POp(dist.isend, tail, right, group, tag=1),
           dist.P2POp(dist.irecv, left_in, left, group, tag=1),
           dist.P2POp(dist.isend, head, left, group, tag=2),
           dist.P2POp(dist.irecv, right_in, right, group, tag=2)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return left_in, right_in


def _open_peer(handle) -> torch.Tensor:
    rebuild, args = handle
    return rebuild(*args)


class _Ring:
    """One rank's receive buffer of a ring and its neighbours' buffers,
    mapped into this process. Created collectively: every rank of the group
    makes its own at the same call."""

    def __init__(self, group, device: torch.device, nbytes: int):
        from torch.multiprocessing.reductions import reduce_tensor

        size, _, _ = _neighbours(group)
        me = dist.get_rank(group)
        card = str(torch.cuda.get_device_properties(device).uuid)
        lib = library()
        why = _UNSUPPORTED.get(lib.halo_ring_check(device.index))
        if why is not None:
            # no fallback: the stream route waits with stream memory
            # operations
            raise RuntimeError(f"halo_exchange_cuda: {device}: {why}; kernel "
                               "K13 has no other way to wait")
        self.stride = -(-nbytes // _ALIGN) * _ALIGN
        self.blocks = lib.halo_ring_blocks(nbytes)
        self.buf = torch.zeros(_FLAG_BYTES + 2 * _PARITIES * self.stride,
                               dtype=torch.uint8, device=device)
        # the zeroed arrival words must land before a neighbour's first signal
        torch.cuda.synchronize(device)
        shared = [None] * size
        dist.all_gather_object(shared, (reduce_tensor(self.buf), card),
                               group=group)
        peers = {}
        for r in ((me - 1) % size, (me + 1) % size):
            if r not in peers:
                peers[r] = _open_peer(shared[r][0])
        self.left = peers[(me - 1) % size]
        self.right = peers[(me + 1) % size]
        # another rank on this card: the card time-slices our contexts
        self.route = ("stream" if sum(c == card for _, c in shared) > 1
                      else "sms")
        self.epoch = 0
        self.stream = None


def _ring(group, device: torch.device, nbytes: int) -> _Ring:
    key = (group, device, nbytes)
    ring = _RINGS.get(key)
    if ring is None:
        ring = _RINGS[key] = _Ring(group, device, nbytes)
    return ring


def release() -> None:
    """Drop every ring's buffers and the neighbours' mapped ones. Call on
    every rank, then synchronise the group, before a process group ends."""
    _RINGS.clear()


def halo_exchange_cuda(tail: torch.Tensor, head: torch.Tensor,
                       group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(left, right)`` of a ring exchange of ``tail`` and ``head``.

    CUDA tensors: kernel K13 on the current stream, no synchronisation:
    ``halo_send`` on the SM route, ``halo_send`` and ``halo_recv`` on the
    stream route (:data:`ROUTE`). The first call of a ring with a given
    block size shares the buffers (a collective on ``group``). All ranks
    must call with blocks of the same size, in the same order. CPU tensors:
    :func:`halo_exchange_plain`.
    """
    name = "halo_exchange_cuda"
    _check_pair(tail, head, name)
    if not _plain_or_cuda(tail, name):
        return halo_exchange_plain(tail, head, group)
    size, _, _ = _neighbours(group)
    if size == 1:
        return tail.clone(), head.clone()
    tail, head = tail.contiguous(), head.contiguous()
    nbytes = tail.numel() * tail.element_size()
    left, right = torch.empty_like(tail), torch.empty_like(head)
    if nbytes == 0:
        return left, right
    ring = _ring(group, tail.device, nbytes)
    stream = torch.cuda.current_stream(tail.device)
    if ring.stream is not None and ring.stream != stream:
        # the two-slot argument needs this ring's exchanges in order
        stream.wait_stream(ring.stream)
    ring.stream = stream
    ring.epoch += 1
    timeout_ns = int(TIMEOUT_S * 1e9)
    on_sms = (ROUTE or ring.route) == "sms"
    # both on the current stream of tail's card, which is `stream`
    _enqueue(name, LAUNCHES, "halo_send", tail.device, "halo_send",
             tail.data_ptr(), head.data_ptr(), ring.right.data_ptr(),
             ring.left.data_ptr(), ring.buf.data_ptr(), left.data_ptr(),
             right.data_ptr(), nbytes, ring.stride, ring.blocks, ring.epoch,
             timeout_ns if on_sms else 0)
    if not on_sms:
        _enqueue(name, LAUNCHES, "halo_recv", tail.device, "halo_recv",
                 ring.buf.data_ptr(), left.data_ptr(), right.data_ptr(),
                 nbytes, ring.stride, ring.blocks, ring.epoch, timeout_ns)
    return left, right
