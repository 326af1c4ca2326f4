"""A persistent pool of ranks for the multi-rank functions: test and smoke
infrastructure, with no JAX counterpart (a JAX process sees every device;
a PyTorch rank is a process).

:class:`Pool` starts P processes with the ``spawn`` start method, joins them
in one ``gloo`` process group (a ``FileStore`` in a fresh temporary
directory, so concurrent pools never meet), and runs an SPMD body, a
module-level function, on every rank. :func:`run_sharded` is the body the
tests use: it cuts global numpy inputs into the rank's blocks by its mesh
coordinates, calls an entry point of :mod:`savgol_tpu_torch.parallel`, and
gathers the output (and the input gradients of ``sum(y ** 2)``) to every
rank. A spawned rank imports only this package, never a test module.

    with Pool(4) as pool:
        outs = pool.run(run_sharded, "apply_sharded", ("batch", "seq"),
                        (1, 4), [Sharded(x, (None, "seq")), Full(cw),
                                 Full(ew)], {"half_window": 6},
                        (None, "seq"))
        y, grads = outs[0]

With ``device="cuda"`` every rank takes the card ``rank % device_count``
(so P ranks may share one card) and keeps the ``gloo`` group: NCCL refuses
two ranks on one card, and kernel K13 needs no backend to move its halos.
A pool's device defaults to the card (:func:`_device.card_unless_named`:
with no card it raises and names ``device="cpu"``); the bodies' device
defaults to their pool's.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import multiprocessing
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from savgol_tpu_torch._device import card_unless_named

__all__ = ["Pool", "Sharded", "Full", "mesh", "run_sharded", "run_error",
           "run_halo", "run_broken_ring"]

# how long a collective of a rank waits for the others before it fails,
# and how long Pool.run waits for every rank's answer
_GROUP_TIMEOUT_S = 120
_RUN_TIMEOUT_S = 600

# the device of the pool this process serves as a rank (None elsewhere)
_POOL_DEVICE: Optional[str] = None


def _rank_device(device: Optional[str], what: str) -> str:
    """``device`` as given, else the device of this rank's pool, else the
    card (:func:`card_unless_named`)."""
    if device is not None:
        return device
    return _POOL_DEVICE or card_unless_named(None, what)


def _serve(rank: int, world: int, init: str, device: str, conn) -> None:
    """A rank's loop: run each (fn, args, kwargs) it is sent and send back
    (True, result) or (False, traceback), until it is sent None."""
    global _POOL_DEVICE
    _POOL_DEVICE = device
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=_GROUP_TIMEOUT_S))
    from savgol_tpu_torch.ops import cuda_halo
    while True:
        msg = conn.recv()
        if msg is None:
            break
        fn, args, kwargs = msg
        try:
            conn.send((True, fn(*args, **kwargs)))
        except BaseException:
            conn.send((False, f"rank {rank}:\n{traceback.format_exc()}"))
    # every rank drops its neighbours' K13 buffers before any rank exits and
    # frees its own (CUDA IPC: the exporting process must outlive the maps)
    cuda_halo.release()
    _mesh.cache_clear()
    dist.barrier()
    if torch.cuda.is_initialized():
        torch.cuda.ipc_collect()
    dist.destroy_process_group()


class Pool:
    """P ranks of one ``gloo`` process group in spawned processes."""

    def __init__(self, world: int, device: Optional[str] = None):
        device = card_unless_named(device, "Pool")
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self._dir = tempfile.mkdtemp(prefix="savgol_pool_")
        init = "file://" + os.path.join(self._dir, "store")
        self._conns, self._procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_serve,
                               args=(rank, world, init, device, child),
                               daemon=True)
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)

    def run(self, fn: Callable, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; the results by rank.

        Where a rank raises, this raises with its traceback. The pool stays
        up if every rank answers within a few seconds of that (they all
        raised, or finished); otherwise a rank is stuck in a collective and
        the pool is ended."""
        if not self._procs:
            raise RuntimeError("the pool is closed")
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        results: dict = {}
        failure = None
        deadline = time.monotonic() + _RUN_TIMEOUT_S
        while len(results) < self.world:
            waiting = [c for r, c in enumerate(self._conns)
                       if r not in results]
            ready = multiprocessing.connection.wait(
                waiting, timeout=max(0.0, deadline - time.monotonic()))
            if not ready:
                self.close(kill=True)
                raise RuntimeError(
                    failure or f"{fn.__name__} did not finish on every rank "
                    f"in {_RUN_TIMEOUT_S} s")
            for conn in ready:
                rank = self._conns.index(conn)
                try:
                    ok, value = conn.recv()
                except EOFError:
                    self.close(kill=True)
                    raise RuntimeError(f"{fn.__name__}: rank {rank} exited")
                results[rank] = value
                if not ok and failure is None:
                    failure = f"{fn.__name__} failed on {value}"
                    deadline = min(deadline, time.monotonic() + 5.0)
        if failure is not None:
            raise RuntimeError(failure)
        return [results[r] for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        """Stop every rank (at once with ``kill``) and remove the store."""
        for conn, proc in zip(self._conns, self._procs):
            if not kill:
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for proc in self._procs:
            proc.join(timeout=None if not kill else 0)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)


def mesh(axis_names: tuple, shape: tuple, device_type: Optional[str] = None):
    """A rank's mesh, made once per (names, shape, device type): its ring
    groups, and the K13 buffers keyed by them, last for the pool. The
    device type defaults to the pool's (:func:`_rank_device`)."""
    return _mesh(tuple(axis_names), tuple(shape),
                 _rank_device(device_type, "mesh"))


@functools.lru_cache(maxsize=None)
def _mesh(axis_names: tuple, shape: tuple, device_type: str):
    from savgol_tpu_torch.parallel.sharded import make_mesh
    return make_mesh(axis_names, shape, device_type=device_type)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A global numpy array that each rank receives as its block, cut by
    ``spec`` (one mesh axis name or None an axis)."""
    array: Any
    spec: Sequence[Optional[str]]
    grad: bool = False


@dataclasses.dataclass(frozen=True)
class Full:
    """A numpy array that each rank receives whole."""
    array: Any


def _tensor(item, m, device, wanted: list):
    """A :class:`Sharded` or :class:`Full` item as this rank's tensor on
    ``device`` (with ``requires_grad`` and a place in ``wanted`` when it is
    marked ``grad``); anything else as is."""
    from savgol_tpu_torch.parallel.sharded import shard

    if not isinstance(item, (Sharded, Full)):
        return item
    t = torch.as_tensor(np.asarray(item.array), device=device)
    spec = item.spec if isinstance(item, Sharded) else ()
    t = shard(t, m, spec)
    if getattr(item, "grad", False):
        t.requires_grad_()
        wanted.append((t, spec))
    return t


def run_sharded(entry: str, axis_names: tuple, shape: tuple, args: list,
                kwargs: dict, out_spec: Sequence[Optional[str]],
                device: Optional[str] = None):
    """SPMD body: ``savgol_tpu_torch.parallel.<entry>`` on this rank's
    blocks of ``args`` / ``kwargs`` (:class:`Sharded` and :class:`Full`
    become tensors on ``device``; anything else passes as is), with
    ``mesh=`` added. Returns ``(y, grads)`` as numpy arrays gathered from
    every rank: ``y`` by ``out_spec``, ``grads`` the gradients of
    ``sum(y ** 2)`` with respect to each input marked ``grad``, in order
    (an empty list when none is). ``device`` defaults to the pool's."""
    from savgol_tpu_torch import parallel
    from savgol_tpu_torch.parallel.sharded import gather

    device = _rank_device(device, "run_sharded")
    m = mesh(tuple(axis_names), tuple(shape), device)
    wanted: list = []
    call_args = [_tensor(a, m, device, wanted) for a in args]
    call_kwargs = {k: _tensor(v, m, device, wanted)
                   for k, v in kwargs.items()}
    y = getattr(parallel, entry)(*call_args, mesh=m, **call_kwargs)
    grads = []
    if wanted:
        g = torch.autograd.grad(y.square().sum(), [t for t, _ in wanted])
        grads = [gather(gi, m, spec).numpy() for gi, (_, spec)
                 in zip(g, wanted)]
    return gather(y, m, out_spec).numpy(), grads


def run_error(entry: str, axis_names: tuple, shape: tuple, args: list,
              kwargs: dict, device: Optional[str] = None):
    """SPMD body: ``(type name, message)`` of the exception the call of
    :func:`run_sharded` raises on this rank (None if it returns), so that a
    test can check an error without ending the pool. Only for errors
    raised before any collective, which every rank raises alike."""
    try:
        run_sharded(entry, axis_names, shape, args, kwargs, (), device)
    except Exception as e:     # noqa: BLE001 - the error is the result
        return type(e).__name__, str(e)
    return None


def run_halo(axis_names: tuple, shape: tuple, x, spec, n: int, rows: bool,
             cotangents=None, seq_axis: str = "seq",
             device: Optional[str] = None, route: Optional[str] = None):
    """SPMD body: ``halo_exchange_rdma`` (``rows=False``, last axis) or
    ``halo_exchange_rdma_rows`` of this rank's block of the global numpy
    ``x`` over the ring of mesh axis ``seq_axis``. Returns the gathered
    ``(left, right)`` halos (cut like ``x``), the gradient of
    ``sum(left * cl) + sum(right * cr)`` for global ``cotangents`` ``(cl,
    cr)`` (None without them), K13's exchanges in the call (its launches
    of ``halo_send``, which those of ``halo_recv`` equal on the stream route
    and leave at 0 on the SM route; the pair of counts otherwise), and, for
    CUDA tensors, whether the plain version (through the host on a ``gloo``
    group) gives the same halos bit for bit (None on the CPU). ``route``
    sets ``cuda_halo.ROUTE`` for the call (None: each rank's own)."""
    from savgol_tpu_torch.ops import cuda_halo
    from savgol_tpu_torch.parallel.ici_halo import (halo_exchange_rdma,
                                                    halo_exchange_rdma_rows)
    from savgol_tpu_torch.parallel.sharded import gather, mesh_axis, shard

    device = _rank_device(device, "run_halo")
    m = mesh(tuple(axis_names), tuple(shape), device)
    group = mesh_axis(m, seq_axis)[0]
    xl = shard(torch.as_tensor(np.asarray(x), device=device), m, spec)
    xl.requires_grad_(cotangents is not None)
    fn = halo_exchange_rdma_rows if rows else halo_exchange_rdma
    before = dict(cuda_halo.LAUNCHES)
    cuda_halo.ROUTE = route
    try:
        left, right = fn(xl, n, group)
        grad = None
        if cotangents is not None:
            cl, cr = (shard(torch.as_tensor(np.asarray(c), device=device), m,
                            spec) for c in cotangents)
            loss = (left * cl).sum() + (right * cr).sum()
            grad = gather(torch.autograd.grad(loss, xl)[0], m, spec).numpy()
    finally:
        cuda_halo.ROUTE = None
    if device == "cuda":
        torch.cuda.synchronize()
    sends, recvs = (cuda_halo.LAUNCHES[k] - before[k]
                    for k in ("halo_send", "halo_recv"))
    launches = sends if recvs in (0, sends) else (sends, recvs)
    plain_equal = None
    if xl.device.type == "cuda":
        C = xl.shape[-1] if rows else 1
        xb = xl.detach().unsqueeze(-1) if not rows else xl.detach()
        tail = xb[..., -n:, :].reshape(-1, C).cpu()
        head = xb[..., :n, :].reshape(-1, C).cpu()
        pl, pr = cuda_halo.halo_exchange_plain(tail, head, group)
        plain_equal = (torch.equal(pl, left.detach().reshape(-1, C).cpu())
                       and torch.equal(pr,
                                       right.detach().reshape(-1, C).cpu()))
    return (gather(left.detach(), m, spec).numpy(),
            gather(right.detach(), m, spec).numpy(), grad, launches,
            plain_equal)


def run_broken_ring(skip_rank: int, timeout_s: float,
                    route: Optional[str] = None):
    """SPMD body on a CUDA pool: one K13 exchange over the pool's group,
    then a second that rank ``skip_rank`` leaves out, with
    ``cuda_halo.TIMEOUT_S`` set to ``timeout_s`` and ``cuda_halo.ROUTE`` to
    ``route``. Returns ``(what, seconds, message)``: "skipped" on
    ``skip_rank``; elsewhere "raised" or "returned" and the host seconds
    from the second exchange's call to the end of the synchronise after it.
    A broken ring must raise there (``halo_send`` traps on the SM route; on
    the stream route the watchdog releases the wait and ``halo_recv``
    traps), never hang. The card's context of a rank that raised is lost,
    so end the pool after."""
    from savgol_tpu_torch.ops import cuda_halo

    cuda_halo.TIMEOUT_S = timeout_s
    cuda_halo.ROUTE = route
    t = torch.arange(12.0, device="cuda") + dist.get_rank()
    cuda_halo.halo_exchange_cuda(t, t + 100, dist.group.WORLD)
    torch.cuda.synchronize()
    dist.barrier()
    if dist.get_rank() == skip_rank:
        return "skipped", 0.0, ""
    start = time.monotonic()
    try:
        cuda_halo.halo_exchange_cuda(t, t + 100, dist.group.WORLD)
        torch.cuda.synchronize()
    except Exception as e:     # noqa: BLE001 - the error is the result
        return "raised", time.monotonic() - start, str(e)
    return "returned", time.monotonic() - start, ""
