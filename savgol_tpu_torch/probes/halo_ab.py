"""Times the ring halo exchange K13 (``csrc/halo_ring.cu``) of one checkout
of this package on the card, in two harnesses, so that two checkouts can be
compared in one call, in turns (parent, change, change, parent):

    python savgol_tpu_torch/probes/halo_ab.py [--root DIR] [--only a|b]
        [--reps N]

imports ``savgol_tpu_torch`` from DIR (default: the checkout this file is
in), builds its kernels and prints one JSON record: the card's name and
power limit, the root, the design it found (``split``: ``halo_send``, and
``halo_recv`` after the stream's wait on the stream route; ``spin``: the
one ``halo_ring`` kernel that waits on the SMs), and

- ``a``: four spawned ranks that share the card, each in its own CUDA
  context (``parallel.launch.Pool``, as ``chip_smoke.py`` phases 26-29 run
  them), by rank: the median ms of one exchange through
  ``ops.cuda_halo.halo_exchange_cuda`` at the 1D headline halos ((128, 12)
  f32 a side: the 1D headline split 4 ways, n = 12) and at the 2D rows
  halos ((16, 5, 2048) f32, flattened to (80, 2048): the 2D headline split
  4 ways by rows, ny = 5), on ``utils.timing.cuda_time_ms``; the host ms
  of a 1D headline exchange (``utils.timing.host_ms``: enqueue only, 100
  back to back); and the entry points that run it: ``apply_sharded`` on the
  1D headline (128, 1,048,576) f32 split 4 ways along the samples,
  ``apply2d_sharded`` on the 2D headline (16, 2048, 2048) f32, 11 x 11
  order 3, CONSTANT, by rows and on a 2 x 2 tiling (two exchanges);
- ``b``: one process and one context, P = 4 ring members on 4 CUDA streams,
  each with its own buffer and its neighbours' pointers taken directly
  (no IPC), driving the checkout's C entries: the median ms of one exchange
  of all members, forked from and joined on one stream, at both halo sizes
  (``utils.timing.device_ms``: the card is kept busy while the host enqueues
  the members' launches, so the interval is the card's), and whether 20
  exchanges back to back, each on fresh values, gave every member its
  neighbours' slices bit for bit. This is the exchange's own latency
  without the time-slicer: on one card, the nearest reading of one card a
  rank. A split checkout runs its SM route there (``b``: a rank with a
  card to itself takes it) and its stream route too (``b stream route``).

Every checkout is timed with this checkout's ``utils/timing.py`` (loaded
by path). Harness (b) runs after (a) with ``CUDA_DEVICE_MAX_CONNECTIONS`` at
32 in this process, and issues every member's send before any member's
wait: two members' streams may still share a hardware queue, where a wait
ahead of the other's send would never pass.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]
TIMING = HERE / "savgol_tpu_torch" / "utils" / "timing.py"

# a side of one exchange, f32: the 1D headline's (B, n) and the 2D rows
# split's (B * ny, C)
HALOS = {"1d": (128, 12), "rows": (16 * 5, 2048)}
RING = 4
# harness (b)'s bound on a member's wait (the same as cuda_halo.TIMEOUT_S)
TIMEOUT_NS = 10_000_000_000
# a member's buffer: room for any design's flag area (kFlagBytes: 256 in
# the spin design, 512 since) and two parities of two slots
_FLAG_BYTES = 4096
_SLOTS = 4


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def timing():
    """This checkout's ``utils/timing.py``, loaded by path (it imports only
    torch and the standard library)."""
    spec = importlib.util.spec_from_file_location("_halo_ab_timing", TIMING)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def design(lib) -> str:
    try:
        lib.halo_send
    except AttributeError:
        return "spin"
    return "split"


def rank_a(reps: int) -> dict:
    """Harness (a), a rank's body: K13 at both halo sizes, its host time,
    and the sharded entry points, on the pool's group (a ring of 4)."""
    import torch
    import torch.distributed as dist

    import savgol_tpu_torch as sgt
    from savgol_tpu_torch.ops import cuda_halo as ch
    from savgol_tpu_torch.parallel import apply2d_sharded, apply_sharded
    from savgol_tpu_torch.parallel.launch import mesh

    tm = timing()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(dist.get_rank())
    world = dist.group.WORLD
    out = {"launches": sorted(ch.LAUNCHES)}
    halos = {}
    for name, shape in HALOS.items():
        tail, head = (torch.randn(shape, generator=gen, device=dev)
                      for _ in range(2))
        halos[name] = (tail, head)
        out[f"K13 {name}"] = tm.cuda_time_ms(
            lambda: ch.halo_exchange_cuda(tail, head, world), reps=reps)
    tail, head = halos["1d"]
    out["K13 1d host"] = tm.host_ms(
        lambda: ch.halo_exchange_cuda(tail, head, world), warmup=10, reps=100)
    m = mesh(("batch", "seq"), (1, RING), "cuda")
    f = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4), device=dev)
    x = torch.randn(128, (1 << 20) // RING, generator=gen, device=dev)
    out["apply_sharded 1d"] = tm.cuda_time_ms(lambda: apply_sharded(
        x, f.center_weights, f.edge_weights, half_window=12, mesh=m,
        dt_inv=f.dt_inv, halo="rdma"))
    del x
    f2 = sgt.Savgol2D.create(sgt.Savgol2DConfig(5, 5, 3), device=dev)
    img = torch.randn(16, 2048 // RING, 2048, generator=gen, device=dev)
    out["apply2d_sharded rows"] = tm.cuda_time_ms(lambda: apply2d_sharded(
        img, f2.weights, mesh=m, boundary="constant", scale=f2.scale,
        halo="rdma"))
    m2 = mesh(("seq", "cols"), (2, 2), "cuda")
    img = torch.randn(16, 1024, 1024, generator=gen, device=dev)
    out["apply2d_sharded tiled"] = tm.cuda_time_ms(lambda: apply2d_sharded(
        img, f2.weights, mesh=m2, boundary="constant", scale=f2.scale,
        halo="rdma", col_axis="cols"))
    return out


class Members:
    """Harness (b): P ring members in one process, each with its own
    buffer and stream, exchanging through ``lib``'s C entries: the spin
    design's ``halo_ring``, or ``halo_send`` on ``route`` "sms" (one
    launch; the route of a rank with a card to itself) or "stream"
    (``halo_send`` and ``halo_recv``)."""

    def __init__(self, lib, shape, P: int = RING, copies: int = 1,
                 route: str = "sms"):
        import torch

        self.lib, self.P, self.route = lib, P, route
        dev = torch.device("cuda")
        self.nbytes = shape[0] * shape[1] * 4
        self.stride = -(-self.nbytes // 256) * 256
        self.blocks = lib.halo_ring_blocks(self.nbytes)
        self.split = design(lib) == "split"
        self.bufs = [torch.zeros(_FLAG_BYTES + _SLOTS * self.stride,
                                 dtype=torch.uint8, device=dev)
                     for _ in range(P)]
        self.streams = [torch.cuda.Stream() for _ in range(P)]
        gen = torch.Generator(device=dev).manual_seed(5)
        # copies x members x (tail, head) and the outputs (left, right)
        self.x = torch.randn((copies, P, 2) + tuple(shape), generator=gen,
                             device=dev)
        self.out = torch.full_like(self.x, float("nan"))
        torch.cuda.synchronize()
        self.epoch = 0

    def exchange(self, c: int = 0) -> None:
        """One exchange of every member, forked from and joined on the
        current stream, on copy ``c`` of the inputs and outputs."""
        import torch

        self.epoch += 1
        main = torch.cuda.current_stream()
        for s in self.streams:
            s.wait_stream(main)
        lib, P, e = self.lib, self.P, self.epoch
        # every member's send before any member's wait: two members' streams
        # may share a hardware queue, where a wait ahead of the other's send
        # would never pass
        for m in range(P):
            s = self.streams[m].cuda_stream
            right = self.bufs[(m + 1) % P].data_ptr()
            left = self.bufs[(m - 1) % P].data_ptr()
            tail, head = (v.data_ptr() for v in self.x[c, m])
            ol, orr = (v.data_ptr() for v in self.out[c, m])
            if self.split:
                err = lib.halo_send(tail, head, right, left,
                                    self.bufs[m].data_ptr(), ol, orr,
                                    self.nbytes, self.stride, self.blocks, e,
                                    TIMEOUT_NS if self.route == "sms" else 0,
                                    s)
            else:
                err = lib.halo_ring(tail, head, right, left,
                                    self.bufs[m].data_ptr(), ol, orr,
                                    self.nbytes, self.stride, self.blocks, e,
                                    TIMEOUT_NS, s)
            if err:
                raise RuntimeError(f"member {m}: cudaError_t {err}")
        for m in range(P if self.split and self.route == "stream" else 0):
            ol, orr = (v.data_ptr() for v in self.out[c, m])
            err = lib.halo_recv(self.bufs[m].data_ptr(), ol, orr,
                                self.nbytes, self.stride, self.blocks, e,
                                TIMEOUT_NS, self.streams[m].cuda_stream)
            if err:
                raise RuntimeError(f"member {m}: cudaError_t {err}")
        for s in self.streams:
            main.wait_stream(s)

    def exact(self) -> bool:
        """Every copy's outputs are the neighbours' slices, bit for bit:
        left = the left member's tail, right = the right member's head."""
        import torch

        torch.cuda.synchronize()
        want_l = torch.roll(self.x[:, :, 0], 1, dims=1)
        want_r = torch.roll(self.x[:, :, 1], -1, dims=1)
        return bool(torch.equal(self.out[:, :, 0], want_l)
                    and torch.equal(self.out[:, :, 1], want_r))


def harness_b(lib, reps: int, back_to_back: int = 20,
              route: str = "sms") -> dict:
    """Harness (b) at both halo sizes on ``route`` (a design without routes
    has one): {size: {"ms", "exact"}}."""
    tm = timing()
    out = {}
    for name, shape in HALOS.items():
        check = Members(lib, shape, copies=back_to_back, route=route)
        for c in range(back_to_back):
            check.exchange(c)
        exact = check.exact()
        del check
        timed = Members(lib, shape, route=route)
        ms = tm.device_ms(timed.exchange, warmup=5, reps=reps)
        out[name] = {"ms": ms, "exact": exact and timed.exact()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--only", choices=("a", "b"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import savgol_tpu_torch as sgt
    if pathlib.Path(sgt.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {sgt.__file__}, not from {root}")
    from savgol_tpu_torch._build import build

    build()
    record = {"card": card(), "root": str(root)}
    if args.only != "b":
        from savgol_tpu_torch.parallel.launch import Pool
        with Pool(RING, device="cuda") as pool:
            ranks = pool.run(rank_a, args.reps)
        record["a"] = {k: [r[k] for r in ranks] for k in ranks[0]}
    if args.only != "a":
        # before this process's first CUDA call
        os.environ["CUDA_DEVICE_MAX_CONNECTIONS"] = "32"
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("halo_ab needs a CUDA device")
        from savgol_tpu_torch._build import library
        lib = library()
        record["design"] = design(lib)
        record["b"] = harness_b(lib, args.reps)
        if record["design"] == "split":
            record["b stream route"] = harness_b(lib, args.reps,
                                                 route="stream")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
