"""K12 (``csrc/resample.cu``) of this checkout against another checkout's,
bit for bit and in turns, in one process on the card:

    python -m savgol_tpu_torch.probes.resample_bits --parent DIR

builds the ``resample.cu`` of this checkout and of DIR into two shared
libraries (the package's nvcc flags with ``-Xptxas -v``), loads them with
ctypes and prints one JSON record: the card, each build's registers, stack
and spill by kernel, the number of cases whose outputs differ in any bit
over a grid (the four dtype entries; m = 0-12, 20 and 40 with every d;
B = 1, 3, 4, 8 and 17; 1, 7 and 3,000 queries, the first and last centres
outside the data; random planes with s in [4, 8) and ok 0 a fifth of the
time), and both kernels' device times (``utils.timing.device_ms``, min,
median and max of four rounds in alternating order) at the resample row
of ``chip_smoke.py``: 131,072 sorted queries over (B, 131,072) planes,
m = 4, 7 and 9 in f32 and m = 4 in f64, B = 8, 17 and 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess

_HERE = pathlib.Path(__file__).resolve().parents[1]
_OUT = _HERE.parent / "build" / "resample_bits"


def _build(sources: dict) -> tuple[dict, dict]:
    """({name: library}, {name: ptxas summary}), built in parallel."""
    from savgol_tpu_torch._build import _FLAGS, _SIGNATURES, _nvcc
    from savgol_tpu_torch.probes.variants import _ptxas
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_nvcc(), *_FLAGS, "-shared", "-Xptxas", "-v", str(src), "-o",
         str(_OUT / f"{name}.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, src in sources.items()}
    libs, regs = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out[-4000:]}")
        regs[name] = _ptxas(out)
        lib = ctypes.CDLL(str(_OUT / f"{name}.so"))
        for fn, args in _SIGNATURES.items():
            if fn.startswith("resample_"):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    args = ap.parse_args()

    import numpy as np
    import torch

    from savgol_tpu_torch.probes.masked_ab import card
    from savgol_tpu_torch.utils.timing import device_ms

    if not torch.cuda.is_available():
        raise SystemExit("resample_bits needs a CUDA device")
    parent = pathlib.Path(args.parent).resolve()
    libs, regs = _build({
        "parent": parent / "savgol_tpu_torch" / "csrc" / "resample.cu",
        "change": _HERE / "csrc" / "resample.cu"})
    dev = torch.device("cuda")

    def call(lib, planes, t, ctr, tq, out, m, d, fill):
        name = "resample_{}_t{}".format(
            "f32" if planes.dtype == torch.float32 else "f64",
            "32" if t.dtype == torch.float32 else "64")
        B, N = planes.shape[1], planes.shape[2]
        err = getattr(lib, name)(
            planes.data_ptr(), t.data_ptr(), ctr.data_ptr(), tq.data_ptr(),
            out.data_ptr(), B, N, tq.numel(), m, d, fill,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{name}: cudaError_t {err}")

    def planes_of(rng, m, B, N, dtype):
        return torch.from_numpy(np.concatenate([
            rng.standard_normal((m + 1, B, N)),
            rng.uniform(4.0, 8.0, (1, B, N)),
            (rng.random((1, B, N)) > 0.2) * 1.0])).to(dev, dtype)

    rng = np.random.default_rng(5)
    N, cases, differ = 3000, 0, []
    for T, TT in ((torch.float32, torch.float32),
                  (torch.float32, torch.float64),
                  (torch.float64, torch.float32),
                  (torch.float64, torch.float64)):
        t = torch.from_numpy(np.cumsum(rng.uniform(0.5, 1.5, N))).to(dev, TT)
        bits = torch.int32 if T == torch.float32 else torch.int64
        for m in [*range(13), 20, 40]:
            for B in (1, 3, 4, 8, 17):
                planes = planes_of(rng, m, B, N, T)
                for nq in (1, 7, 3000):
                    tq = torch.from_numpy(np.sort(rng.uniform(
                        float(t[0]) - 5, float(t[-1]) + 5, nq))).to(dev, TT)
                    ctr = torch.clamp(torch.searchsorted(t, tq) - 6, 0,
                                      N - 13) + 6
                    if nq > 1:
                        ctr[0], ctr[-1] = -1, N
                    for d in range(m + 1):
                        outs = []
                        for lib in libs.values():
                            o = torch.full((B, nq), 7.0, device=dev, dtype=T)
                            call(lib, planes, t, ctr, tq, o, m, d, -3.0)
                            outs.append(o.view(bits))
                        if not torch.equal(*outs):
                            differ.append(f"{T} t {TT} m={m} B={B} "
                                          f"Nq={nq} d={d}")
                        cases += 1

    N = 131_072
    t1 = torch.cumsum(torch.rand(N, device=dev) + 0.5, 0)
    tq1 = torch.linspace(t1[0].item(), t1[-1].item(), N, device=dev)
    ctr = torch.clamp(torch.searchsorted(t1, tq1) - 12, 0, N - 25) + 12
    ms = {}
    for m, T in ((4, torch.float32), (7, torch.float32), (9, torch.float32),
                 (4, torch.float64)):
        for B in (8, 17, 1):
            planes = planes_of(rng, m, B, N, T)
            tt, tq = t1.to(T), tq1.to(T)
            outs = {n: torch.empty(B, N, device=dev, dtype=T) for n in libs}
            times = {n: [] for n in libs}
            for r in range(4):
                for n in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                    times[n].append(device_ms(lambda: call(
                        libs[n], planes, tt, ctr, tq, outs[n], m, 0, 0.0)))
            tag = f"m={m} B={B}" + (" f64" if T == torch.float64 else "")
            ms[tag] = {n: [min(v), statistics.median(v), max(v)]
                       for n, v in times.items()}
            ms[tag]["bit_equal"] = torch.equal(outs["parent"],
                                               outs["change"])
    print(json.dumps({"card": card(), "parent": str(parent), "ptxas": regs,
                      "cases": cases, "differ": differ, "ms": ms}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
