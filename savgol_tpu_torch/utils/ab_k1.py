"""Time kernel K1 built from two source trees, in one process, in turns.

    python -m savgol_tpu_torch.utils.ab_k1 OTHER_CSRC [--ws 25] [--rounds 3]

Builds ``OTHER_CSRC/sg1d_poly.cu`` (another checkout's ``csrc``, for example
the parent commit's) into its own library with the port's ``nvcc`` flags,
loads it beside the port's library, and times ``sg1d_poly_f32`` of each on
the same (128, 1,048,576) float32 batch (the 1D headline) with CUDA events,
L2 flushed (``utils/timing.py``), in the order other, this, this, other,
repeated ``--rounds`` times, so that both see the same card and clocks.
Prints each time, both medians and whether the two outputs are equal bit
for bit. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import tempfile

import numpy as np
import torch

from savgol_tpu_torch import _build
from savgol_tpu_torch.ops.weights import savgol_weights_np
from savgol_tpu_torch.utils.timing import cuda_time_ms


def _load_other(csrc: pathlib.Path, out_dir: pathlib.Path):
    so = out_dir / "libother_k1.so"
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(so),
                    str(csrc / "sg1d_poly.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.sg1d_poly_f32
    fn.argtypes = _build._SIGNATURES["sg1d_poly_f32"]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", type=pathlib.Path)
    ap.add_argument("--ws", type=int, default=25)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_k1 needs a CUDA device")
    from savgol_tpu_torch.config import SavgolConfig
    n = args.ws // 2
    cw, ew = (torch.from_numpy(a).to("cuda", torch.float32) for a in
              savgol_weights_np(SavgolConfig(n, 4), dtype=np.float64))
    x = torch.randn(128, 1 << 20, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"other": _load_other(args.other_csrc, pathlib.Path(tmp)),
               "this": _build.library().sg1d_poly_f32}
        outs = {k: torch.empty_like(x) for k in fns}

        def run(k):
            err = fns[k](x.data_ptr(), cw.data_ptr(), ew.data_ptr(),
                         outs[k].data_ptr(), 128, 1 << 20, n, 1.0, stream)
            if err:
                raise RuntimeError(f"{k}: cudaError_t {err}")

        times = {"other": [], "this": []}
        for _ in range(args.rounds):
            for k in ("other", "this", "this", "other"):
                times[k].append(cuda_time_ms(lambda: run(k), reps=20))
        torch.cuda.synchronize()
        for k, ts in times.items():
            print(f"K1 ws={args.ws} {k}: " + " ".join(f"{t:.4f}" for t in ts)
                  + f" ms, median {statistics.median(ts):.4f}")
        print(f"outputs equal bit for bit: "
              f"{torch.equal(outs['other'], outs['this'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
