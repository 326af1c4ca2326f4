"""Times K2D-dense (``csrc/corr2d_valid.cu``) against K7
(``csrc/corr2d_sep.cu``) on the card over the stencils of 17 taps or fewer
a side: the table that ``ops/apply2d.py``'s choice between them
(``_sep_cheaper``) is fit from::

    python -m savgol_tpu_torch.probes.route2d [--sweep] [--out FILE]

Windows (H x W): every odd square side 3-17 and the rectangles 5 x 11,
11 x 5, 7 x 13 and 13 x 7. Stencils: orders 0-6 where the window poses
them, derivatives (0, 0), (1, 0) and (2, 0), which factor to ranks 1-4 at
their dtype's ``_rank_rtol``. Dtypes f32 and f64; images (16, 2048, 2048)
(the 2D headline) and (4, 256, 256) (where a launch's tiles are few);
``--sweep`` times the windows about the crossover over images from 4 of
K7's blocks to its 2,048 at the headline instead. CONSTANT boundary.
K2D-dense is timed once a (window, dtype, image), K7 once a (window,
rank, dtype, image) on the factors of the first stencil of that rank,
both by ``utils.timing.device_ms`` (device time, L2 flushed, median of
15) in two passes over every case, the second in the reverse order.

Prints one JSON line a case: the card, the window, dtype, image, the share
of the card's resident slots K7's blocks fill (``apply2d._sep_fill``),
rank, the stencils (order, derivative) of that rank, K7's instance
(``cuda_conv2d.sep_instance``), the times of each pass (``dense_ms``,
``sep_ms``), ``sep_over_dense`` (the ratio of the medians) and
``rule``, the kernel ``apply2d._sep_cheaper`` picks; then a summary line
with the cases where the rule's pick is the slower kernel and the time
that costs. ``--out`` also writes every line to FILE.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics

import numpy as np
import torch

from savgol_tpu_torch.config import Savgol2DConfig, num_terms_2d
from savgol_tpu_torch.ops import cuda_conv2d as c2
from savgol_tpu_torch.ops.apply2d import (_rank_rtol, _sep_cheaper,
                                          _sep_fill)
from savgol_tpu_torch.ops.weights import savgol2d_weights_np
from savgol_tpu_torch.probes.masked_ab import card
from savgol_tpu_torch.utils.timing import device_ms

WINDOWS = tuple((s, s) for s in range(3, 19, 2)) + (
    (5, 11), (11, 5), (7, 13), (13, 7))
ORDERS = range(7)
DERIVS = ((0, 0), (1, 0), (2, 0))
DTYPES = (torch.float32, torch.float64)
IMAGES = ((16, 2048, 2048), (4, 256, 256))
# --sweep: images from K7's 4 blocks (of 64 columns x 512 rows) to its
# 2,048 at the headline, over windows about the crossover
SWEEP_IMAGES = ((1, 256, 256), (4, 256, 256), (16, 256, 256),
                (1, 1024, 1024), (16, 512, 512), (4, 1024, 1024),
                (1, 2048, 2048), (48, 256, 256), (6, 1024, 1024),
                (64, 256, 256), (2, 2048, 2048), (7, 1024, 1024),
                (3, 2048, 2048), (12, 1024, 1024), (112, 256, 256),
                (14, 1024, 1024), (64, 512, 512), (16, 1024, 1024),
                (4, 2048, 2048), (1, 4096, 4096), (8, 2048, 2048),
                (16, 2048, 2048))
SWEEP_WINDOWS = ((7, 7), (9, 9), (11, 11), (13, 13), (17, 17), (5, 11))


def stencils(H: int, W: int, dtype) -> dict:
    """{rank: [(order, (dx, dy), host stencil in ``dtype``'s values as
    f64), ...]} over ORDERS x DERIVS where the H x W window poses the
    fit."""
    out = {}
    for m in ORDERS:
        if num_terms_2d(m) > H * W:
            continue
        for dx, dy in DERIVS:
            if dx + dy > m:
                continue
            cfg = Savgol2DConfig((W - 1) // 2, (H - 1) // 2, m, deriv_x=dx,
                                 deriv_y=dy)
            try:
                w = savgol2d_weights_np(cfg, dtype=np.float64)
            except np.linalg.LinAlgError:      # not identifiable there
                continue
            w = torch.as_tensor(w, dtype=dtype).double().numpy()
            r = c2._svd_stencil_np(w, _rank_rtol(dtype))[0].shape[0]
            out.setdefault(r, []).append((m, (dx, dy), w))
    return out


def cases(sweep: bool = False) -> list:
    """Every timed case: (image, dtype, H, W, {rank: stencils})."""
    images, windows = ((SWEEP_IMAGES, SWEEP_WINDOWS) if sweep
                       else (IMAGES, WINDOWS))
    return [(shape, dtype, H, W, stencils(H, W, dtype))
            for shape in images for dtype in DTYPES for H, W in windows]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time the windows about the crossover over "
                         "SWEEP_IMAGES instead of every window at IMAGES")
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("route2d needs a CUDA device")
    dev = torch.device("cuda")
    name = card()
    gen = torch.Generator(device=dev).manual_seed(2222)
    images = {(s, d): torch.randn(s, generator=gen, device=dev, dtype=d)
              for s in {c[0] for c in cases(args.sweep)}
              for d in DTYPES}
    runs = []        # (key, kernel, call)
    for shape, dtype, H, W, by_rank in cases(args.sweep):
        x = images[shape, dtype]
        first = next(iter(by_rank.values()))[0][2]
        w = torch.as_tensor(first, dtype=dtype, device=dev)
        runs.append(((shape, dtype, H, W), "dense",
                     lambda x=x, w=w: c2.correlate2d_valid_cuda(x, w, "edge")))
        for r, group in by_rank.items():
            u, v = (torch.as_tensor(f, dtype=dtype, device=dev) for f in
                    c2._svd_stencil_np(group[0][2], _rank_rtol(dtype)))
            runs.append(((shape, dtype, H, W, r), "sep",
                         lambda x=x, u=u, v=v: c2.correlate2d_sep_cuda(
                             x, u, v, "edge")))
    for _, _, call in runs:            # build, load and check each launch
        call()
    torch.cuda.synchronize()
    times: dict = {}
    for order in (runs, runs[::-1]):
        for key, kernel, call in order:
            times.setdefault((key, kernel), []).append(
                device_ms(call, reps=15))
    lines, lost = [], []
    for shape, dtype, H, W, by_rank in cases(args.sweep):
        dense = times[(shape, dtype, H, W), "dense"]
        fill = _sep_fill(images[shape, dtype], H, W, "edge")
        for r, group in sorted(by_rank.items()):
            sep = times[(shape, dtype, H, W, r), "sep"]
            ratio = statistics.median(sep) / statistics.median(dense)
            pick = "sep" if _sep_cheaper(H, W, r, dtype, fill) else "dense"
            rec = {"card": name, "H": H, "W": W,
                   "dtype": str(dtype).removeprefix("torch."),
                   "image": list(shape), "fill": round(fill, 4), "rank": r,
                   "stencils": [[m, list(d)] for m, d, _ in group],
                   "instance": c2.sep_instance(H, W, r, dtype),
                   "dense_ms": dense, "sep_ms": sep,
                   "sep_over_dense": round(ratio, 4), "rule": pick}
            lines.append(json.dumps(rec))
            if (pick == "sep") != (ratio < 1):
                best, other = sorted((statistics.median(sep),
                                      statistics.median(dense)))
                lost.append({"H": H, "W": W, "rank": r,
                             "dtype": rec["dtype"], "image": list(shape),
                             "rule": pick, "lost_ms": round(other - best, 5),
                             "lost_share": round(other / best - 1, 4)})
    lines.append(json.dumps({"card": name, "cases": len(lines),
                             "rule_slower": lost}))
    print("\n".join(lines))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
