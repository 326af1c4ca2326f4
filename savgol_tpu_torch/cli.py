"""Coefficient-export CLI (counterpart of ``savgol_tpu.cli``), with no JAX.

Same flags and exit codes as the reference tool
(src/savgol_export.c:48-124):

    python -m savgol_tpu_torch.cli -n <half_window> -m <poly_order>
                                   [-d <derivative>] [-o <out.h>]
                                   [-p <prefix>]
"""

from __future__ import annotations

import argparse
import sys

from savgol_tpu_torch.config import MAX_HALF_WINDOW, SavgolConfig
from savgol_tpu_torch.utils.export import generate_header


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="savgol-export",
        description="Export Savitzky-Golay filter coefficients as a C "
                    "header.",
        epilog="Examples:\n"
               "  savgol-export -n 5 -m 2                  "
               "# 11-point quadratic smoother to stdout\n"
               "  savgol-export -n 10 -m 3 -d 1 -o deriv.h "
               "# first-derivative filter\n",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-n", "--half-window", type=int, required=True,
                   help=f"Half-window size (1-{MAX_HALF_WINDOW})")
    p.add_argument("-m", "--poly-order", type=int, required=True,
                   help="Polynomial order (< 2N+1)")
    p.add_argument("-d", "--derivative", type=int, default=0,
                   help="Derivative order (default: 0)")
    p.add_argument("-o", "--output", default=None,
                   help="Output file (default: stdout)")
    p.add_argument("-p", "--prefix", default="SAVGOL",
                   help="Symbol prefix (default: SAVGOL)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        cfg = SavgolConfig(half_window=args.half_window,
                           poly_order=args.poly_order,
                           derivative=args.derivative)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    header = generate_header(cfg, prefix=args.prefix)

    if args.output:
        with open(args.output, "w") as fh:
            fh.write(header)
        print(f"Generated: {args.output}", file=sys.stderr)
        print(f"  half_window = {cfg.half_window}", file=sys.stderr)
        print(f"  poly_order  = {cfg.poly_order}", file=sys.stderr)
        print(f"  derivative  = {cfg.derivative}", file=sys.stderr)
        print(f"  window_size = {cfg.window_size}", file=sys.stderr)
    else:
        sys.stdout.write(header)
    return 0


if __name__ == "__main__":
    sys.exit(main())
