"""Run one cell of the benchmark on the card this process finds::

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the run's result, one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``; with
``--trace 1`` also ``breakdown``; last, ``check``: each number compared
with the reference beside its limit, which are also the last lines of
standard error). Earlier lines give the window's call count and latency
quantiles, the card's clocks and, traced, the trace's summary. With
``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones. The run exits 2 and prints no result
where the card is missing, and 3 where a module of JAX or of the JAX
package ``savgol_tpu`` has been loaded.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

# set-up's steps on CLOCK_BOOTTIME, from the interpreter's first line here
STAMPS = {"interpreter_up": time.clock_gettime(time.CLOCK_BOOTTIME)}

# Python's bytecode of torch, the port and the benchmark is cached at a
# fixed path in the checkout, as the port's library is, so that only the
# first run compiles it; where the environment turns the writing of
# bytecode off (PYTHONDONTWRITEBYTECODE), every run would compile torch's
# ~2,100 modules again (8-9 s on an H100 host, the most of set-up).
sys.pycache_prefix = str(pathlib.Path(__file__).resolve().parents[1]
                         / "build" / "pycache")
sys.dont_write_bytecode = False

from gpubench import harness  # noqa: E402  (imports torch)

STAMPS["torch_imported"] = harness.boottime()
STARTED = harness.process_start()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    cell = harness.Cell.load(args.workload)
    STAMPS["port_imported"] = harness.boottime()
    chips = cell.workload.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: cell {args.workload} needs {chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    STAMPS["cuda_found"] = harness.boottime()
    torch.empty(1, device=device)           # the context, timed on its own
    STAMPS["context_made"] = harness.boottime()

    def emit(obj):
        print(json.dumps(obj), flush=True)

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, started=STARTED, stamps=STAMPS, emit=emit)
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: loaded {', '.join(found)}, which the benchmark "
              "must not run", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
