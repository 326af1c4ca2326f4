"""The readings the limits of ``correct`` are set from, on the card, at a
cell's own size and load::

    python3 -m gpubench.control --workload <cell> --seconds 2 \\
        --seeds 11 12 ... --control-seeds 21 22 23

In one process: for each of ``--seeds`` a short run of the program, and
for each of ``--control-seeds`` a short run with the control in the
program's place: the configuration's reference computed one precision
below the one the configuration states (``references/<function>.py::
control``: TF32 for float32 with TF32 off). One JSON line a run with each
compared number, then a summary: the largest reading of each number over
the program's seeds (the lower reading) and the smallest over the
control's (the upper). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from gpubench import harness


def readings(cell: harness.Cell, seeds, seconds: float, device, *,
             control: bool) -> list[dict]:
    """One record a seed: the run's check numbers and ``correct``."""
    import torch
    out = []
    for seed in seeds:
        call = None
        if control:
            ref, cfg = cell.reference, cell.config
            state = ref.control_state(cfg, device)

            def call(x, state=state):
                return ref.control(state, x, cfg)
        r = harness.run(cell, seed, seconds, False, device, call=call,
                        emit=lambda obj: None)
        rec = {"side": "control" if control else "program", "seed": seed,
               "correct": r["correct"], "calls": r["attempted"],
               "check": {k: v["value"] for k, v in r["check"].items()}}
        print(json.dumps(rec), flush=True)
        out.append(rec)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gpubench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = harness.Cell.load(args.workload)
    prog = readings(cell, args.seeds, args.seconds, device, control=False)
    ctrl = readings(cell, args.control_seeds, args.seconds, device,
                    control=True)
    names = cell.config["limits"]
    summary = {name: {
        "lower": max((r["check"][name] for r in prog), default=None),
        "upper": min((r["check"][name] for r in ctrl), default=None),
        "limit": lim} for name, lim in names.items()}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "program_all_correct": all(r["correct"] for r in prog),
                      "control_all_refused": not any(r["correct"]
                                                     for r in ctrl),
                      "kind": torch.cuda.get_device_name(device)}))
    return 0 if not harness.forbidden_modules() else 3


if __name__ == "__main__":
    sys.exit(main())
