"""Fixtures of the benchmark's own tests: cells cut to a size the CPU
runs in a moment (the port takes its plain versions for CPU tensors), and
the card for the tests marked ``cuda``."""

import json
import pathlib

import pytest
import torch

from gpubench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SMALL = {1: ([8, 4096], 2), 2: ([4, 40, 56], 2)}


def small(name: str) -> harness.Cell:
    """Cell ``name`` at a CPU size: its resident data and calls cut, its
    traffic, configuration and reference as they are."""
    cell = harness.Cell.load(name)
    kind = len(cell.workload["resident"]) - 1
    resident, per_call = SMALL[kind]
    cell.workload.update(resident=resident, per_call=per_call,
                         warmup_calls=2)
    return cell


@pytest.fixture
def card() -> torch.device:
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
