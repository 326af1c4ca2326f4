"""The bf16-storage cell's own pieces: its plain reference
(``references/sg1d_bf16.py``) against a numpy statement of the filter,
its refusals (the control, an output off by 1e-2, an output in another
dtype), its per-layer reader (``roofline.sg1d_bf16``) on stand-in traces
whatever the operations are named, and its function bound."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench import harness, layout, roofline
from gpubench.tests.conftest import ROOT, small
from gpubench.tests.test_gpubench_readers import ctx, stand_in

CFG = layout.config("sg1d_n12m4_bf16")
REF = layout.reference("sg1d_bf16")
READER = layout.layer_metrics()["roofline.sg1d_bf16"]
CPU = torch.device("cpu")
CELL = "sg1d-bf16-bulk"


def test_the_reference_loads_nothing_of_the_port():
    code = ("from gpubench import layout\n"
            "layout.reference('sg1d_bf16')\n"
            "import sys, json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"savgol_tpu_torch", "savgol_tpu", "jax", "jaxlib"}
    assert "torch" in loaded


def lsq_1d(x: np.ndarray, n: int, m: int) -> np.ndarray:
    """Each output the degree-m least-squares fit's value at its sample,
    over the window centred on it, or the first / last window for the n
    samples at each end (MATLAB sgolayfilt)."""
    N, ws = len(x), 2 * n + 1
    out = np.empty(N)
    for j in range(N):
        lo = min(max(j - n, 0), N - ws)
        t = np.arange(lo, lo + ws, dtype=np.float64) - j
        out[j] = np.polynomial.polynomial.polyfit(t, x[lo:lo + ws], m)[0]
    return out


@pytest.mark.parametrize("N", [25, 26, 61])
def test_the_reference_is_the_least_squares_filter_of_the_bf16_samples(N):
    x = REF.make_data((3, N), CFG, 2 ** 31 + N, CPU)
    assert x.dtype == torch.bfloat16
    y = torch.as_tensor(np.stack([lsq_1d(r, 12, 4)
                                  for r in x.double().numpy()]))
    # the numpy statement's outputs rounded to bf16 are within half a
    # bf16 ulp of the reference's, so they read as the program would
    numbers = REF.compare([(x, y.to(torch.bfloat16))], CFG)
    assert max(numbers["edge_scaled_err"],
               numbers["interior_scaled_err"]) <= 2.0 ** -8
    P = torch.as_tensor(REF.projection(CFG))
    want = layout.reference("sg1d")._apply(x, P, 12)
    np.testing.assert_allclose(want.numpy(), y.numpy(), rtol=0, atol=1e-12)


def _run(fault):
    cell = small(CELL)
    program = cell.entry.make(cell.config, CPU)

    def call(x):
        if fault == "control":
            return REF.control(REF.control_state(cell.config, CPU), x,
                               cell.config)
        y = cell.entry.call(program, x)
        if fault == "off_by_1e-2":
            y[1, 2000] += 1e-2
        elif fault == "float32_out":
            y = y.float()
        return y
    return harness.run(cell, 2 ** 31 + 29, 0.05, False, CPU, call=call,
                       emit=lambda obj: None)


@pytest.mark.parametrize("fault", [None, "control", "off_by_1e-2",
                                   "float32_out"])
def test_correct_only_for_the_sound_program(fault, capsys):
    r = _run(fault)
    assert r["correct"] is (fault is None), r["check"]
    json.loads(json.dumps(r, allow_nan=False))
    assert set(r["check"]) == {"edge_scaled_err", "interior_scaled_err"}
    if fault == "off_by_1e-2":
        assert r["check"]["interior_scaled_err"]["value"] > 5e-3
        assert r["check"]["edge_scaled_err"]["value"] <= 5e-3
    capsys.readouterr()


@pytest.mark.parametrize("renamed", [("a", "b", "c"),
                                     ("sg1d_bf16_kernel", "copy", "cast")])
def test_the_roofline_reads_the_same_whatever_the_ops_are_named(renamed):
    base = READER.read(ctx(stand_in(), function="sg1d_bf16"))
    other = READER.read(ctx(stand_in(names=renamed), function="sg1d_bf16"))
    assert base == pytest.approx(100 * 300 / 404)
    assert other == pytest.approx(base)
    assert READER.read(ctx(stand_in(), function="sg1d")) is None


def test_the_bound_is_two_bytes_a_sample_each_way_and_bytes_bind():
    cell = harness.Cell.load(CELL, with_entry=False)
    assert cell.call_shape == (512, 1 << 20)
    nbytes, ops = REF.bound(cell.config, cell.call_shape)
    assert nbytes == 2 * 2 * 512 * 2 ** 20
    assert ops == 2 * 25 * 512 * 2 ** 20
    assert roofline.bound_s(nbytes, ops) == pytest.approx(0.641e-3, rel=1e-3)
    assert nbytes / roofline.HBM_BYTES_PER_S > ops / roofline.F32_FLOPS_PER_S
    assert math.prod(cell.workload["resident"]) * 2 == 16 * 2 ** 30
