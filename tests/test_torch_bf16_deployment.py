"""The bf16-storage deployment (``gpubench/configs/sg1d_n12m4_bf16.json``):
``Savgol1D(12, 4).apply(x, method="bf16")`` on a bf16 recording against
the benchmark's plain reference (``gpubench/references/sg1d_bf16.py``)
within the configuration's limits, the reference's control refused by
them, the reference against a numpy least-squares statement of the
filter, its inputs made a block of rows at a time, and
``ops.cuda_conv.ROUNDED``'s counts.

On the CPU the port runs K1-bf16's plain version, whose arithmetic is the
kernel's (bf16 samples and taps, exact products summed in f32, outputs
rounded to bf16); the card runs the same comparison at the cell's size in
every benchmark run."""

import contextlib
import types

import numpy as np
import pytest
import torch

from gpubench import layout
from savgol_tpu_torch.ops import cuda_conv as cc

CFG = layout.config("sg1d_n12m4_bf16")
REF = layout.reference("sg1d_bf16")
ENTRY = layout.entry("sg1d_n12m4_bf16")
CPU = torch.device("cpu")
SEEDS = range(5)
SHAPES = [(4, 4096), (3, 25), (2, 12289)]      # (3, 25): N equal to ws


@pytest.fixture(scope="module")
def program():
    return ENTRY.make(CFG, CPU)


def _passes(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in CFG["limits"].items())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_bf16_apply_meets_the_deployments_limits(program, seed, shape):
    x = REF.make_data(shape, CFG, seed, CPU)
    y = ENTRY.call(program, x)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    numbers = REF.compare([(x, y)], CFG)
    assert _passes(numbers), numbers
    assert numbers["outputs_compared"] == x.numel()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_the_limits_on_the_same_data(seed, shape):
    x = REF.make_data(shape, CFG, seed, CPU)
    y = REF.control(REF.control_state(CFG, CPU), x, CFG)
    assert y.dtype == torch.bfloat16
    assert not _passes(REF.compare([(x, y)], CFG))


def lsq_1d(x: np.ndarray, n: int, m: int) -> np.ndarray:
    """Each output the degree-m least-squares fit's value at its sample,
    over the window centred on it, or the first / last window for the n
    samples at each end, by numpy's least-squares fit (``polyfit``:
    ``numpy.linalg.lstsq`` on the scaled Vandermonde matrix)."""
    N, ws = len(x), 2 * n + 1
    out = np.empty(N)
    for j in range(N):
        lo = min(max(j - n, 0), N - ws)
        t = np.arange(lo, lo + ws, dtype=np.float64) - j
        out[j] = np.polynomial.polynomial.polyfit(t, x[lo:lo + ws], m)[0]
    return out


def test_the_reference_is_the_least_squares_filter_of_the_bf16_samples():
    x = REF.make_data((3, 61), CFG, 2 ** 31 + 7, CPU)
    P = torch.as_tensor(REF.projection(CFG))
    got = layout.reference("sg1d")._apply(x, P, 12).numpy()
    want = np.stack([lsq_1d(row, 12, 4) for row in x.double().numpy()])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_make_data_is_bf16_made_a_block_of_rows_at_a_time(monkeypatch):
    blocks = []
    rows = REF._rows

    def recorded(*args):
        out = rows(*args)
        blocks.append(out)
        return out
    monkeypatch.setattr(REF, "BLOCK_ROWS", 3)
    monkeypatch.setattr(REF, "_rows", recorded)
    x = REF.make_data((8, 100), CFG, 2 ** 31 + 3, CPU)
    assert x.dtype == torch.bfloat16 and x.shape == (8, 100)
    assert [b.shape[0] for b in blocks] == [3, 3, 2]
    assert all(b.dtype == torch.float32 for b in blocks)
    assert torch.equal(x, torch.cat(blocks).to(torch.bfloat16))
    again = REF.make_data((8, 100), CFG, 2 ** 31 + 3, CPU)
    assert torch.equal(x, again)


class _Library:
    """A stand-in for the kernel library: every entry succeeds at once."""

    def __getattr__(self, symbol):
        return lambda *args: 0


@pytest.fixture
def kernel_route(monkeypatch):
    """CPU tensors take the kernels' route to the stand-in library."""
    monkeypatch.setattr(cc, "library", _Library)
    monkeypatch.setattr(cc, "_plain_or_cuda", lambda x, name: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))


def _rounded(call) -> dict:
    before = dict(cc.ROUNDED)
    call()
    return {k: cc.ROUNDED[k] - before[k] for k in before}


def test_a_bf16_storage_call_rounds_two_tap_tensors_and_no_storage(
        program):
    # on the kernel route too: tests/test_torch_tracing.py
    x = REF.make_data((2, 300), CFG, 11, CPU)
    assert _rounded(lambda: ENTRY.call(program, x)) == {"taps": 2,
                                                        "storage": 0}


def test_an_f64_call_on_the_kernel_route_rounds_its_storage(program,
                                                            kernel_route):
    x = torch.randn(2, 300, dtype=torch.float64)
    got = _rounded(lambda: program.apply(x, method="bf16"))
    assert got == {"taps": 2, "storage": 1}


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_the_exact_route_rounds_nothing(program, request, route):
    if route == "kernel":
        request.getfixturevalue("kernel_route")
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        x = torch.randn(2, 300).to(dtype)
        assert _rounded(lambda: program.apply(x)) == {"taps": 0,
                                                      "storage": 0}
