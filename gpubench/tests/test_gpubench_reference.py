"""The plain references against a NumPy least-squares statement of each
filter, output by output, edges and the 2D CONSTANT border included, and
against the port's CPU plain versions; the function bounds at the cells'
shapes."""

import itertools

import numpy as np
import pytest
import torch

from gpubench import harness, layout, roofline
from gpubench.tests.conftest import CELLS, small

SG1D = layout.config("sg1d_n12m4_f32")
SG2D = layout.config("sg2d_11x11o3_f32")
REF1 = layout.reference("sg1d")
REF2 = layout.reference("sg2d")


def lsq_1d(x: np.ndarray, n: int, m: int) -> np.ndarray:
    """Each output the degree-m least-squares fit's value at its sample:
    over the window centred on it, or over the first / last window for the
    n samples at each end (MATLAB sgolayfilt)."""
    N, ws = len(x), 2 * n + 1
    out = np.empty(N)
    for j in range(N):
        lo = min(max(j - n, 0), N - ws)
        t = np.arange(lo, lo + ws, dtype=np.float64)
        c = np.polynomial.polynomial.polyfit(t - j, x[lo:lo + ws], m)
        out[j] = c[0]
    return out


def lsq_2d(img: np.ndarray, nx: int, ny: int, order: int) -> np.ndarray:
    """Each pixel the constant term of the total-degree-``order`` fit over
    its window of the image padded by its edge pixels."""
    R, C = img.shape
    p = np.pad(img, ((ny, ny), (nx, nx)), mode="edge")
    X, Y = np.meshgrid(np.arange(-nx, nx + 1.0), np.arange(-ny, ny + 1.0))
    A = np.stack([X.ravel() ** i * Y.ravel() ** (t - i)
                  for t in range(order + 1) for i in range(t + 1)], 1)
    out = np.empty((R, C))
    for r, c in itertools.product(range(R), range(C)):
        win = p[r:r + 2 * ny + 1, c:c + 2 * nx + 1].ravel()
        out[r, c] = np.linalg.lstsq(A, win, rcond=None)[0][0]
    return out


def test_sg1d_reference_is_the_least_squares_filter_at_every_output():
    x = np.random.default_rng(1).standard_normal((3, 61))
    got = REF1._apply(torch.from_numpy(x),
                      torch.from_numpy(REF1.projection(SG1D)), 12).numpy()
    want = np.stack([lsq_1d(row, 12, 4) for row in x])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_sg2d_reference_is_the_least_squares_filter_with_edge_pixels():
    img = np.random.default_rng(2).standard_normal((2, 15, 18))
    got = REF2._apply(torch.from_numpy(img),
                      torch.from_numpy(REF2.stencil(SG2D))).numpy()
    want = np.stack([lsq_2d(f, 5, 5, 3) for f in img])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", CELLS)
def test_port_plain_versions_agree_with_the_reference(name):
    cell = small(name)
    program = cell.entry.make(cell.config, torch.device("cpu"))
    x = cell.reference.make_data(tuple(cell.workload["resident"]),
                                 cell.config, 5, torch.device("cpu"))
    numbers = cell.reference.compare([(x, cell.entry.call(program, x))],
                                     cell.config)
    for key, lim in cell.config["limits"].items():
        assert numbers[key] <= lim / 2, (key, numbers[key])


def test_2d_rank_and_bounds_at_the_cells_shapes():
    assert REF2.rank(REF2.stencil(SG2D)) == 2   # a + b x^2 + b y^2
    b1 = roofline.bound_s(*REF1.bound(SG1D, (128, 1 << 20)))
    b2 = roofline.bound_s(*REF2.bound(SG2D, (16, 2048, 2048)))
    assert b1 == pytest.approx(0.3205e-3, rel=1e-3)
    assert b2 == pytest.approx(0.1603e-3, rel=1e-3)
    # the bytes bind in every cell, so no implementation reads over 100%
    for name in CELLS:
        cell = harness.Cell.load(name, with_entry=False)
        nbytes, flops = cell.reference.bound(cell.config, cell.call_shape)
        assert nbytes / roofline.HBM_BYTES_PER_S > \
            flops / roofline.F32_FLOPS_PER_S


def test_tf32_rounds_to_ten_mantissa_bits():
    # a half ulp rounds away from zero, a quarter down; a value that has
    # only 10 bits stays
    from gpubench import numerics
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                      -3.0 - 2.0 ** -9, 1.0 + 2.0 ** -12])
    got = numerics.tf32(x)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -3.0 - 2.0 ** -9, 1.0])
    assert torch.equal(got, want)
