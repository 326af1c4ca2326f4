"""The port's masked 1D path (``savgol_tpu_torch.savgol_apply_masked``,
kernels K9 and K8b) against the JAX package's (``savgol_tpu.ops.masked``).

On the CPU every route of the port takes its plain version, and the tests
compare it with the JAX package's staged route (``method="xla"``) on the
same numpy data: n, m, d, dt, bool and float masks, the four boundaries,
``axis``, ``min_points``, ``fill`` and both solvers. Gates: f64 <= 1e-10 *
max(1, max|ref|) with identical finiteness; f32 <= 2e-5 * max(1, max|ref|)
on windows with >= 70% coverage (both sides are f32 normal equations, and a
hole-starved window amplifies their different Gram rounding by cond(A)^2,
as ``bench.py``'s masked gate says), identical finiteness everywhere. Also:
the host tables are bit-identical, the f64 lstsq oracle of
``tests/test_masked.py`` (<= 1e-9), and gradients against ``jax.grad`` of
the staged route (<= 1e-4 scaled, as ``tests/test_fused_masked.py``).

The tests marked ``cuda`` hold K9 and the ``qr`` route against the plain
staged version on the card, to the gates of ``tests/test_fused_masked.py``
(which the JAX package's fused kernel misses in two cases, fault R1):

    python -m pytest --noconftest -m cuda tests/test_torch_masked.py -q
"""

import math

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch.ops import cuda_masked as c9
from savgol_tpu_torch.ops.masked import _masked_tables

F64_TOL = 1e-10
F32_TOL = 2e-5


@pytest.fixture(scope="module")
def jm():
    """savgol_tpu.ops.masked; skips where JAX is not installed."""
    return pytest.importorskip("savgol_tpu.ops.masked")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _holed(rng, shape, frac=0.15, dtype=np.float64):
    x = rng.standard_normal(shape).astype(dtype)
    x[rng.random(shape) < frac] = np.nan
    return x


def _coverage(valid, n, axis=-1):
    """Valid samples in each window (truncate: outside counts as missing)."""
    v = np.moveaxis(np.asarray(valid, np.int64), axis, -1)
    c = np.apply_along_axis(
        lambda r: np.convolve(r, np.ones(2 * n + 1, np.int64), "same"), -1, v)
    return np.moveaxis(c, -1, axis)


def _compare(got, want, tol, where=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    sel = fin if where is None else fin & where
    if not sel.any():
        return
    scale = max(1.0, np.abs(want[sel]).max())
    err = np.abs(got[sel] - want[sel]).max()
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} * {scale:.3e}"


def _run_both(jm, x, mask=None, **kw):
    import jax.numpy as jnp
    want = np.asarray(jm.savgol_apply_masked(
        jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask),
        method="xla", **kw))
    got = sgt.savgol_apply_masked(
        torch.from_numpy(x),
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    return got.numpy(), want


def oracle_masked(xv, w, n, m, d, dt, mode=None):
    """Per-window weighted LS fit in f64 (numpy lstsq on the positive-weight
    samples, scaled by sqrt(w)); ``mode`` None is truncate, else numpy's pad
    mode for values and weights."""
    xv = np.asarray(xv, np.float64)
    w = np.asarray(w, np.float64)
    if mode is None:
        xpad = np.pad(np.where(w > 0, xv, 0.0), n)
        wpad = np.pad(w, n)
    else:
        xpad = np.pad(np.where(w > 0, xv, 0.0), n, mode=mode)
        wpad = np.pad(w, n, mode=mode)
    out = np.full(len(xv), np.nan)
    for p in range(len(xv)):
        js = np.arange(p, p + 2 * n + 1)
        js = js[wpad[js] > 0]
        if len(js) < m + 1:
            continue
        A = np.vander((js - (p + n)) * dt, m + 1, increasing=True)
        sw = np.sqrt(wpad[js])
        c, *_ = np.linalg.lstsq(A * sw[:, None], xpad[js] * sw, rcond=None)
        out[p] = c[d] * math.factorial(d)
    return out


# -- host tables ---------------------------------------------------------------


@pytest.mark.parametrize("n,m", [(1, 0), (2, 4), (5, 3), (12, 4), (32, 10)])
def test_tables_bit_identical(jm, n, m):
    for got, want in zip(_masked_tables(n, m), jm._masked_tables(n, m)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- against the JAX package's staged route -------------------------------------


@pytest.mark.parametrize("solver", ["normal", "qr"])
@pytest.mark.parametrize("boundary", ["truncate", "reflect", "periodic",
                                      "constant"])
@pytest.mark.parametrize("n,m,d,dt", [(3, 2, 0, 1.0), (6, 3, 1, 0.5),
                                      (12, 4, 2, 2.0)])
def test_matches_jax_f64(jm, solver, boundary, n, m, d, dt):
    rng = np.random.default_rng(n * 10 + d)
    x = _holed(rng, (2, 160))
    got, want = _run_both(jm, x, half_window=n, poly_order=m, derivative=d,
                          time_step=dt, boundary=boundary, solver=solver)
    _compare(got, want, F64_TOL)


@pytest.mark.parametrize("solver", ["normal", "qr"])
@pytest.mark.parametrize("boundary", ["truncate", "reflect"])
def test_weighted_matches_jax_f64(jm, solver, boundary):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 150))
    w = rng.uniform(0.1, 3.0, x.shape)
    w[rng.random(x.shape) < 0.2] = 0.0
    got, want = _run_both(jm, x, w, half_window=5, poly_order=3,
                          derivative=1, boundary=boundary, solver=solver)
    _compare(got, want, F64_TOL)


@pytest.mark.parametrize("solver", ["normal", "qr"])
@pytest.mark.parametrize("n,m,d", [(4, 2, 0), (8, 3, 1), (12, 4, 0)])
def test_matches_jax_f32(jm, solver, n, m, d):
    rng = np.random.default_rng(40 + n)
    x = _holed(rng, (3, 400), dtype=np.float32)
    got, want = _run_both(jm, x, half_window=n, poly_order=m, derivative=d,
                          solver=solver)
    well = _coverage(np.isfinite(x), n) >= 0.7 * (2 * n + 1)
    _compare(got, want, F32_TOL, where=well)


def test_axis_min_points_fill(jm):
    rng = np.random.default_rng(5)
    x = _holed(rng, (50, 3), frac=0.4)
    got, want = _run_both(jm, x, half_window=4, poly_order=2, axis=0,
                          min_points=6, fill=-123.0)
    _compare(got, want, F64_TOL)
    assert (got == -123.0).any() and np.isfinite(got).all()
    counts = _coverage(np.isfinite(x), 4, axis=0)
    np.testing.assert_array_equal(got == -123.0, counts < 6)


def test_bool_mask_overrides_isfinite(jm):
    rng = np.random.default_rng(6)
    x = rng.standard_normal(120)
    mask = rng.random(120) > 0.3
    got, want = _run_both(jm, x, mask, half_window=4, poly_order=2)
    _compare(got, want, F64_TOL)


def test_short_input_and_int_and_half(jm):
    import jax.numpy as jnp
    got, want = _run_both(jm, np.array([1.0, 2.0, 3.0, 4.0]),
                          half_window=5, poly_order=1)
    _compare(got, want, F64_TOL)
    xi = np.arange(40) % 7
    y = sgt.savgol_apply_masked(torch.from_numpy(xi), half_window=3,
                                poly_order=2)
    assert y.dtype == torch.float32
    yj = np.asarray(jm.savgol_apply_masked(jnp.asarray(xi), half_window=3,
                                           poly_order=2))
    _compare(y.numpy(), yj, 1e-6)
    xh = torch.from_numpy(np.linspace(-1, 1, 64)).to(torch.bfloat16)
    assert sgt.savgol_apply_masked(xh, half_window=3,
                                   poly_order=2).dtype == torch.bfloat16


# -- the f64 lstsq oracle ----------------------------------------------------------


@pytest.mark.parametrize("solver", ["normal", "qr"])
@pytest.mark.parametrize("n,m,d,dt,mode", [
    (3, 2, 0, 1.0, None), (6, 3, 1, 0.5, None), (8, 4, 2, 2.0, "symmetric"),
    (5, 3, 1, 1.0, "wrap"), (5, 3, 3, 1.0, "edge"),
])
def test_lstsq_oracle(solver, n, m, d, dt, mode):
    rng = np.random.default_rng(n * 100 + m * 10 + d)
    x = _holed(rng, 250)
    boundary = {None: "truncate", "symmetric": "reflect", "wrap": "periodic",
                "edge": "constant"}[mode]
    got = sgt.savgol_apply_masked(torch.from_numpy(x), half_window=n,
                                  poly_order=m, derivative=d, time_step=dt,
                                  boundary=boundary, solver=solver).numpy()
    want = oracle_masked(x, np.isfinite(x).astype(float), n, m, d, dt, mode)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("solver", ["normal", "qr"])
def test_weighted_lstsq_oracle(solver):
    rng = np.random.default_rng(51)
    x = rng.standard_normal(200)
    w = rng.random(200)
    w[rng.random(200) < 0.2] = 0.0
    got = sgt.savgol_apply_masked(torch.from_numpy(x), half_window=6,
                                  poly_order=3, derivative=1, time_step=0.5,
                                  mask=torch.from_numpy(w),
                                  solver=solver).numpy()
    want = oracle_masked(x, w, 6, 3, 1, 0.5)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-8, atol=1e-9)


# -- R2's counterpart: the fused route's values, not just finiteness ---------------


def test_fused_route_matches_twin_f32_values(jm):
    # bench-like data (tests/test_masked.py:469 asserts only isfinite)
    rng = np.random.default_rng(99)
    x = rng.standard_normal((4, 600)).astype(np.float32)
    mask = rng.random((4, 600)) > 0.2
    got, want = _run_both(jm, x, mask, half_window=12, poly_order=4,
                          fill=0.0)
    assert np.isfinite(got).all()
    well = _coverage(mask, 12) >= 18
    _compare(got, want, F32_TOL, where=well)


# -- gradients ------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_gradient_matches_jax(jm, weighted):
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 120))
    mask = rng.random(x.shape) > 0.2
    if weighted:
        mask = np.where(mask, rng.uniform(0.2, 2.0, x.shape), 0.0)
    kw = dict(half_window=6, poly_order=2, derivative=1, fill=0.0)

    def jloss(v):
        return jnp.sum(jm.savgol_apply_masked(
            v, mask=jnp.asarray(mask), method="xla", **kw) ** 2)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (sgt.savgol_apply_masked(xt, mask=torch.from_numpy(mask), **kw) ** 2
     ).sum().backward()
    scale = max(1.0, np.abs(want).max())
    assert np.abs(xt.grad.numpy() - want).max() <= 1e-4 * scale


# -- validation ----------------------------------------------------------------


def test_errors():
    x = torch.zeros(32)
    cases = [(dict(half_window=0, poly_order=0), "half_window"),
             (dict(half_window=2, poly_order=5), "poly_order"),
             (dict(half_window=3, poly_order=2, derivative=3), "derivative"),
             (dict(half_window=3, poly_order=2, time_step=0.0), "time_step"),
             (dict(half_window=3, poly_order=2, min_points=2), "min_points"),
             (dict(half_window=3, poly_order=2, boundary="polynomial"),
              "POLYNOMIAL"),
             (dict(half_window=3, poly_order=2, mask=torch.ones(31,
                                                                dtype=bool)),
              "mask shape"),
             (dict(half_window=3, poly_order=2, solver="svd"), "solver"),
             (dict(half_window=3, poly_order=2, method="pallas"), "method")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            sgt.savgol_apply_masked(x, **kw)
    with pytest.raises(NotImplementedError, match="complex"):
        sgt.savgol_apply_masked(torch.zeros(32, dtype=torch.complex64),
                                half_window=3, poly_order=2)


def test_cpu_routes_launch_nothing():
    c9.reset_launches()
    x = torch.from_numpy(_holed(np.random.default_rng(1), (2, 80)))
    sgt.savgol_apply_masked(x, half_window=4, poly_order=2)
    assert c9.LAUNCHES == {"masked1d": 0}


# -- K9 on the card -----------------------------------------------------------------


def _card_pair(dev, x, mask=None, **kw):
    """(K9 route, plain staged route) on the card, f64 host copies."""
    xt = torch.from_numpy(x).to(dev)
    mt = None if mask is None else torch.from_numpy(mask).to(dev)
    got = sgt.savgol_apply_masked(xt, mask=mt, **kw)
    want = sgt.savgol_apply_masked(xt, mask=mt, method="xla", **kw)
    torch.cuda.synchronize()
    return got.cpu().numpy(), want.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(8, 3, 1), (12, 4, 0), (4, 2, 2),
                                   (32, 6, 0)])
def test_cuda_k9_matches_staged(cuda, n, m, d):
    # tests/test_fused_masked.py::test_matches_staged, interior 2e-5
    rng = np.random.default_rng(n * 10 + d)
    x = _holed(rng, (3, 500 + n), dtype=np.float32)
    c9.reset_launches()
    got, want = _card_pair(cuda, x, half_window=n, poly_order=m,
                           derivative=d)
    assert c9.LAUNCHES["masked1d"] == 1
    interior = np.ones(x.shape, bool)
    interior[:, :2 * n] = interior[:, -2 * n:] = False
    _compare(got, want, F32_TOL, where=interior)


@pytest.mark.cuda
def test_cuda_k9_weighted(cuda):
    # tests/test_fused_masked.py::test_weighted (the JAX kernel: 1.29e-4)
    rng = np.random.default_rng(7)
    x = _holed(rng, (2, 400), dtype=np.float32)
    wts = np.where(np.isfinite(x), rng.uniform(0.2, 2.0, x.shape),
                   0.0).astype(np.float32)
    got, want = _card_pair(cuda, x, wts, half_window=6, poly_order=3)
    _compare(got, want, F32_TOL)


@pytest.mark.cuda
def test_cuda_k9_odd_length_partial_block(cuda):
    # tests/test_fused_masked.py::test_odd_length_partial_block (2.78e-4)
    rng = np.random.default_rng(13)
    x = _holed(rng, (1, 131), dtype=np.float32)
    got, want = _card_pair(cuda, x, half_window=4, poly_order=2)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.abs(got[fin] - want[fin]).max() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,frac,boundary", [(64, 3, 0.05, "truncate"),
                                               (2, 4, 0.05, "truncate"),
                                               (64, 40, 0.0, "reflect")])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_k9_any_order(cuda, n, m, frac, boundary, dtype):
    # m up to 2n, k past the local arrays (device scratch) at m = 40, on
    # windows >= 70% valid. A degree-40 fit over 129 samples gives the
    # window's end samples a leverage of ~1: one hole there (or a truncated
    # edge) leaves G singular for any solver, so that case runs hole-free
    # with every window whole
    rng = np.random.default_rng(n + m)
    x = _holed(rng, (2, 3 * n + 7), frac=frac).astype(dtype)
    got, want = _card_pair(cuda, x, half_window=n, poly_order=m, fill=0.0,
                           boundary=boundary)
    well = _coverage(np.isfinite(x), n) >= 0.7 * (2 * n + 1)
    tol = F32_TOL if dtype == np.float32 else (1e-8 if m > 10 else F64_TOL)
    _compare(got, want, tol, where=well)


# k = m + 1 from 1 to 8 on K9's compile-time instances (n = 12: the window
# fixed too), each boundary and weights; k = 9 and stencils past shared
# memory (n = 320 in f64) on the runtime instance, either side of the split
K9_INSTANCES = [(2, 0, 0, "truncate", False), (3, 1, 1, "constant", True),
                (4, 2, 2, "reflect", False), (5, 3, 1, "periodic", True),
                (12, 4, 0, "truncate", True), (12, 5, 1, "constant", False),
                (6, 6, 2, "reflect", True), (12, 7, 0, "periodic", False),
                (9, 7, 1, "truncate", True), (12, 8, 0, "reflect", False),
                (320, 7, 0, "reflect", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d,boundary,weighted", K9_INSTANCES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_k9_instances(cuda, n, m, d, boundary, weighted, dtype):
    # an odd length: the last block of 128 outputs is partial
    rng = np.random.default_rng(100 * n + m)
    x = _holed(rng, (2, 4 * n + 301), frac=0.12).astype(dtype)
    wts = None
    if weighted:
        wts = np.where(np.isfinite(x), rng.uniform(0.2, 2.0, x.shape),
                       0.0).astype(dtype)
    c9.reset_launches()
    got, want = _card_pair(cuda, x, wts, half_window=n, poly_order=m,
                           derivative=d, time_step=0.5, boundary=boundary)
    assert c9.LAUNCHES["masked1d"] == 1
    well = _coverage(np.isfinite(x), n) >= 0.7 * (2 * n + 1)
    _compare(got, want, F32_TOL if dtype == np.float32 else F64_TOL,
             where=well)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(4, 2), (6, 3), (12, 4)])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_k9_r1_gates_on_each_instance(cuda, n, m, weighted):
    # tests/test_fused_masked.py's two gates (test_weighted,
    # test_odd_length_partial_block), everywhere, with each data on each
    # of their windows and on the path's (n = 12: the window fixed too)
    rng = np.random.default_rng(7 if weighted else 13)
    x = _holed(rng, (2, 400) if weighted else (1, 131), dtype=np.float32)
    wts = None
    if weighted:
        wts = np.where(np.isfinite(x), rng.uniform(0.2, 2.0, x.shape),
                       0.0).astype(np.float32)
    got, want = _card_pair(cuda, x, wts, half_window=n, poly_order=m)
    if weighted:
        _compare(got, want, F32_TOL)
    else:
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        assert np.abs(got[fin] - want[fin]).max() <= 2e-5


@pytest.mark.cuda
def test_cuda_qr_and_fill(cuda):
    from savgol_tpu_torch.ops import cuda_solve as cs
    rng = np.random.default_rng(9)
    x = _holed(rng, (2, 300), frac=0.3, dtype=np.float32)
    cs.reset_launches()
    got, want = _card_pair(cuda, x, half_window=8, poly_order=4,
                           solver="qr", fill=-5.0)
    assert cs.LAUNCHES["plane_solve_dd"] == 1
    _compare(got, want, 5e-5)


@pytest.mark.cuda
def test_cuda_k9_refuses_what_shared_memory_cannot_hold(cuda):
    x = torch.zeros(1, 40_000, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        sgt.savgol_apply_masked(x, half_window=15_000, poly_order=1)
