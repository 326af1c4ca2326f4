"""The port's masked 2D path (``savgol_tpu_torch.savgol2d_apply_masked``,
kernels K10, K2D-dense and K8a) against the JAX package's
(``savgol_tpu.ops.masked``, ``savgol_tpu.ops.pallas_masked2d``).

On the CPU every route of the port takes its plain staged version (the
joint-basis bank correlations and the plain plane solve), and the tests
compare it with the JAX package's staged route (``method="xla"``) on the
same numpy data: square and rectangular windows, ``deriv_x`` / ``deriv_y``,
the steps, bool and float masks, the four boundaries, under-quorum pixels
and degenerate valid sets (``rcond``), and a configuration outside
``fused2d_supported``. Gates: f64 <= 1e-10 * max(1, max|ref|) with
identical finiteness; f32 <= 2e-5 * max(1, max|ref|) on windows with >= 70%
coverage, identical finiteness everywhere. Also: the host tables (joint
and tensor-moment) are bit-identical, the ``comb`` reconstruction of every
pair stencil is exact to 1e-10, the f64 lstsq oracle, and gradients against
``jax.vjp`` of the staged route (<= 1e-4 scaled).

The tests marked ``cuda`` hold K10 and the staged kernel route against the
f64 plain version on the card, to the gates of
``tests/test_masked2d_fused.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_masked2d.py -q
"""

import math

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch.ops import cuda_masked2d as c10
from savgol_tpu_torch.ops.masked import _masked_tables_2d

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


def _holed(rng, shape, frac=0.12, dtype=np.float64):
    x = rng.standard_normal(shape).astype(dtype)
    x[rng.random(shape) < frac] = np.nan
    return x


def _coverage(valid, nx, ny):
    """Valid pixels in each window, outside the image counting as missing."""
    v = np.asarray(valid, np.int64)
    pad = [(0, 0)] * (v.ndim - 2) + [(ny, ny), (nx, nx)]
    c = np.cumsum(np.cumsum(np.pad(v, pad), -1), -2)
    c = np.pad(c, [(0, 0)] * (v.ndim - 2) + [(1, 0), (1, 0)])
    wy, wx = 2 * ny + 1, 2 * nx + 1
    return (c[..., wy:, wx:] - c[..., :-wy, wx:] - c[..., wy:, :-wx]
            + c[..., :-wy, :-wx])


def _identifiable(valid, nx, ny, m):
    """Pixels whose valid window samples (truncate boundary) determine every
    term of the order-m fit: the design has full column rank. Elsewhere the
    rcond rule compares a Cholesky diagonal of rounding noise with its
    threshold, and two correct implementations may decide differently."""
    monos = [(i, t - i) for t in range(m + 1) for i in range(t + 1)]
    v = np.asarray(valid, bool)
    pad = [(0, 0)] * (v.ndim - 2) + [(ny, ny), (nx, nx)]
    vp = np.pad(v, pad)
    out = np.zeros(v.shape, bool)
    for idx in np.ndindex(v.shape):
        *b, r, c = idx
        ys, xs = np.nonzero(vp[(*b, slice(r, r + 2 * ny + 1),
                                slice(c, c + 2 * nx + 1))])
        A = np.stack([(xs - nx) ** i * (ys - ny) ** j for i, j in monos], 1)
        out[idx] = np.linalg.matrix_rank(A.astype(np.float64)) == len(monos)
    return out


def _compare(got, want, tol, where=None, decided=None):
    """Identical finiteness (on the ``decided`` pixels, all by default) and
    values within ``tol * max(1, max|want|)`` on the finite ``where``
    pixels."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    if decided is None:
        decided = np.ones(fin.shape, bool)
    np.testing.assert_array_equal(np.isfinite(got)[decided], fin[decided])
    sel = fin & decided if where is None else fin & decided & where
    if not sel.any():
        return
    scale = max(1.0, np.abs(want[sel]).max())
    err = np.abs(got[sel] - want[sel]).max()
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} * {scale:.3e}"


def _run_both(jm, x, mask=None, method="auto", **kw):
    import jax.numpy as jnp
    want = np.asarray(jm.savgol2d_apply_masked(
        jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask),
        method="xla", **kw))
    got = sgt.savgol2d_apply_masked(
        torch.from_numpy(x),
        mask=None if mask is None else torch.from_numpy(mask),
        method=method, **kw)
    return got.numpy(), want


# -- host tables ---------------------------------------------------------------

TABLE_CASES = [(1, 1, 0), (2, 2, 2), (3, 2, 3), (5, 5, 3), (3, 6, 4),
               (11, 11, 6)]


@pytest.mark.parametrize("nx,ny,m", TABLE_CASES)
def test_joint_tables_bit_identical(jm, nx, ny, m):
    got, want = _masked_tables_2d(nx, ny, m), jm._masked_tables_2d(nx, ny, m)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]


@pytest.mark.parametrize("nx,ny,m", TABLE_CASES)
def test_tensor_tables_bit_identical(nx, ny, m):
    jp = pytest.importorskip("savgol_tpu.ops.pallas_masked2d")
    got, want = c10.tensor_tables_2d(nx, ny, m), jp.tensor_tables_2d(nx, ny, m)
    assert got.keys() == want.keys()
    for key in got:
        if isinstance(got[key], np.ndarray):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key]
    for dx, dy in [(0, 0), (1, 0), (0, min(m, 2)), (min(m, 1), min(m, 1))]:
        if dx + dy > m:
            continue
        np.testing.assert_array_equal(
            c10._extract_row(got, dx, dy, 0.5, 2.0, nx, ny),
            jp._extract_row(want, dx, dy, 0.5, 2.0, nx, ny))


@pytest.mark.parametrize("nx,ny,m", TABLE_CASES)
def test_comb_reconstructs_every_pair_stencil(nx, ny, m):
    # B_a B_b = sum_mi comb[k, mi] phi_s(x) psi_t(y), exactly (host f64)
    t = c10.tensor_tables_2d(nx, ny, m)
    phx, phy, basis = t["PhiX"], t["PhiY"], t["basis"]
    mom = np.stack([np.outer(phy[:, tt], phx[:, s]) for s, tt in t["moments"]])
    for a, (i, j) in enumerate(basis):
        for b in range(a, len(basis)):
            k, l = basis[b]
            pair = np.outer(phy[:, j] * phy[:, l], phx[:, i] * phx[:, k])
            rec = np.tensordot(t["comb"][t["pair_index"][a, b]], mom, 1)
            assert np.abs(rec - pair).max() <= 1e-10


@pytest.mark.parametrize("nx,ny,m", TABLE_CASES)
def test_kernel_tables_by_moment_sum_as_by_row(nx, ny, m):
    # K10's tables: the comb entries the kernels read (those past
    # _COMB_ZERO) still rebuild every pair stencil; the by-moment copy holds
    # the same entries, and scattering each moment into the Gram in moment
    # order (the compile-time instances) gives the by-row sums (the runtime
    # instance) bit for bit
    ftab, itab, (P, Sx, Sy, M, nnz) = c10._kernel_tables(
        nx, ny, m, 0, 0, 1.0, 1.0, torch.device("cpu"))
    f, i = ftab.numpy(), itab.numpy()
    t = c10.tensor_tables_2d(nx, ny, m)
    kp, wx, wy = P * (P + 1) // 2, 2 * nx + 1, 2 * ny + 1
    base = 2 * M + 2 * P
    coff, cidx = i[base:base + kp + 1], i[base + kp + 1:base + kp + 1 + nnz]
    moff, crow = i[base + kp + 1 + nnz:-nnz], i[-nnz:]
    by_row = f[Sx * wx + Sy * wy:Sx * wx + Sy * wy + nnz]
    by_moment = f[-nnz:]
    assert len(moff) == M + 1 and coff[-1] == moff[-1] == nnz
    dense = np.zeros((kp, M))
    for e in range(kp):
        dense[e, cidx[coff[e]:coff[e + 1]]] = by_row[coff[e]:coff[e + 1]]
    kept = np.abs(t["comb"]) > c10._COMB_ZERO
    order = [t["pair_index"][a, b] for a in range(P) for b in range(a + 1)]
    np.testing.assert_array_equal(dense, np.where(kept, t["comb"], 0)[order])
    assert np.abs(np.where(kept, 0, t["comb"])).max() <= c10._COMB_ZERO
    moments = np.random.default_rng(nx + 10 * m).standard_normal(M) * 50
    gather = np.zeros(kp)
    for e in range(kp):
        for q in range(coff[e], coff[e + 1]):
            gather[e] = gather[e] + by_row[q] * moments[cidx[q]]
    scatter = np.zeros(kp)
    for mi in range(M):
        for q in range(moff[mi], moff[mi + 1]):
            scatter[crow[q]] = scatter[crow[q]] + by_moment[q] * moments[mi]
    np.testing.assert_array_equal(scatter, gather)


def test_fused2d_supported_matches_jax():
    jp = pytest.importorskip("savgol_tpu.ops.pallas_masked2d")
    for nx in range(1, 5):
        for ny in range(1, 5):
            for m in range(7):
                assert (c10.fused2d_supported(nx, ny, m)
                        == jp.fused2d_supported(nx, ny, m))
    with pytest.raises(ValueError, match="tensor basis"):
        c10.tensor_tables_2d(1, 5, 3)


# -- against the JAX package's staged route -------------------------------------

CONFIGS = [  # nx, ny, m, dx, dy, delta_x, delta_y
    (2, 2, 2, 0, 0, 1.0, 1.0),
    (3, 2, 3, 1, 0, 0.5, 1.0),
    (2, 3, 3, 0, 2, 1.0, 2.0),
    (3, 3, 4, 1, 1, 0.25, 0.5),
    (1, 5, 3, 0, 1, 1.0, 1.0),          # outside fused2d_supported
]


@pytest.mark.parametrize("boundary", ["truncate", "constant", "reflect",
                                      "periodic"])
@pytest.mark.parametrize("cfg", CONFIGS)
def test_matches_jax_f64(jm, boundary, cfg):
    nx, ny, m, dx, dy, ddx, ddy = cfg
    rng = np.random.default_rng(nx * 100 + ny * 10 + m)
    x = _holed(rng, (2, 22, 26))
    got, want = _run_both(jm, x, half_window_x=nx, half_window_y=ny,
                          poly_order=m, deriv_x=dx, deriv_y=dy, delta_x=ddx,
                          delta_y=ddy, boundary=boundary)
    decided = (_identifiable(np.isfinite(x), nx, ny, m)
               if boundary == "truncate" else None)
    _compare(got, want, F64_TOL, decided=decided)


@pytest.mark.parametrize("method", ["auto", "xla"])
@pytest.mark.parametrize("boundary", ["truncate", "reflect"])
def test_weighted_matches_jax_f64(jm, method, boundary):
    rng = np.random.default_rng(61)
    x = rng.standard_normal((22, 24))
    w = rng.uniform(0.1, 2.0, x.shape)
    w[rng.random(x.shape) < 0.2] = 0.0
    got, want = _run_both(jm, x, w, method=method, half_window_x=2,
                          half_window_y=3, poly_order=2, deriv_x=1,
                          boundary=boundary)
    _compare(got, want, F64_TOL)


@pytest.mark.parametrize("cfg", [(2, 2, 2, 0, 0), (5, 5, 3, 0, 0),
                                 (3, 2, 3, 1, 0), (1, 5, 3, 0, 1)])
def test_matches_jax_f32(jm, cfg):
    nx, ny, m, dx, dy = cfg
    rng = np.random.default_rng(70 + nx + ny)
    x = _holed(rng, (2, 30, 40), dtype=np.float32)
    got, want = _run_both(jm, x, half_window_x=nx, half_window_y=ny,
                          poly_order=m, deriv_x=dx, deriv_y=dy)
    well = _coverage(np.isfinite(x), nx, ny) >= 0.7 * (2 * nx + 1) * (
        2 * ny + 1)
    _compare(got, want, F32_TOL, where=well)


def test_degenerate_valid_sets_fill(jm):
    # valid pixels on one row: quorate, but y-dependence is unidentifiable;
    # the rcond rule fills every pixel, with and without an explicit rcond
    x = np.full((20, 20), np.nan)
    x[10, :] = np.linspace(0.0, 1.0, 20)
    for rcond in (None, 1e-9):
        got, want = _run_both(jm, x, half_window_x=3, half_window_y=3,
                              poly_order=2, min_points=6, rcond=rcond)
        _compare(got, want, F64_TOL)
        assert np.isnan(got).all()
    # three rows of data make y-degree 2 identifiable; each window is then
    # exactly determined in y, cond(G) ~ 1e12, and the two packages' bank
    # correlations (different summation orders) agree to that class only
    x[8, :] = 0.5
    x[12, :] = 0.25
    got, want = _run_both(jm, x, half_window_x=3, half_window_y=3,
                          poly_order=2, min_points=6)
    _compare(got, want, 1e-3)
    assert np.isfinite(got[10, 5:15]).all()


def test_under_quorum_min_points_and_fill(jm):
    rng = np.random.default_rng(5)
    x = _holed(rng, (24, 24), frac=0.5)
    got, want = _run_both(jm, x, half_window_x=2, half_window_y=2,
                          poly_order=1, min_points=20, fill=-7.0)
    _compare(got, want, F64_TOL)
    np.testing.assert_array_equal(
        got == -7.0, _coverage(np.isfinite(x), 2, 2) < 20)
    assert np.isfinite(got).all()


def test_int_and_half_inputs(jm):
    import jax.numpy as jnp
    xi = (np.arange(400) % 7).reshape(20, 20)
    y = sgt.savgol2d_apply_masked(torch.from_numpy(xi), half_window_x=2,
                                  half_window_y=2, poly_order=2)
    assert y.dtype == torch.float32
    yj = np.asarray(jm.savgol2d_apply_masked(
        jnp.asarray(xi), half_window_x=2, half_window_y=2, poly_order=2))
    _compare(y.numpy(), yj, 1e-6)
    xh = torch.from_numpy(np.linspace(-1, 1, 256).reshape(16, 16))
    assert sgt.savgol2d_apply_masked(
        xh.to(torch.bfloat16), half_window_x=2, half_window_y=2,
        poly_order=2).dtype == torch.bfloat16


# -- the f64 lstsq oracle ----------------------------------------------------------


def oracle_masked2d(img, w, nx, ny, m, dx, dy, deltax=1.0, deltay=1.0):
    """Per-pixel weighted LS fit in f64, truncate boundary; rank-deficient
    windows and windows under quorum yield NaN."""
    P = (m + 1) * (m + 2) // 2
    monos = [(i, t - i) for t in range(m + 1) for i in range(t + 1)]
    xpad = np.pad(np.where(w > 0, img, 0.0), ((ny, ny), (nx, nx)))
    wpad = np.pad(w, ((ny, ny), (nx, nx)))
    out = np.full(img.shape, np.nan)
    for r in range(img.shape[0]):
        for c in range(img.shape[1]):
            win = wpad[r:r + 2 * ny + 1, c:c + 2 * nx + 1]
            ys, xs = np.nonzero(win > 0)
            if len(ys) < P:
                continue
            A = np.stack([((xs - nx) * deltax) ** i * ((ys - ny) * deltay) ** j
                          for i, j in monos], axis=1)
            sw = np.sqrt(win[ys, xs])
            if np.linalg.matrix_rank(A * sw[:, None]) < P:
                continue
            coef, *_ = np.linalg.lstsq(A * sw[:, None],
                                       xpad[r + ys, c + xs] * sw, rcond=None)
            out[r, c] = (coef[monos.index((dx, dy))] * math.factorial(dx)
                         * math.factorial(dy))
    return out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("nx,ny,m,dx,dy,ddx,ddy", [
    (2, 2, 2, 0, 0, 1.0, 1.0), (3, 2, 3, 1, 0, 0.5, 1.0),
    (2, 3, 3, 0, 2, 1.0, 2.0)])
def test_lstsq_oracle(weighted, nx, ny, m, dx, dy, ddx, ddy):
    rng = np.random.default_rng(nx * 100 + ny * 10 + m)
    x = rng.standard_normal((20, 18))
    w = (rng.uniform(0.2, 2.0, x.shape) if weighted
         else np.ones(x.shape)) * (rng.random(x.shape) > 0.15)
    got = sgt.savgol2d_apply_masked(
        torch.from_numpy(x), half_window_x=nx, half_window_y=ny,
        poly_order=m, deriv_x=dx, deriv_y=dy, delta_x=ddx, delta_y=ddy,
        mask=torch.from_numpy(w) if weighted else torch.from_numpy(w > 0)
    ).numpy()
    want = oracle_masked2d(x, w, nx, ny, m, dx, dy, ddx, ddy)
    fin = np.isfinite(want) & np.isfinite(got)
    assert fin.sum() > 0.9 * np.isfinite(want).sum()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-7, atol=1e-8)


# -- gradients ------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("method", ["auto", "xla"])
def test_gradient_matches_jax_vjp(jm, weighted, method):
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(43)
    x = rng.standard_normal((16, 18))
    mask = rng.random(x.shape) > 0.2
    if weighted:
        mask = np.where(mask, rng.uniform(0.2, 2.0, x.shape), 0.0)
    cot = rng.standard_normal(x.shape)
    kw = dict(half_window_x=2, half_window_y=2, poly_order=2, deriv_y=1,
              fill=0.0)
    _, vjp = jax.vjp(lambda v: jm.savgol2d_apply_masked(
        v, mask=jnp.asarray(mask), method="xla", **kw), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    xt = torch.from_numpy(x).requires_grad_()
    y = sgt.savgol2d_apply_masked(xt, mask=torch.from_numpy(mask),
                                  method=method, **kw)
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(cot))
    scale = max(1.0, np.abs(want).max())
    assert np.abs(g.numpy() - want).max() <= 1e-4 * scale


def test_gradient_in_the_weights_is_finite():
    rng = np.random.default_rng(44)
    x = torch.from_numpy(rng.standard_normal((12, 14)))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (12, 14))).requires_grad_()
    y = sgt.savgol2d_apply_masked(x, mask=w, half_window_x=2,
                                  half_window_y=2, poly_order=2, fill=0.0)
    (gw,) = torch.autograd.grad(y.square().sum(), w)
    assert torch.isfinite(gw).all() and gw.abs().max() > 0


# -- validation ----------------------------------------------------------------


def test_errors():
    img = torch.zeros(16, 16)
    kw = dict(half_window_x=2, half_window_y=2)
    cases = [(dict(half_window_x=0, half_window_y=2, poly_order=1),
              "half_window_x"),
             (dict(kw, poly_order=1, deriv_x=1, deriv_y=1), "deriv"),
             (dict(kw, poly_order=2, min_points=3), "min_points"),
             (dict(kw, poly_order=1, boundary="valid"), "valid"),
             (dict(kw, poly_order=1, mask=torch.ones(16, 15, dtype=bool)),
              "mask shape"),
             (dict(kw, poly_order=1, method="sep"), "method")]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            sgt.savgol2d_apply_masked(img, **args)
    with pytest.raises(ValueError, match="2D"):
        sgt.savgol2d_apply_masked(torch.zeros(16), poly_order=1, **kw)
    with pytest.raises(NotImplementedError, match="complex"):
        sgt.savgol2d_apply_masked(torch.zeros(8, 8, dtype=torch.complex64),
                                  poly_order=1, **kw)


def test_cpu_routes_launch_nothing():
    from savgol_tpu_torch.ops import cuda_conv2d as c2
    from savgol_tpu_torch.ops import cuda_solve as cs
    for mod in (c10, c2, cs):
        mod.reset_launches()
    x = torch.from_numpy(_holed(np.random.default_rng(1), (12, 14)))
    sgt.savgol2d_apply_masked(x, half_window_x=2, half_window_y=2,
                              poly_order=2)
    sgt.savgol2d_apply_masked(x, half_window_x=1, half_window_y=3,
                              poly_order=3)
    assert c10.LAUNCHES == {"masked2d": 0}
    assert not any(c2.LAUNCHES.values()) and not any(cs.LAUNCHES.values())


# -- K10 and the staged kernel route on the card -----------------------------------


def _card(dev, x, mask=None, **kw):
    """(route under test on x's dtype, plain f64 staged route), host f64."""
    xt = torch.from_numpy(x).to(dev)
    mt = None if mask is None else torch.from_numpy(mask).to(dev)
    got = sgt.savgol2d_apply_masked(xt, mask=mt, **kw)
    kw.setdefault("rcond", 1e-6 if x.dtype == np.float32 else 1e-12)
    want = sgt.savgol2d_apply_masked(
        xt.double(), mask=None if mt is None else (
            mt if mt.dtype == torch.bool else mt.double()),
        method="xla", **kw)
    torch.cuda.synchronize()
    return got.double().cpu().numpy(), want.cpu().numpy()


@pytest.mark.cuda
def test_cuda_k10_matches_f64_oracle(cuda):
    # tests/test_masked2d_fused.py::test_fused_matches_f64_oracle
    x = _holed(np.random.default_rng(0), (48, 96), frac=0.15,
               dtype=np.float32)
    c10.reset_launches()
    got, want = _card(cuda, x, half_window_x=2, half_window_y=2,
                      poly_order=2)
    assert c10.LAUNCHES["masked2d"] == 1
    ok = np.isfinite(got) & np.isfinite(want)
    assert ok.mean() > 0.95
    assert np.abs(got - want)[ok].max() < 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,m,dx,dy", [(2, 2, 2, 0, 0), (5, 5, 3, 0, 0),
                                           (3, 2, 2, 0, 1), (3, 6, 4, 1, 0),
                                           (11, 11, 6, 1, 1)])
def test_cuda_k10_matches_staged(cuda, nx, ny, m, dx, dy):
    # tests/test_masked2d_fused.py::test_fused_matches_staged_f32 and
    # ::test_flagship_m3_small, against the f64 staged version
    x = _holed(np.random.default_rng(1), (2, 40, 200), frac=0.1,
               dtype=np.float32)
    got, want = _card(cuda, x, half_window_x=nx, half_window_y=ny,
                      poly_order=m, deriv_x=dx, deriv_y=dy)
    ok = np.isfinite(got) & np.isfinite(want)
    assert ok.mean() > 0.9
    well = _coverage(np.isfinite(x), nx, ny) >= 0.7 * (2 * nx + 1) * (
        2 * ny + 1)
    assert np.abs(got - want)[ok & well].max() < 5e-5
    assert np.abs(got - want)[ok].max() < 1e-3


@pytest.mark.cuda
def test_cuda_k10_weighted_and_f64(cuda):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((40, 72))
    w = rng.random((40, 72))
    w[rng.random(w.shape) < 0.2] = 0.0
    for dtype in (np.float32, np.float64):
        got, want = _card(cuda, x.astype(dtype), w.astype(dtype),
                          half_window_x=2, half_window_y=2, poly_order=2)
        ok = np.isfinite(got) & np.isfinite(want)
        assert ok.mean() > 0.9
        assert np.abs(got - want)[ok].max() < (1e-4 if dtype == np.float32
                                               else 1e-10)


# K10's compile-time instances P = 1, 3, 6, 10 (the path's 11 x 11, order
# 3), 15, with derivatives and weights; P = 21 and 28 on the runtime
# instance, the other side of the split
K10_INSTANCES = [(1, 1, 0, 0, 0, False), (1, 2, 1, 1, 0, True),
                 (2, 3, 2, 0, 1, False), (5, 5, 3, 0, 0, True),
                 (5, 5, 3, 1, 1, False), (3, 6, 4, 2, 0, True),
                 (5, 5, 4, 0, 1, False), (4, 4, 5, 1, 0, False),
                 (11, 11, 6, 0, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,m,dx,dy,weighted", K10_INSTANCES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_k10_instances(cuda, nx, ny, m, dx, dy, weighted, dtype):
    rng = np.random.default_rng(10 * nx + m)
    x = _holed(rng, (2, 4 * ny + 19, 4 * nx + 67), frac=0.1, dtype=dtype)
    w = None
    if weighted:
        w = np.where(np.isfinite(x), rng.uniform(0.2, 2.0, x.shape),
                     0.0).astype(dtype)
    c10.reset_launches()
    got, want = _card(cuda, x, w, half_window_x=nx, half_window_y=ny,
                      poly_order=m, deriv_x=dx, deriv_y=dy, delta_x=0.5,
                      delta_y=2.0)
    assert c10.LAUNCHES["masked2d"] == 1
    well = _coverage(np.isfinite(x), nx, ny) >= 0.7 * (2 * nx + 1) * (
        2 * ny + 1)
    _compare(got, want, 5e-5 if dtype == np.float32 else 1e-9, where=well,
             decided=well)


@pytest.mark.cuda
def test_cuda_k10_fill_and_big_hole(cuda):
    # tests/test_masked2d_fused.py::test_under_quorum_fill_and_big_hole
    x = np.random.default_rng(5).standard_normal((40, 72)).astype(np.float32)
    x[10:30, 20:50] = np.nan
    got, _ = _card(cuda, x, half_window_x=2, half_window_y=2, poly_order=2,
                   fill=-7.5)
    assert (got[18:22, 30:40] == -7.5).all() and np.isfinite(got).all()


@pytest.mark.cuda
def test_cuda_unsupported_config_takes_the_staged_kernels(cuda):
    from savgol_tpu_torch.ops import cuda_conv2d as c2
    from savgol_tpu_torch.ops import cuda_solve as cs
    x = _holed(np.random.default_rng(6), (2, 30, 40), dtype=np.float64)
    for mod in (c10, c2, cs):
        mod.reset_launches()
    got, want = _card(cuda, x, half_window_x=1, half_window_y=5,
                      poly_order=3, deriv_y=1)
    assert c10.LAUNCHES["masked2d"] == 0
    assert c2.LAUNCHES["corr2d_valid"] == 2 and cs.LAUNCHES["plane_solve"] == 1
    # the same basis on both sides, but a degenerate valid set's Cholesky
    # diagonal is rounding noise against the rcond threshold
    valid = np.isfinite(x)
    well = _coverage(valid, 1, 5) >= 0.7 * 3 * 11
    _compare(got, want, 1e-9, where=well,
             decided=_identifiable(valid, 1, 5, 3))
