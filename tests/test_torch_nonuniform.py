"""The port's irregular-sampling filter (``savgol_tpu_torch.
savgol_apply_nonuniform``, kernel K11 and its planes mode K11p) against the
JAX package's (``savgol_tpu.ops.nonuniform``).

On the CPU every route of the port takes its plain version (the staged fit
of ``ops/cuda_nonuniform.py``), and the tests compare it with the JAX
package's staged route (``method="xla"``) on the same numpy data: n, m, d,
holes, float weights, ``axis``, a shared 1D ``t``, ``min_points``/``fill``,
coincident, unsorted and epoch-scale abscissae. Gates: f64 <= 1e-10 *
max(1, max|ref|) (``tests/test_nonuniform.py``), f32 <= 1e-6 scaled, the
fill pattern identical. Also: the JAX fused kernel in interpret mode for
poly_order <= 2 (its interpret discharge grows explosively past that), the
f64 lstsq oracle of ``tests/test_nonuniform.py`` (5e-9), the K11p plane
stack against ``_fit_coeffs``, gradients against ``jax.vjp`` (rtol 1e-6 in
f64) and the JAX package's errors.

The tests marked ``cuda`` hold K11 and K11p against their plain versions on
the card:

    python -m pytest --noconftest -m cuda tests/test_torch_nonuniform.py -q
"""

import math

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch.ops import cuda_nonuniform as c11

F64_TOL = 1e-10
F32_TOL = 1e-6
SHAPE = (2, 150)


@pytest.fixture(scope="module")
def jnu():
    """savgol_tpu.ops.nonuniform; skips where JAX is not installed."""
    return pytest.importorskip("savgol_tpu.ops.nonuniform")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def jittery_t(rng, shape, dt=1.0, jitter=0.35):
    """Strictly increasing, irregular abscissae along the last axis."""
    gaps = dt * (1.0 + jitter * rng.uniform(-1, 1, shape))
    return np.cumsum(gaps, axis=-1)


def _data(seed, shape=SHAPE, frac=0.15, dtype=np.float64):
    rng = np.random.default_rng(seed)
    t = jittery_t(rng, shape)
    x = np.sin(0.3 * t) + 0.1 * rng.standard_normal(shape)
    x[rng.random(shape) < frac] = np.nan
    return x.astype(dtype), t.astype(dtype)


def _compare(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    if not fin.any():
        return
    scale = max(1.0, np.abs(want[fin]).max())
    err = np.abs(got[fin] - want[fin]).max()
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} * {scale:.3e}"


def _run_both(jnu, x, t, mask=None, method="xla", **kw):
    import jax.numpy as jnp
    want = np.asarray(jnu.savgol_apply_nonuniform(
        jnp.asarray(x), jnp.asarray(t),
        mask=None if mask is None else jnp.asarray(mask), method=method,
        **kw))
    got = sgt.savgol_apply_nonuniform(
        torch.from_numpy(x), torch.from_numpy(t),
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    return got.numpy(), want


def oracle_nonuniform(xv, tv, mk, n, m, d, w=None):
    """Per-window LS fit at arbitrary abscissae in f64 (truncate edges), as
    ``tests/test_nonuniform.py``."""
    xv = np.asarray(xv, np.float64)
    tv = np.asarray(tv, np.float64)
    N = len(xv)
    out = np.full(N, np.nan)
    for p in range(N):
        js = np.arange(max(0, p - n), min(N, p + n + 1))
        js = js[np.asarray(mk, bool)[js]]
        ww = np.ones(len(js)) if w is None else np.asarray(w, float)[js]
        js, ww = js[ww > 0], ww[ww > 0]
        if len(js) < m + 1:
            continue
        A = np.vander(tv[js] - tv[p], m + 1, increasing=True) \
            * np.sqrt(ww)[:, None]
        if np.linalg.matrix_rank(A / max(1.0, np.abs(A).max()),
                                 tol=1e-10) < m + 1:
            continue
        c, *_ = np.linalg.lstsq(A, xv[js] * np.sqrt(ww), rcond=None)
        out[p] = c[d] * math.factorial(d)
    return out


# -- against the JAX package's staged route -------------------------------------


@pytest.mark.parametrize("n,m,d", [(3, 2, 0), (5, 3, 1), (4, 2, 2), (2, 0, 0),
                                   (6, 4, 3), (12, 4, 1)])
def test_matches_jax_f64(jnu, n, m, d):
    x, t = _data(n * 10 + m)
    got, want = _run_both(jnu, x, t, half_window=n, poly_order=m,
                          derivative=d)
    _compare(got, want, F64_TOL)


@pytest.mark.parametrize("n,m,d", [(3, 2, 1), (12, 4, 0)])
def test_matches_jax_f32(jnu, n, m, d):
    x, t = _data(40 + n, dtype=np.float32)
    got, want = _run_both(jnu, x, t, half_window=n, poly_order=m,
                          derivative=d)
    _compare(got, want, F32_TOL)


def test_weighted_mask_and_fill(jnu):
    x, t = _data(3, frac=0.0)
    rng = np.random.default_rng(3)
    w = rng.uniform(0.0, 2.0, x.shape)
    w[w < 0.3] = 0.0
    got, want = _run_both(jnu, x, t, w, half_window=3, poly_order=2,
                          derivative=1, fill=-5.0)
    _compare(got, want, F64_TOL)


def test_axis_and_shared_t(jnu):
    x, t = _data(4)
    t1 = t[0]
    got, want = _run_both(jnu, x, t1, half_window=3, poly_order=2)
    _compare(got, want, F64_TOL)
    got0, want0 = _run_both(jnu, np.ascontiguousarray(x.T), t1,
                            half_window=3, poly_order=2, axis=0)
    _compare(got0, want0, F64_TOL)
    _compare(got0.T, got, 0.0)
    got3, want3 = _run_both(jnu, np.ascontiguousarray(x.T),
                            np.ascontiguousarray(t.T), half_window=3,
                            poly_order=2, axis=0)
    _compare(got3, want3, F64_TOL)


def test_min_points_and_fill(jnu):
    x, t = _data(6, frac=0.4)
    got, want = _run_both(jnu, x, t, half_window=3, poly_order=2,
                          min_points=6, fill=-1.0)
    _compare(got, want, F64_TOL)
    assert (got == -1.0).any()


def test_coincident_t(jnu):
    x, _ = _data(5, frac=0.0)
    t = np.full(SHAPE, 7.0)
    got1, want1 = _run_both(jnu, x, t, half_window=3, poly_order=1)
    _compare(got1, want1, F64_TOL)
    assert np.isnan(got1).all()
    got0, want0 = _run_both(jnu, x, t, half_window=3, poly_order=0)
    _compare(got0, want0, F64_TOL)
    np.testing.assert_allclose(got0[0, 10], x[0, 7:14].mean(), atol=1e-12)
    # pairs of coincident stamps: m = 1 still identified
    tp = np.repeat(np.arange(SHAPE[1] // 2, dtype=np.float64), 2)
    got2, want2 = _run_both(jnu, x, np.broadcast_to(tp, SHAPE).copy(),
                            half_window=3, poly_order=1, derivative=1)
    _compare(got2, want2, F64_TOL)


def test_unsorted_and_nan_abscissae(jnu):
    x, t = _data(7, frac=0.0)
    rng = np.random.default_rng(7)
    t = rng.permutation(t.ravel()).reshape(SHAPE)
    t[0, 10] = np.nan                       # a NaN centre fills
    got, want = _run_both(jnu, x, t, half_window=3, poly_order=2)
    _compare(got, want, F64_TOL)
    assert np.isnan(got[0, 10])


def test_epoch_t_f64_with_f32_x(jnu):
    rng = np.random.default_rng(33)
    t = 1.6e9 + jittery_t(rng, SHAPE, dt=0.01)
    x = np.sin(2 * np.pi * (t - 1.6e9)).astype(np.float32)
    got, want = _run_both(jnu, x, t, half_window=5, poly_order=2,
                          derivative=1)
    _compare(got, want, F32_TOL)
    oracle = oracle_nonuniform(x[0], t[0], np.ones(SHAPE[1], bool), 5, 2, 1)
    assert np.abs(got[0] - oracle).max() <= 1e-3 * np.abs(oracle).max()


def test_int_and_half_input():
    t = torch.arange(SHAPE[1], dtype=torch.float64) * 0.5
    xi = torch.arange(SHAPE[1]) % 7
    y = sgt.savgol_apply_nonuniform(xi, t, half_window=3, poly_order=2)
    assert y.dtype == torch.float32
    _compare(y.numpy(), sgt.savgol_apply_nonuniform(
        xi.to(torch.float32), t, half_window=3, poly_order=2).numpy(), 0.0)
    xh = torch.from_numpy(np.linspace(-1, 1, SHAPE[1])).to(torch.bfloat16)
    assert sgt.savgol_apply_nonuniform(xh, t, half_window=3,
                                       poly_order=2).dtype == torch.bfloat16


# -- against the JAX fused kernel (interpret mode), poly_order <= 2 --------------


@pytest.mark.parametrize("n,m,d", [(3, 2, 1), (2, 1, 0)])
def test_matches_jax_fused_interpret(jnu, n, m, d):
    x, t = _data(100 + n, shape=(2, 130), dtype=np.float32)
    got, want = _run_both(jnu, x, t, method="fused", half_window=n,
                          poly_order=m, derivative=d)
    _compare(got, want, F32_TOL)


def test_port_fused_keeps_t_dtype(jnu):
    # the port's kernel route never downcasts t: "fused" equals the JAX
    # package's staged route, not its fused one (which casts t to f32)
    x, t = _data(9, dtype=np.float32)
    t = t.astype(np.float64) + 1e7
    got = sgt.savgol_apply_nonuniform(torch.from_numpy(x),
                                      torch.from_numpy(t), half_window=3,
                                      poly_order=2, method="fused").numpy()
    _, want = _run_both(jnu, x, t, half_window=3, poly_order=2)
    _compare(got, want, F32_TOL)


# -- the f64 lstsq oracle ------------------------------------------------------


@pytest.mark.parametrize("n,m,d", [(2, 1, 0), (4, 2, 1), (5, 3, 2), (3, 0, 0)])
def test_lstsq_oracle(n, m, d):
    x, t = _data(2 + n, shape=(1, 157))
    got = sgt.savgol_apply_nonuniform(torch.from_numpy(x[0]),
                                      torch.from_numpy(t[0]), half_window=n,
                                      poly_order=m, derivative=d).numpy()
    want = oracle_nonuniform(x[0], t[0], np.isfinite(x[0]), n, m, d)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=5e-9)


def test_weighted_lstsq_oracle():
    x, t = _data(10, shape=(1, 120), frac=0.0)
    rng = np.random.default_rng(10)
    w = rng.uniform(0.0, 2.0, 120)
    w[w < 0.2] = 0.0
    got = sgt.savgol_apply_nonuniform(
        torch.from_numpy(x[0]), torch.from_numpy(t[0]), half_window=4,
        poly_order=2, derivative=1, mask=torch.from_numpy(w)).numpy()
    want = oracle_nonuniform(x[0], t[0], np.ones(120, bool), 4, 2, 1, w=w)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=5e-9)


# -- K11p's plain planes against the JAX package's _fit_coeffs --------------------


@pytest.mark.parametrize("n,m", [(3, 2), (5, 3)])
def test_planes_match_fit_coeffs(jnu, n, m):
    import jax.numpy as jnp
    x, t = _data(20 + n)
    mask = np.isfinite(x)
    xz = np.where(mask, x, 0.0)
    w = mask.astype(np.float64)
    coef, s, ok = jnu._fit_coeffs(
        jnu._staged_taps(jnp.asarray(xz), jnp.asarray(w), jnp.asarray(t), n),
        2 * n + 1, m, m + 1, 1e-12, jnp.float64)
    planes = c11.savgol_nonuniform_planes_cuda(
        torch.from_numpy(xz), torch.from_numpy(w), torch.from_numpy(t),
        half_window=n, poly_order=m, kmin=m + 1, rcond=1e-12).numpy()
    assert planes.shape == (m + 3,) + SHAPE
    np.testing.assert_array_equal(planes[m + 2], np.asarray(ok, np.float64))
    np.testing.assert_array_equal(planes[m + 1], np.asarray(s))
    want = np.asarray(coef)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(planes[:m + 1] - want).max() <= F64_TOL * scale


# -- gradients ------------------------------------------------------------------


def test_gradients_match_jax(jnu):
    # x, t and a float mask in one VJP (the JAX package's custom VJP takes
    # the VJP of its staged twin; the port autograd of its plain version)
    import jax
    import jax.numpy as jnp
    x, t = _data(11, frac=0.0)
    rng = np.random.default_rng(11)
    w = np.where(rng.random(SHAPE) > 0.15, rng.uniform(0.2, 2.0, SHAPE), 0.0)
    kw = dict(half_window=3, poly_order=2, derivative=1, fill=0.0)
    g = rng.standard_normal(SHAPE)
    _, vjp = jax.vjp(lambda xv, tv, wv: jnu.savgol_apply_nonuniform(
        xv, tv, mask=wv, method="xla", **kw), *map(jnp.asarray, (x, t, w)))
    want = vjp(jnp.asarray(g))
    tens = [torch.from_numpy(a).requires_grad_() for a in (x, t, w)]
    y = sgt.savgol_apply_nonuniform(tens[0], tens[1], mask=tens[2], **kw)
    got = torch.autograd.grad(y, tens, torch.from_numpy(g))
    for gg, ww in zip(got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(ww), rtol=1e-6,
                                   atol=1e-9 * max(1.0, np.abs(ww).max()))


# -- validation ------------------------------------------------------------------


def test_errors():
    x = torch.zeros(10)
    t = torch.arange(10.0)
    cases = [(dict(half_window=0, poly_order=0), "half_window"),
             (dict(half_window=2, poly_order=5), "poly_order"),
             (dict(half_window=2, poly_order=1, derivative=2), "derivative"),
             (dict(half_window=2, poly_order=1, min_points=1), "min_points"),
             (dict(half_window=2, poly_order=1, method="banana"), "method"),
             (dict(half_window=2, poly_order=1,
                   mask=torch.ones(9, dtype=torch.bool)), "mask shape")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            sgt.savgol_apply_nonuniform(x, t, **kw)
    with pytest.raises(ValueError, match="t shape"):
        sgt.savgol_apply_nonuniform(x, torch.zeros(9), half_window=2,
                                    poly_order=1)
    with pytest.raises(ValueError, match="t shape"):
        sgt.savgol_apply_nonuniform(torch.zeros(3, 10), torch.zeros(9),
                                    half_window=2, poly_order=1)
    with pytest.raises(NotImplementedError, match="complex"):
        sgt.savgol_apply_nonuniform(x.to(torch.complex64), t, half_window=2,
                                    poly_order=1)


def test_cpu_routes_launch_nothing():
    c11.reset_launches()
    x, t = _data(12)
    for method in ("auto", "fused", "xla"):
        sgt.savgol_apply_nonuniform(torch.from_numpy(x), torch.from_numpy(t),
                                    half_window=3, poly_order=2,
                                    method=method)
    assert c11.LAUNCHES == {"nonuniform": 0}


def test_fit_in_float64_keeps_the_float32_design():
    # acc=float64 on float32 data: the design of the float32 route, the
    # moments and the solve in double-word float64 (K11's own arithmetic)
    x, t = _data(14, dtype=np.float32)
    mask = np.isfinite(x)
    args = [torch.from_numpy(a) for a in
            (np.where(mask, x, 0).astype(np.float32),
             mask.astype(np.float32), t)]
    kw = dict(half_window=4, poly_order=3, derivative=1, kmin=4, fill=-2.0,
              rcond=1e-6)
    y32 = c11.nonuniform_plain(*args, **kw)
    y64 = c11.nonuniform_plain(*args, acc=torch.float64, **kw)
    assert y64.dtype == torch.float32
    _compare(y64.numpy(), y32.numpy(), F32_TOL)
    x64 = [a.double() for a in args]
    _compare(c11.nonuniform_plain(*x64, acc=torch.float64, **kw).numpy(),
             c11.nonuniform_plain(*x64, **kw).numpy(), 0.0)


# -- K11 and K11p on the card ------------------------------------------------------


@pytest.mark.cuda
def test_smem_bytes_and_refusal_rule(cuda):
    # the layout nonuniform.cu reports: t, x and w of the 128 outputs and
    # their 2n halo, 16-byte aligned, then from k = 5 to 8 L (hi and lo,
    # packed) by thread; device scratch only past k = 8
    tile = 3 * 16 * -(-(152 * 4) // 16)
    assert c11.nonuniform_layout(12, 3, torch.float32, torch.float32) == \
        (tile, 0, 128)
    assert c11.nonuniform_layout(12, 4, torch.float32, torch.float32) == \
        (tile + 8 * 2 * 15 * 128, 0, 128)
    assert c11.nonuniform_layout(12, 7, torch.float32, torch.float32) == \
        (tile + 8 * 2 * 36 * 128, 0, 128)
    assert c11.nonuniform_layout(24, 40, torch.float32, torch.float64)[1] > 0
    assert c11.nonuniform_layout(5000, 1, torch.float64,
                                 torch.float64)[0] > c11.SMEM_LIMIT
    # where L would not fit beside the tile, the tile alone and scratch
    assert c11.nonuniform_layout(9620, 4, torch.float32, torch.float32) == \
        (3 * 16 * -(-(19368 * 4) // 16), 128, 128)


def _largest_tiled_n(size: int) -> int:
    """The largest n whose staged tile (t, x and w of 128 outputs and the
    2n halo, each 16-byte aligned) fits a block's shared memory."""
    return (c11.SMEM_LIMIT // 3 // 16 * 16 // size - 128) // 2


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 7])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_k11_takes_every_n_whose_tile_fits(cuda, m, dtype):
    # at the largest such n the tile and L pass the limit, so the K = 0
    # instance on device scratch runs; on a 64-sample row every window
    # spans the row, so it must give the bits of n = 63 (the compile-time
    # instance), which hold to the plain version (the FP64-pair witness
    # for float32)
    n = _largest_tiled_n(np.dtype(dtype).itemsize)
    xt = torch.float32 if dtype == np.float32 else torch.float64
    smem, work, _ = c11.nonuniform_layout(n, m, xt, xt)
    assert smem <= c11.SMEM_LIMIT and work > 0
    assert c11.nonuniform_layout(n + 1, m, xt, xt)[0] > c11.SMEM_LIMIT
    x, t = _data(70 + m, shape=(2, 64), dtype=dtype)
    mask = np.isfinite(x)
    xz, w, tl = (torch.from_numpy(a).to(cuda) for a in
                 (np.where(mask, x, 0).astype(dtype), mask.astype(dtype), t))
    kw = dict(poly_order=m, derivative=1, kmin=m + 1, fill=float("nan"),
              rcond=1e-6)
    c11.reset_launches()
    big = c11.savgol_nonuniform_fused_cuda(xz, w, tl, half_window=n, **kw)
    small = c11.savgol_nonuniform_fused_cuda(xz, w, tl, half_window=63, **kw)
    assert c11.LAUNCHES["nonuniform"] == 2
    planes = [c11.savgol_nonuniform_planes_cuda(
        xz, w, tl, half_window=h, poly_order=m, kmin=m + 1, rcond=1e-6)
        for h in (n, 63)]
    want = c11.nonuniform_plain(
        xz, w, tl, half_window=63, **kw,
        acc=torch.float64 if dtype == np.float32 else None)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(big.cpu().numpy(), small.cpu().numpy())
    np.testing.assert_array_equal(planes[0].cpu().numpy(),
                                  planes[1].cpu().numpy())
    _compare(small.cpu().numpy(), want.cpu().numpy(),
             1e-5 if dtype == np.float32 else 1e-12)


def _card(dev, x, t, mask=None, **kw):
    """(K11 route, plain staged route) on the card."""
    xt, tt = torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)
    mt = None if mask is None else torch.from_numpy(mask).to(dev)
    got = sgt.savgol_apply_nonuniform(xt, tt, mask=mt, **kw)
    want = sgt.savgol_apply_nonuniform(xt, tt, mask=mt, method="xla", **kw)
    torch.cuda.synchronize()
    return got.cpu().numpy(), want.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(2, 1, 0), (3, 2, 2), (12, 4, 1),
                                   (32, 6, 2), (100, 3, 1), (3, 0, 0),
                                   (12, 5, 1), (12, 7, 2)])
@pytest.mark.parametrize("dtype,tdtype", [(np.float32, np.float32),
                                          (np.float32, np.float64),
                                          (np.float64, np.float64)])
def test_cuda_k11_matches_plain(cuda, n, m, d, dtype, tdtype):
    x, t = _data(n + m + d, shape=(3, 600))
    c11.reset_launches()
    got, want = _card(cuda, x.astype(dtype), t.astype(tdtype), half_window=n,
                      poly_order=m, derivative=d)
    assert c11.LAUNCHES["nonuniform"] == 1
    _compare(got, want, 1e-5 if dtype == np.float32 else 1e-12)


@pytest.mark.cuda
def test_cuda_k11_weighted_epoch_shared_and_unsorted_t(cuda):
    x, t = _data(31, shape=(3, 700), frac=0.0)
    rng = np.random.default_rng(31)
    w = np.where(rng.random(x.shape) > 0.3, rng.uniform(0.2, 2, x.shape), 0)
    got, want = _card(cuda, x.astype(np.float32), 1.6e9 + 0.01 * t,
                      w.astype(np.float32), half_window=5, poly_order=3,
                      derivative=1, fill=0.0)
    _compare(got, want, 1e-5)
    got, want = _card(cuda, x, t[0], half_window=5, poly_order=3)
    _compare(got, want, 1e-12)
    tu = rng.permutation(t.ravel()).reshape(t.shape)
    tu[1, 40] = np.nan                      # a NaN centre fills
    got, want = _card(cuda, x, tu, half_window=4, poly_order=2)
    _compare(got, want, 1e-12)
    assert np.isnan(got[1, 40])


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(12, 4), (24, 40), (3, 0), (2, 1), (3, 2),
                                 (5, 3), (12, 5), (32, 6), (12, 7)])
def test_cuda_k11_planes_match_plain(cuda, n, m):
    # every compile-time instance, k = m + 1 = 1..8 (7 and 8 keep L in
    # shared memory); m = 40: k past them (device scratch); the degree-40
    # monomial fit is never identified, so the rows compared there are the
    # raw rhs moments the solve returns for a window that is not ok
    x, t = _data(n + m, shape=(2, 500))
    mask = np.isfinite(x)
    args = [torch.from_numpy(a).to(cuda) for a in
            (np.where(mask, x, 0.0), mask.astype(np.float64), t)]
    kw = dict(half_window=n, poly_order=m, kmin=m + 1, rcond=1e-12)
    got = c11.savgol_nonuniform_planes_cuda(*args, **kw).cpu().numpy()
    want = c11.nonuniform_planes_plain(*args, **kw).cpu().numpy()
    np.testing.assert_array_equal(got[m + 1:], want[m + 1:])
    scale = max(1.0, np.abs(want[:m + 1]).max())
    assert np.abs(got[:m + 1] - want[:m + 1]).max() <= 1e-12 * scale


@pytest.mark.cuda
def test_cuda_k11_refuses_what_shared_memory_cannot_hold(cuda):
    x = torch.zeros(1, 12_000, device=cuda, dtype=torch.float64)
    t = torch.arange(12_000, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        sgt.savgol_apply_nonuniform(x, t, half_window=5_000, poly_order=1)
