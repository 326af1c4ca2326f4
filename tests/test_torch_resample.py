"""The port's resampling (``savgol_tpu_torch.savgol_resample``: kernel K11
in its planes mode, then the gather-evaluate kernel K12) against the JAX
package's (``savgol_tpu.ops.nonuniform.savgol_resample``).

On the CPU both methods of the port take their plain versions and the tests
compare them with the JAX package's on the same numpy data: queries inside
and outside ``[t[0], t[-1]]``, queries tied with sample positions, shuffled
queries, holes, float weights, a 1D mask, batches sharing ``t`` and
epoch-scale float64 abscissae with float32 data. Gates: f64 <= 1e-10 *
max(1, max|ref|), f32 <= 1e-6 scaled, the fill pattern identical. Also: K12's
plain version against the JAX package's kernel ``resample_eval_pallas`` in
interpret mode on the same planes, gradients in ``x``, ``t``, ``t_query``
and a float mask against ``jax.vjp`` (rtol 1e-6 in f64), and the JAX
package's errors.

The tests marked ``cuda`` hold K12 against its plain version and the
``auto`` route against ``direct`` (whose per-query solve is K8b) on the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_resample.py -q
"""

import math

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch.ops import cuda_nonuniform as c11
from savgol_tpu_torch.ops import cuda_resample as c12
from savgol_tpu_torch.ops import cuda_solve as cs

F64_TOL = 1e-10
F32_TOL = 1e-6
N, NQ = 160, 70


@pytest.fixture(scope="module")
def jnu():
    """savgol_tpu.ops.nonuniform; skips where JAX is not installed."""
    return pytest.importorskip("savgol_tpu.ops.nonuniform")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _data(seed, B=2, n_data=N, frac=0.1, dtype=np.float64):
    """(x (B, N), sorted irregular t (N,), queries (NQ,)): sorted, reaching
    past both ends, five of them tied with sample positions."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 1.5, n_data))
    x = np.sin(0.2 * t) + 0.1 * rng.standard_normal((B, n_data))
    x[rng.random(x.shape) < frac] = np.nan
    tq = rng.uniform(t[0] - 3.0, t[-1] + 3.0, NQ)
    tq[:5] = t[rng.choice(n_data, 5, replace=False)]
    return x.astype(dtype), t.astype(dtype), np.sort(tq).astype(dtype)


def _compare(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    if not fin.any():
        return
    scale = max(1.0, np.abs(want[fin]).max())
    err = np.abs(got[fin] - want[fin]).max()
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} * {scale:.3e}"


def _run_both(jnu, x, t, tq, mask=None, **kw):
    import jax.numpy as jnp
    want = np.asarray(jnu.savgol_resample(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(tq),
        mask=None if mask is None else jnp.asarray(mask), **kw))
    got = sgt.savgol_resample(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(tq),
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    return got.numpy(), want


# -- against the JAX package --------------------------------------------------------


@pytest.mark.parametrize("method", ["auto", "direct"])
@pytest.mark.parametrize("n,m,d", [(3, 2, 0), (5, 3, 1), (4, 2, 2)])
def test_matches_jax_f64(jnu, method, n, m, d):
    x, t, tq = _data(n * 10 + d)
    got, want = _run_both(jnu, x, t, tq, half_window=n, poly_order=m,
                          derivative=d, method=method)
    assert got.shape == (2, NQ)
    _compare(got, want, F64_TOL)


@pytest.mark.parametrize("method", ["auto", "direct"])
def test_shuffled_queries(jnu, method):
    x, t, tq = _data(1)
    tq = np.random.default_rng(1).permutation(tq)
    got, want = _run_both(jnu, x, t, tq, half_window=3, poly_order=2,
                          derivative=1, method=method)
    _compare(got, want, F64_TOL)


def test_matches_jax_f32(jnu):
    x, t, tq = _data(2, dtype=np.float32)
    got, want = _run_both(jnu, x, t, tq, half_window=5, poly_order=3,
                          derivative=1)
    _compare(got, want, F32_TOL)


def test_holes_weights_and_1d_mask(jnu):
    x, t, tq = _data(3, frac=0.3)
    got, want = _run_both(jnu, x, t, tq, half_window=3, poly_order=2,
                          fill=-2.0)
    _compare(got, want, F64_TOL)
    rng = np.random.default_rng(3)
    w = np.where(np.isfinite(x), rng.uniform(0.1, 2.0, x.shape), 0.0)
    xz = np.where(np.isfinite(x), x, 0.0)
    for method in ("auto", "direct"):
        got, want = _run_both(jnu, xz, t, tq, w, half_window=3,
                              poly_order=2, method=method)
        _compare(got, want, F64_TOL)
    m1 = rng.random(N) > 0.2
    got, want = _run_both(jnu, xz, t, tq, m1, half_window=3, poly_order=2)
    _compare(got, want, F64_TOL)


def test_one_row_equals_its_batch_row():
    x, t, tq = _data(4)
    args = [torch.from_numpy(a) for a in (t, tq)]
    for method in ("auto", "direct"):
        y1 = sgt.savgol_resample(torch.from_numpy(x[0]), *args, half_window=3,
                                 poly_order=2, method=method)
        yb = sgt.savgol_resample(torch.from_numpy(x), *args, half_window=3,
                                 poly_order=2, method=method)
        assert y1.shape == (NQ,)
        _compare(y1.numpy(), yb[0].numpy(), 0.0)


def test_epoch_abscissae_f64_with_f32_x(jnu):
    x, t, tq = _data(4)
    got, want = _run_both(jnu, x.astype(np.float32), 1.6e9 + 0.01 * t,
                          1.6e9 + 0.01 * tq, half_window=3, poly_order=2,
                          derivative=1)
    _compare(got, want, F32_TOL)


def test_auto_agrees_with_direct():
    # the same window and fit in two bases (tests/test_resample_pallas.py)
    x, t, tq = _data(5, frac=0.0)
    kw = dict(half_window=4, poly_order=3, derivative=1)
    args = [torch.from_numpy(a) for a in (x, t, tq)]
    ya = sgt.savgol_resample(*args, **kw).numpy()
    yd = sgt.savgol_resample(*args, method="direct", **kw).numpy()
    _compare(ya, yd, 1e-8)


# -- K12's plain version against the JAX kernel in interpret mode -------------------


@pytest.mark.parametrize("m,d", [(3, 1), (2, 0)])
def test_k12_plain_matches_resample_eval_pallas(m, d):
    import jax.numpy as jnp
    from savgol_tpu.ops.pallas_resample import (resample_block_fit,
                                                resample_eval_pallas)
    n, B, n_data = 5, 2, 1500
    x, t, _ = _data(10 + m, B=B, n_data=n_data, frac=0.6, dtype=np.float32)
    tq = np.linspace(t[0] - 2, t[-1] + 2, 600).astype(np.float32)
    mask = np.isfinite(x)
    planes = c11.nonuniform_planes_plain(
        torch.from_numpy(np.where(mask, x, 0)), torch.from_numpy(
            mask.astype(np.float32)), torch.from_numpy(t), half_window=n,
        poly_order=m, kmin=m + 1, rcond=1e-6)
    ins = np.searchsorted(t, tq)
    ctr = np.clip(ins - n, 0, n_data - 2 * n - 1) + n
    assert bool(resample_block_fit(jnp.asarray(ctr, jnp.int32), n_data))
    K = m + 1 - d
    pl = planes.numpy()
    bpl = np.stack([pl[j + d] * float(math.factorial(j + d)
                                      // math.factorial(j))
                    for j in range(K)]).astype(np.float32)
    stack = np.concatenate([bpl.reshape(K * B, n_data), pl[m + 1], pl[m + 2],
                            t[None]])
    want = np.asarray(resample_eval_pallas(
        jnp.asarray(stack), jnp.asarray(ctr, jnp.int32), jnp.asarray(tq),
        K=K, B=B, derivative=d, fill=-7.5, interpret=True))
    got = c12.resample_eval_cuda(planes, torch.from_numpy(t),
                                 torch.from_numpy(ctr), torch.from_numpy(tq),
                                 poly_order=m, derivative=d,
                                 fill=-7.5).numpy()
    assert (got == -7.5).any()
    np.testing.assert_array_equal(got == -7.5, want == -7.5)
    _compare(got, want, F32_TOL)


# -- gradients ------------------------------------------------------------------


def test_gradients_match_jax(jnu):
    import jax
    import jax.numpy as jnp
    x, t, tq = _data(6, frac=0.0)
    tq = np.sort(np.random.default_rng(6).uniform(t[2], t[-3], NQ))
    w = np.random.default_rng(7).uniform(0.2, 2.0, x.shape)
    kw = dict(half_window=3, poly_order=2, derivative=1, fill=0.0)
    g = np.random.default_rng(8).standard_normal((2, NQ))
    _, vjp = jax.vjp(lambda xv, tv, qv, wv: jnu.savgol_resample(
        xv, tv, qv, mask=wv, **kw), *map(jnp.asarray, (x, t, tq, w)))
    want = vjp(jnp.asarray(g))
    tens = [torch.from_numpy(a).requires_grad_() for a in (x, t, tq, w)]
    y = sgt.savgol_resample(tens[0], tens[1], tens[2], mask=tens[3], **kw)
    got = torch.autograd.grad(y, tens, torch.from_numpy(g))
    for gg, ww in zip(got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(ww), rtol=1e-6,
                                   atol=1e-9 * max(1.0, np.abs(ww).max()))


# -- validation ------------------------------------------------------------------


def test_errors():
    x = torch.zeros(30)
    t = torch.arange(30.0)
    tq = torch.linspace(0.0, 29.0, 7)
    cases = [((x, torch.zeros(2, 30), tq), {}, "t must be 1D"),
             ((x, t, tq.reshape(1, -1)), {}, "t_query must be 1D"),
             ((torch.zeros(4), torch.arange(4.0), tq),
              dict(half_window=3), "shorter than the window"),
             ((x, t, tq), dict(mask=torch.ones(29, dtype=torch.bool)),
              "1D mask length"),
             ((x, t, tq), dict(mask=torch.ones(2, 30, dtype=torch.bool)),
              "mask shape"),
             ((x, t, tq), dict(method="sort"), "method"),
             ((x, t, tq), dict(poly_order=5), "poly_order"),
             ((x, t, tq), dict(min_points=1), "min_points")]
    for args, kw, match in cases:
        kw = {"half_window": 2, "poly_order": 1, **kw}
        with pytest.raises(ValueError, match=match):
            sgt.savgol_resample(*args, **kw)
    with pytest.raises(NotImplementedError, match="complex"):
        sgt.savgol_resample(x.to(torch.complex64), t, tq, half_window=2,
                            poly_order=1)


def test_cpu_routes_launch_nothing():
    c11.reset_launches()
    c12.reset_launches()
    cs.reset_launches()
    x, t, tq = _data(9)
    for method in ("auto", "direct"):
        sgt.savgol_resample(torch.from_numpy(x), torch.from_numpy(t),
                            torch.from_numpy(tq), half_window=3,
                            poly_order=2, method=method)
    assert c11.LAUNCHES == {"nonuniform": 0}
    assert c12.LAUNCHES == {"resample": 0}
    assert cs.LAUNCHES == {"plane_solve": 0, "plane_solve_dd": 0}


def test_direct_solves_through_the_k8b_wrapper(monkeypatch):
    # the direct route hands its Hankel moments (2m+1 planes) to the
    # double-word plane solve wrapper, K8b on a CUDA tensor
    from savgol_tpu_torch.ops import nonuniform as nu
    seen = []

    def spy(ghi, *rest, **kw):
        seen.append(ghi.shape)
        return cs.plane_cholesky_solve_dd(ghi, *rest, **kw)

    monkeypatch.setattr(nu, "plane_cholesky_solve_dd", spy)
    x, t, tq = _data(10)
    args = [torch.from_numpy(a) for a in (x, t, tq)]
    kw = dict(half_window=3, poly_order=2, derivative=1)
    yd = sgt.savgol_resample(*args, method="direct", **kw)
    assert seen == [(5, 2, NQ)]
    ya = sgt.savgol_resample(*args, **kw)
    assert len(seen) == 1
    _compare(yd.numpy(), ya.numpy(), 1e-8)


# -- K12 and the auto route on the card -----------------------------------------


def _random_planes(rng, m, B, n_data, dtype, dev):
    """An (m+3, B, N) plane stack: standard normal coefficients, s in
    [4, 8] (the offsets of queries inside the data are then a few s), ok
    0 for a fifth of the positions."""
    c = rng.standard_normal((m + 1, B, n_data))
    s = rng.uniform(4.0, 8.0, (1, B, n_data))
    ok = (rng.random((1, B, n_data)) >= 0.2).astype(np.float64)
    return torch.from_numpy(np.concatenate([c, s, ok])).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("queries", ["sorted", "shuffled", "sparse",
                                     "dense"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_k12_matches_plain(cuda, queries, dtype):
    rng = np.random.default_rng(12)
    n, m, B, n_data = 6, 4, 3, 5000
    x, t, _ = _data(12, B=B, n_data=n_data, frac=0.2, dtype=dtype)
    nq = {"sorted": 3000, "shuffled": 3000, "sparse": 40, "dense": 9000}
    tq = rng.uniform(t[0] - 5, t[-1] + 5, nq[queries]).astype(dtype)
    if queries != "shuffled":
        tq = np.sort(tq)
    mask = np.isfinite(x)
    dev = [torch.from_numpy(a).to(cuda) for a in
           (np.where(mask, x, 0), mask.astype(dtype), t, tq)]
    planes = c11.nonuniform_planes_plain(dev[0], dev[1], dev[2],
                                         half_window=n, poly_order=m,
                                         kmin=m + 1, rcond=1e-6)
    ins = torch.searchsorted(dev[2], dev[3])
    ctr = torch.clamp(ins - n, 0, n_data - 2 * n - 1) + n
    tol = 1e-5 if dtype == np.float32 else 1e-12
    for d in range(m + 1):
        kw = dict(poly_order=m, derivative=d, fill=0.0)
        c12.reset_launches()
        got = c12.resample_eval_cuda(planes, dev[2], ctr, dev[3], **kw)
        assert c12.LAUNCHES["resample"] == 1
        want = c12.resample_eval_plain(planes, dev[2], ctr, dev[3], **kw)
        torch.cuda.synchronize()
        _compare(got.cpu().numpy(), want.cpu().numpy(), tol)
    # row groups (B = 17 leaves a partial one), every compile-time m the
    # kernel has a case for up to 7 and the runtime form past it, every d,
    # one and seven queries, centres outside [0, N) (NaN) and the fill
    # pattern. Not bit-equal at any m: the kernel's Horner steps are fused
    # multiply-adds and it divides by s d times, where the plain version
    # rounds each product and divides once by s**d; hence the f32 / f64
    # gates above, scaled by max(1, max|want|).
    for B2 in (1, 3, 8, 17):
        for m2 in (0, 4, 7, 8, 12):
            pl = _random_planes(rng, m2, B2, n_data, dev[2].dtype, cuda)
            for nq2 in (1, 7, nq[queries]):
                tq2 = dev[3][:nq2]
                ctr2 = torch.clamp(torch.searchsorted(dev[2], tq2) - n, 0,
                                   n_data - 2 * n - 1) + n
                out_of_range = ctr2.clone()
                if nq2 > 1:
                    out_of_range[1], out_of_range[-1] = -1, n_data
                bad = out_of_range != ctr2
                for d in range(m2 + 1):
                    kw = dict(poly_order=m2, derivative=d, fill=-3.0)
                    c12.reset_launches()
                    got = c12.resample_eval_cuda(pl, dev[2], out_of_range,
                                                 tq2, **kw)
                    assert c12.LAUNCHES["resample"] == 1
                    want = c12.resample_eval_plain(pl, dev[2], ctr2, tq2,
                                                   **kw)
                    assert got.shape == (B2, nq2)
                    assert bool(got[:, bad].isnan().all())
                    g, w = got[:, ~bad], want[:, ~bad]
                    assert torch.equal(g == -3.0, w == -3.0)
                    _compare(g.cpu().numpy(), w.cpu().numpy(), tol)


@pytest.mark.cuda
def test_cuda_auto_route_and_launches(cuda):
    x, t, tq = _data(13, B=4, n_data=20_000, frac=0.0, dtype=np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (x, t, tq)]
    kw = dict(half_window=12, poly_order=4, fill=0.0)
    for mod in (c11, c12, cs):
        mod.reset_launches()
    ya = sgt.savgol_resample(*args, **kw)
    torch.cuda.synchronize()
    assert (c11.LAUNCHES, c12.LAUNCHES, cs.LAUNCHES["plane_solve_dd"]) == (
        {"nonuniform": 1}, {"resample": 1}, 0)
    yd = sgt.savgol_resample(*args, method="direct", **kw)
    torch.cuda.synchronize()
    assert (c11.LAUNCHES, c12.LAUNCHES, cs.LAUNCHES["plane_solve_dd"]) == (
        {"nonuniform": 1}, {"resample": 1}, 1)
    _compare(ya.cpu().numpy(), yd.cpu().numpy(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m", range(8))
def test_cuda_routes_at_every_compile_time_k(cuda, m):
    """Both routes at k = m + 1 = 1..8, each a compile-time instance: the
    auto route's K11p (L in shared memory at 7 and 8) and the direct
    route's K8b, against each other in float64."""
    x, t, tq = _data(14 + m, B=2, n_data=3000, frac=0.0, dtype=np.float64)
    args = [torch.from_numpy(a).to(cuda) for a in (x, t, tq)]
    kw = dict(half_window=12, poly_order=m, fill=0.0)
    for mod in (c11, c12, cs):
        mod.reset_launches()
    ya = sgt.savgol_resample(*args, **kw)
    yd = sgt.savgol_resample(*args, method="direct", **kw)
    torch.cuda.synchronize()
    assert (c11.LAUNCHES, c12.LAUNCHES, cs.LAUNCHES["plane_solve_dd"]) == (
        {"nonuniform": 1}, {"resample": 1}, 1)
    _compare(ya.cpu().numpy(), yd.cpu().numpy(), 1e-4)
