"""The (n, m) sweep of the port (``savgol_tpu_torch.ops.sweep``) against the
JAX package's ``savgol_tpu.ops.sweep``.

On the CPU the port runs the plain version of its bank kernel K4; the JAX
side runs its ``method="xla"`` route (the C-output-channel conv). The test
marked ``cuda`` holds the K4 route against the plain route on the card and
skips without one (on-card lane: ``python -m pytest --noconftest -m cuda
tests/test_torch_sweep.py``).

Tolerance: f64 throughout, 1e-12 (the weights' einsums and the center
correlation sum in other orders on the two sides); the zeros outside each
window are exact on both. With NaN and inf samples the non-finite outputs
agree exactly and the rest within the sweep's 2e-5.
"""

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch.ops import cuda_bank as cb
from savgol_tpu_torch.ops.sweep import (savgol_apply_sweep,
                                        savgol_weights_masked)

M_ = 32
TOL = 1e-12
BOUNDARIES = ["polynomial", "reflect", "periodic", "constant"]
NS, MS = [2, 5, 12, 32], [2, 3, 4, 6]


@pytest.fixture(scope="module")
def jax_side():
    """(savgol_tpu, the JAX sweep module, jax.numpy); skips where JAX is
    not installed."""
    sg = pytest.importorskip("savgol_tpu")
    from savgol_tpu.ops import sweep as js
    import jax.numpy as jnp
    return sg, js, jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _assert_close(got, want, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} * {scale:.3e}"


# -- the masked weights --------------------------------------------------------


@pytest.mark.parametrize("n,m,d", [(1, 1, 0), (5, 3, 0), (12, 4, 0),
                                   (12, 4, 2), (32, 10, 4), (2, 2, 1)])
def test_weights_match_jax(jax_side, n, m, d):
    _, js, jnp = jax_side
    want = js.savgol_weights_masked(jnp.asarray(n), jnp.asarray(m), d,
                                    dtype=jnp.float64)
    got = savgol_weights_masked(n, m, d, torch.float64, device="cpu")
    for g, w in zip(got, want):
        w = np.asarray(w)
        _assert_close(g.numpy(), w)
        # the zeros outside the window and below row n are exact on both
        assert np.array_equal(g.numpy() == 0, w == 0)


def test_weights_vectorised_over_configs():
    """One call for a tensor of configs equals the calls one at a time."""
    ns, ms = torch.tensor([1, 4, 9, 32]), torch.tensor([0, 3, 5, 10])
    c, lead, trail = savgol_weights_masked(ns, ms, 1, torch.float64)
    assert c.shape == (4, 65) and lead.shape == trail.shape == (4, 32, 65)
    for i in range(4):
        for a, b in zip((c[i], lead[i], trail[i]),
                        savgol_weights_masked(int(ns[i]), int(ms[i]), 1,
                                              torch.float64, device="cpu")):
            assert torch.equal(a, b)


def test_weights_match_host_tables_and_mirror():
    """The window slice holds the static generator's stencil, and lead[e]
    is trail[e] mirrored with (-1)^d."""
    for n, m, d in ((6, 3, 1), (12, 4, 2), (30, 9, 3)):
        c, lead, trail = savgol_weights_masked(n, m, d, torch.float64,
                                               device="cpu")
        c_ref, e_ref = sgt.savgol_weights_np(sgt.SavgolConfig(n, m, d),
                                             np.float64)
        np.testing.assert_allclose(c[M_ - n:M_ + n + 1].numpy(), c_ref,
                                   atol=1e-9)
        np.testing.assert_allclose(trail[:n, M_ - n:M_ + n + 1].numpy(),
                                   e_ref, atol=1e-8)
        np.testing.assert_allclose(
            lead[:n, M_ - n:M_ + n + 1].numpy(),
            (-1) ** d * trail[:n, M_ - n:M_ + n + 1].flip(-1).numpy(),
            atol=1e-9)


def test_weights_device_defaults_to_the_card():
    """Integer configs name no device, so the weights go to the card: with
    no card that raises and names ``device="cpu"`` instead of computing on
    the CPU unasked. Tensor configs keep their own device."""
    if not torch.cuda.is_available():
        for n, m in ((12, 4), ([2, 5], [1, 3])):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                savgol_weights_masked(n, m)
    c, _, _ = savgol_weights_masked(12, 4, device="cpu")
    assert c.device.type == "cpu"
    c, _, _ = savgol_weights_masked(torch.tensor([2, 5]), [1, 3])
    assert c.device == torch.device("cpu") and c.shape == (2, 65)


@pytest.mark.parametrize("n", [1, 2, 3, 32])
def test_no_nans_across_full_grid(n):
    """Every valid (n, m) gives finite weights: the k > m guard stops the
    invalid denominators' NaN from propagating."""
    ms = list(range(0, min(2 * n, 10) + 1))
    c, lead, trail = savgol_weights_masked([n] * len(ms), ms, 0,
                                           torch.float32, device="cpu")
    for a in (c, lead, trail):
        assert bool(torch.isfinite(a).all()), (n, ms)


# -- the sweep ----------------------------------------------------------------


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_sweep_matches_jax(jax_side, boundary):
    """A batched input under four configs up to n = 32, dt_inv folded."""
    sg, js, jnp = jax_side
    x = _data((2, 300), seed=0)
    want = js.savgol_apply_sweep(jnp.asarray(x), jnp.asarray(NS),
                                 jnp.asarray(MS),
                                 boundary=sg.BoundaryMode(boundary),
                                 dt_inv=2.0, dtype=jnp.float64,
                                 method="xla")
    for method in ("auto", "xla"):
        got = savgol_apply_sweep(torch.from_numpy(x), NS, MS,
                                 boundary=boundary, dt_inv=2.0,
                                 dtype=torch.float64, method=method)
        assert got.shape == (4, 2, 300) and got.dtype == torch.float64
        _assert_close(got.numpy(), want)


@pytest.mark.parametrize("reference_edge_sign", [False, True])
def test_sweep_derivative_matches_jax(jax_side, reference_edge_sign):
    _, js, jnp = jax_side
    x = _data(200, seed=1)
    ns, ms = [5, 8, 12], [3, 4, 5]
    want = js.savgol_apply_sweep(jnp.asarray(x), jnp.asarray(ns),
                                 jnp.asarray(ms), derivative=1,
                                 reference_edge_sign=reference_edge_sign,
                                 dtype=jnp.float64, method="xla")
    got = savgol_apply_sweep(torch.from_numpy(x), torch.tensor(ns),
                             np.asarray(ms), derivative=1,
                             reference_edge_sign=reference_edge_sign,
                             dtype=torch.float64)
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_sweep_matches_savgol1d(boundary):
    """Every config of the sweep equals the static-config filter."""
    x = torch.from_numpy(_data((3, 150), seed=2))
    out = savgol_apply_sweep(x, [4, 9], [2, 3], derivative=1,
                             boundary=boundary, dtype=torch.float64)
    assert out.shape == (2, 3, 150)
    for c, (n, m) in enumerate(((4, 2), (9, 3))):
        f = sgt.Savgol1D.create(sgt.SavgolConfig(n, m, 1), torch.float64,
                                device="cpu")
        _assert_close(out[c].numpy(), f.apply(x, boundary=boundary).numpy(),
                      1e-9)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_short_input_above_window(jax_side, boundary):
    """N >= 2n+1 but N = 20 < 32: the pad of 32 is wider than the row.
    Against the static-config filter, and the JAX sweep where the pad and
    the edge fit differ most (zeros past a short row, symmetric reflection
    past its period)."""
    sg, js, jnp = jax_side
    x = _data(20, seed=5)
    got = savgol_apply_sweep(torch.from_numpy(x), [4, 2], [2, 1],
                             boundary=boundary, dtype=torch.float64)
    for c, (n, m) in enumerate(((4, 2), (2, 1))):
        f = sgt.Savgol1D.create(sgt.SavgolConfig(n, m), torch.float64,
                                device="cpu")
        _assert_close(got[c].numpy(),
                      f.apply(torch.from_numpy(x), boundary=boundary).numpy(),
                      1e-9)
    if boundary in ("polynomial", "reflect"):
        want = js.savgol_apply_sweep(jnp.asarray(x), jnp.asarray([4, 2]),
                                     jnp.asarray([2, 1]),
                                     boundary=sg.BoundaryMode(boundary),
                                     dtype=jnp.float64, method="xla")
        _assert_close(got.numpy(), want)


def _nonfinite(shape, seed):
    """Random rows with NaN, +inf and -inf samples at a row's first and last
    sample, near the edges (inside and past the sweep's pad of 32) and in
    the middle, and +inf beside -inf (their sum is NaN)."""
    x = _data(shape, seed)
    x[0, 0], x[0, 150], x[0, 40] = np.nan, np.inf, -np.inf
    x[1, -1], x[1, 3], x[1, -60] = -np.inf, np.nan, np.inf
    x[2, 100], x[2, 110], x[2, 60] = np.inf, -np.inf, np.nan
    return x


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_sweep_nonfinite_spread_matches_jax(jax_side, boundary, dtype):
    """NaN and inf spread as in the JAX sweep: every output whose 65-tap
    window holds a non-finite sample is NaN or inf, in the same places (0 *
    inf is NaN), the edge fits' too; the rest agree within the sweep's
    2e-5. This is the spread the trimmed K4 keeps on the card."""
    sg, js, jnp = jax_side
    x = _nonfinite((3, 300), 8).astype(dtype)
    want = np.asarray(js.savgol_apply_sweep(
        jnp.asarray(x), jnp.asarray(NS), jnp.asarray(MS),
        boundary=sg.BoundaryMode(boundary), dtype=getattr(jnp, dtype),
        method="xla"))
    got = savgol_apply_sweep(torch.from_numpy(x), NS, MS, boundary=boundary,
                             dtype=getattr(torch, dtype),
                             method="xla").numpy()
    for mask in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(mask(got), mask(want))
    fin = np.isfinite(want)
    assert 0 < fin.sum() < fin.size
    _assert_close(got[fin], want[fin], 2e-5)


def test_too_short_input_raises():
    with pytest.raises(ValueError, match="widest window"):
        savgol_apply_sweep(torch.arange(20.0), [12], [3])


@pytest.mark.parametrize("boundary", ["polynomial", "constant"])
def test_integer_input_promoted(jax_side, boundary):
    """Integer data is promoted to the sweep's dtype (casting the float
    weights down to int would truncate them to zero)."""
    sg, js, jnp = jax_side
    xi = np.arange(100, dtype=np.int32)[None]
    got = savgol_apply_sweep(torch.from_numpy(xi), [2], [2],
                             dtype=torch.float64, boundary=boundary)
    assert got.dtype == torch.float64 and got.shape == (1, 1, 100)
    # smoothing a ramp reproduces the ramp in the interior
    np.testing.assert_allclose(got[0, 0, 10:90].numpy(),
                               np.arange(10.0, 90.0), atol=1e-8)
    if boundary == "polynomial":
        want = js.savgol_apply_sweep(jnp.asarray(xi), jnp.asarray([2]),
                                     jnp.asarray([2]), dtype=jnp.float64,
                                     method="xla")
        _assert_close(got.numpy(), want)


def test_sweep_methods_and_configs():
    x = torch.from_numpy(_data(100, seed=6))
    cb.reset_launches()
    base = savgol_apply_sweep(x, [3], [2], dtype=torch.float64)
    assert cb.LAUNCHES == {"corr1d_bank": 0}
    assert torch.equal(base, savgol_apply_sweep(x, [3], [2], method="xla",
                                                dtype=torch.float64))
    for method in ("pallas", "mxu", "mxu_bank"):
        with pytest.raises(ValueError, match="CUDA"):
            savgol_apply_sweep(x, [3], [2], method=method)
    with pytest.raises(ValueError, match="method"):
        savgol_apply_sweep(x, [3], [2], method="conv")
    with pytest.raises(ValueError, match="invalid sweep config"):
        savgol_apply_sweep(x, [3], [7])
    with pytest.raises(ValueError, match="poly_order"):
        savgol_apply_sweep(x, [3, 4], [2])
    # linear data is preserved by every config, in float32 too
    ramp = torch.arange(100.0)
    out = savgol_apply_sweep(ramp, list(range(1, 9)),
                             [1, 2, 2, 3, 3, 3, 4, 4])
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(
        np.arange(100.0), (8, 100)), atol=1e-3)


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_cuda_sweep_matches_plain_route(cuda, boundary, dtype):
    tol = 2e-6 if dtype == torch.float32 else TOL
    for shape in ((20,), (3, 4099)):
        x = torch.from_numpy(_data(shape, seed=7)).to(cuda, dtype)
        ns, ms = ([4, 2], [2, 1]) if shape == (20,) else (NS, MS)
        before = cb.LAUNCHES["corr1d_bank"]
        got = savgol_apply_sweep(x, ns, ms, derivative=1, boundary=boundary,
                                 dt_inv=0.5, dtype=dtype)
        assert cb.LAUNCHES["corr1d_bank"] == before + 1
        want = savgol_apply_sweep(x, ns, ms, derivative=1,
                                  boundary=boundary, dt_inv=0.5,
                                  dtype=dtype, method="xla")
        assert cb.LAUNCHES["corr1d_bank"] == before + 1
        _assert_close(got.cpu().numpy(), want.cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_cuda_sweep_nonfinite_matches_plain_route(cuda, boundary):
    """The trimmed K4 keeps the plain route's NaN / inf spread."""
    x = torch.from_numpy(_nonfinite((3, 4099), 9)).to(cuda, torch.float32)
    got = savgol_apply_sweep(x, NS, MS, boundary=boundary).cpu().numpy()
    want = savgol_apply_sweep(x, NS, MS, boundary=boundary,
                              method="xla").cpu().numpy()
    for mask in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(mask(got), mask(want))
    fin = np.isfinite(want)
    _assert_close(got[fin], want[fin], 2e-6)
