"""The filter bank of the port (``savgol_tpu_torch.SavgolBank``) and the
plain version of its kernel K4 (``ops.cuda_bank.bank_correlate_plain``)
against the JAX package.

On the CPU the port's ``method="auto"`` runs the bank route with K4's plain
version and ``"xla"`` the per-filter plain route; the JAX side runs its
vmapped ``"xla"`` route and the VPU bank kernel in interpret mode. The test
marked ``cuda`` holds K4 against its plain version on the card and skips
without one (on-card lane: ``python -m pytest --noconftest -m cuda
tests/test_torch_bank.py``).

Tolerance: f64 throughout against JAX, abs error <= 1e-12 * max(1,
max|ref|) (the bank route folds ``dt_inv`` into the taps and sums in
another order); f32 K4 against its plain version 2e-6 scaled, as K1.
"""

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch.ops import cuda_bank as cb

F64_TOL = 1e-12
F32_TOL = 2e-6
BOUNDARIES = ["polynomial", "reflect", "periodic", "constant"]
# mixed orders, derivatives and time steps over one window
MIXED = [(8, 4, 0, 1.0), (8, 4, 1, 0.5), (8, 3, 2, 0.5), (8, 6, 3, 0.25)]


@pytest.fixture(scope="module")
def jax_side():
    """(savgol_tpu, jax, jax.numpy); skips where JAX is not installed."""
    sg = pytest.importorskip("savgol_tpu")
    import jax
    import jax.numpy as jnp
    return sg, jax, jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _data(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _assert_close(got, want, tol=F64_TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} * {scale:.3e}"


def _banks(sg, jnp, boundary, spec=MIXED):
    jb = sg.SavgolBank.create(
        [sg.SavgolConfig(n, m, d, dt, sg.BoundaryMode(boundary))
         for n, m, d, dt in spec], dtype=jnp.float64)
    tb = sgt.SavgolBank.create(
        [sgt.SavgolConfig(n, m, d, dt, boundary) for n, m, d, dt in spec],
        dtype=torch.float64, device="cpu")
    return jb, tb


# -- K4's plain version ------------------------------------------------------


def test_bank_plain_matches_pallas(jax_side):
    """The VALID bank (pad 0) against the JAX package's VPU bank kernel in
    interpret mode (its row-folded thin-batch route at this size)."""
    _, _, jnp = jax_side
    from savgol_tpu.ops.pallas_conv import correlate_valid_bank_pallas
    x = _data((2, 20000), seed=7, dtype=np.float32)
    w = _data((4, 17), seed=8, dtype=np.float32)
    want = correlate_valid_bank_pallas(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True)
    got = cb.bank_correlate_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (4, 2, 20000 - 16)
    _assert_close(got.numpy(), want, F32_TOL)


@pytest.mark.parametrize("pad_mode", [None, "edge", "symmetric", "wrap"])
@pytest.mark.parametrize("pad", [0, 3, 32])
def test_bank_plain_is_a_padded_valid_correlation(pad, pad_mode):
    """Every stencil of the stack against numpy on the row padded by
    ``pad`` (rows of 20 samples are shorter than a pad of 32)."""
    w = _data((3, 7), seed=pad)
    for N in (20, 41):
        x = _data((2, N), seed=N)
        got = cb.bank_correlate_plain(torch.from_numpy(x), w, pad, pad_mode)
        xp = np.pad(x, ((0, 0), (pad, pad)),
                    mode=pad_mode if pad_mode else "constant")
        want = np.stack([np.stack([np.correlate(r, wk, "valid") for r in xp])
                         for wk in w])
        assert got.shape == (3, 2, N + 2 * pad - 6)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


def test_bank_wrapper_takes_plain_version_on_cpu():
    x = torch.from_numpy(_data((2, 300), seed=3))
    w = torch.from_numpy(_data((5, 9), seed=4))
    cb.reset_launches()
    assert torch.equal(cb.correlate_valid_bank_cuda(x, w, 4, "wrap"),
                       cb.bank_correlate_plain(x, w, 4, "wrap"))
    assert cb.LAUNCHES == {"corr1d_bank": 0}


# -- SavgolBank ---------------------------------------------------------------


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_bank_matches_jax(jax_side, boundary):
    sg, _, jnp = jax_side
    jb, tb = _banks(sg, jnp, boundary)
    x = _data((3, 300), seed=5)
    want = jb.apply(jnp.asarray(x), method="xla")
    for method in ("auto", "xla"):
        got = tb.apply(torch.from_numpy(x), method=method)
        assert got.shape == (4, 3, 300) and got.dtype == torch.float64
        _assert_close(got.numpy(), want)
    assert torch.equal(tb(torch.from_numpy(x)),
                       tb.apply(torch.from_numpy(x)))


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_bank_nonfinite_spread_matches_jax(jax_side, boundary):
    """NaN and inf samples, at the edges too, reach the same outputs as in
    the JAX bank (the edge fits multiply only their window's samples)."""
    sg, _, jnp = jax_side
    jb, tb = _banks(sg, jnp, boundary)
    x = _data((3, 300), seed=5)
    x[0, 0], x[0, 150], x[1, 299], x[1, 10], x[2, 20] = (
        np.nan, np.inf, -np.inf, np.nan, np.inf)
    want = np.asarray(jb.apply(jnp.asarray(x), method="xla"))
    for method in ("auto", "xla"):
        got = tb.apply(torch.from_numpy(x), method=method).numpy()
        for mask in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(mask(got), mask(want))
        fin = np.isfinite(want)
        assert 0 < fin.sum() < fin.size
        _assert_close(got[fin], want[fin])


@pytest.mark.parametrize("reference_edge_sign", [False, True])
def test_bank_edge_sign_and_axis(jax_side, reference_edge_sign):
    """The leading-edge sign rule over odd and even derivatives, and the
    ``axis`` rule (the output's K axis shifts positive axes by one)."""
    sg, _, jnp = jax_side
    jb, tb = _banks(sg, jnp, "polynomial")
    x = _data((4, 120, 3), seed=6)
    for axis in (1, -2):
        want = jb.apply(jnp.asarray(x), axis=axis,
                        reference_edge_sign=reference_edge_sign,
                        method="xla")
        for method in ("auto", "xla"):
            got = tb.apply(torch.from_numpy(x), axis=axis,
                           reference_edge_sign=reference_edge_sign,
                           method=method)
            assert got.shape == (4, 4, 120, 3)
            _assert_close(got.numpy(), want)


def test_bank_matches_independent_filters():
    """smooth + d1 + d2 through one bank equals three Savgol1D applies."""
    bank = sgt.SavgolBank.smooth_and_derivatives(6, 3, 2, time_step=0.5,
                                                 dtype=torch.float64,
                                                 device="cpu")
    assert bank.half_window == 6 and len(bank.configs) == 3
    x = torch.from_numpy(_data((2, 150), seed=9))
    out = bank.apply(x)
    for d in range(3):
        f = sgt.Savgol1D.create(sgt.SavgolConfig(6, 3, d, 0.5),
                                dtype=torch.float64, device="cpu")
        _assert_close(out[d].numpy(), f.apply(x).numpy())
    # a quadratic is reproduced exactly by each derivative order
    q = torch.from_numpy(0.5 * np.arange(60.0) ** 2)
    y = bank.apply(q)
    np.testing.assert_allclose(y[0].numpy(), q.numpy(), atol=1e-9)
    np.testing.assert_allclose(y[1].numpy(), np.arange(60.0) / 0.5,
                               atol=1e-8)
    np.testing.assert_allclose(y[2].numpy(), 1.0 / 0.25, atol=1e-8)


def test_bank_int_half_complex_input():
    bank = sgt.SavgolBank.smooth_and_derivatives(4, 2, 1, device="cpu")
    yi = bank.apply(torch.arange(50))
    assert yi.dtype == torch.float32
    np.testing.assert_allclose(yi[0].numpy(), np.arange(50.0), atol=2e-5)
    np.testing.assert_allclose(yi[1].numpy(), 1.0, atol=2e-5)
    x = _data((2, 80), seed=10, dtype=np.float32)
    yh = bank.apply(torch.from_numpy(x).to(torch.bfloat16))
    assert yh.dtype == torch.bfloat16
    want = bank.apply(torch.from_numpy(x).to(torch.bfloat16).float())
    assert torch.equal(yh, want.to(torch.bfloat16))
    xc = torch.from_numpy(x + 1j * x[::-1].copy())
    yc = bank.apply(xc)
    assert yc.dtype == torch.complex64 and yc.shape == (2, 2, 80)
    _assert_close(yc.real.numpy(), bank.apply(xc.real.contiguous()).numpy(),
                  F32_TOL)
    _assert_close(yc.imag.numpy(), bank.apply(xc.imag.contiguous()).numpy(),
                  F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_from_jax_gives_identical_buffers(jax_side, dtype):
    sg, jax, jnp = jax_side
    spec = [(5, 3, 0, 1.0), (5, 4, 1, 0.1)]
    jb = sg.SavgolBank.create([sg.SavgolConfig(*c) for c in spec],
                              dtype=getattr(jnp, dtype))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jb)]
    assert len(leaves) == 4
    cfgs = [sgt.SavgolConfig(*c) for c in spec]
    tx = sgt.SavgolBank.from_jax(cfgs, leaves, device="cpu")
    tc = sgt.SavgolBank.create(cfgs, dtype=getattr(torch, dtype),
                               device="cpu")
    names = ("center_weights", "edge_weights", "dt_inv", "lead_signs")
    assert tuple(dict(tx.named_buffers())) == names
    for name, leaf in zip(names, leaves):
        assert np.array_equal(getattr(tx, name).numpy(), leaf)
        assert getattr(tx, name).numpy().dtype == leaf.dtype
        assert np.array_equal(getattr(tc, name).numpy(), leaf)


def test_config_errors():
    with pytest.raises(ValueError, match="at least one"):
        sgt.SavgolBank.create([], device="cpu")
    with pytest.raises(ValueError, match="share"):
        sgt.SavgolBank.create([sgt.SavgolConfig(5, 3),
                               sgt.SavgolConfig(6, 3)], device="cpu")
    with pytest.raises(ValueError, match="share"):
        sgt.SavgolBank.create([sgt.SavgolConfig(5, 3),
                               sgt.SavgolConfig(5, 3, boundary="reflect")],
                              device="cpu")
    bank = sgt.SavgolBank.smooth_and_derivatives(5, 3, 1, device="cpu")
    x = torch.zeros(2, 100)
    with pytest.raises(ValueError, match="method"):
        bank.apply(x, method="mxu")
    with pytest.raises(ValueError, match="CUDA"):
        bank.apply(x, method="pallas")
    with pytest.raises(ValueError, match="window size"):
        bank.apply(x[:, :10])


@pytest.mark.parametrize("boundary", ["polynomial", "periodic"])
def test_gradients_match_jax_vjp(jax_side, boundary):
    """Gradients for x and every buffer through the bank route's
    autograd.Function (K4's plain version on the CPU), against jax.vjp of
    the JAX bank's "xla" route, in f64."""
    sg, jax, jnp = jax_side
    spec = [(5, 3, 0, 1.0), (5, 3, 1, 0.5)]
    jb, tb = _banks(sg, jnp, boundary, spec)
    x = _data((2, 90), seed=11)
    g = _data((2, 2, 90), seed=12)
    _, vjp = jax.vjp(lambda v, b: b.apply(v, method="xla"), jnp.asarray(x),
                     jb)
    gx_j, gb_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    names = ["center_weights", "dt_inv"]
    if boundary == "polynomial":
        names.append("edge_weights")
    params = [getattr(tb, k).requires_grad_() for k in names]
    got = torch.autograd.grad(tb.apply(xt), [xt, *params],
                              torch.from_numpy(g))
    want = [gx_j] + [getattr(gb_j, k) for k in names]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 3, 17, 40])
@pytest.mark.parametrize("ws", [3, 25, 65])
def test_cuda_bank_kernel_matches_plain(cuda, ws, K, dtype):
    tol = F32_TOL if dtype == torch.float32 else F64_TOL
    h = (ws - 1) // 2
    w = torch.from_numpy(_data((K, ws), seed=K + ws)).to(cuda, dtype)
    for B, N in ((1, 20), (3, 4099)):
        x = torch.from_numpy(_data((B, N), seed=N)).to(cuda, dtype)
        for pad, pad_mode in ((0, None), (h, None), (h, "edge"),
                              (h, "symmetric"), (32, "wrap")):
            if N + 2 * pad < ws:
                continue
            before = cb.LAUNCHES["corr1d_bank"]
            got = cb.correlate_valid_bank_cuda(x, w, pad, pad_mode)
            assert cb.LAUNCHES["corr1d_bank"] == before + 1
            want = cb.bank_correlate_plain(x, w, pad, pad_mode)
            _assert_close(got.cpu().numpy(), want.cpu().numpy(), tol)
    with pytest.raises(TypeError):
        cb.correlate_valid_bank_cuda(x.half(), w)
    with pytest.raises(ValueError, match="stencils"):
        cb.correlate_valid_bank_cuda(x, torch.ones(2, 66, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pad,pad_mode", [(0, None), (32, None),
                                          (32, "symmetric")])
def test_cuda_bank_kernel_nonfinite_matches_plain(cuda, pad, pad_mode, dtype):
    """NaN and inf samples at a row's ends, on both sides of a tile border
    (K4's tiles are 1024 outputs) and mid-tile, through stencils whose
    leading and trailing taps are zero (the sweep's shape) and a full one:
    the non-finite outputs sit exactly where the plain version's do, 0 *
    inf included."""
    tol = F32_TOL if dtype == torch.float32 else F64_TOL
    w = _data((5, 65), seed=10)
    for k, (lead, trail) in enumerate(((0, 0), (20, 20), (32, 0), (3, 40),
                                       (64, 0))):
        w[k, :lead] = 0.0
        w[k, 65 - trail:] = 0.0
    x = _data((6, 4099), seed=11)
    for i, (j, v) in enumerate(((0, np.nan), (1023, np.inf),
                                (1024, -np.inf), (511, np.nan),
                                (4098, np.inf), (2000, np.nan))):
        x[i, j] = v
    x[5, 2005] = np.inf
    xc, wc = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    got = cb.correlate_valid_bank_cuda(xc, wc, pad, pad_mode).cpu().numpy()
    want = cb.bank_correlate_plain(xc, wc, pad, pad_mode).cpu().numpy()
    for mask in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(mask(got), mask(want))
    fin = np.isfinite(want)
    assert 0 < fin.sum() < fin.size
    _assert_close(got[fin], want[fin], tol)


@pytest.mark.cuda
def test_cuda_savgol_bank_is_one_launch(cuda):
    bank = sgt.SavgolBank.smooth_and_derivatives(12, 4, 2, device=cuda)
    x = torch.randn(4, 5000, device=cuda)
    before = cb.LAUNCHES["corr1d_bank"]
    got = bank.apply(x)
    assert cb.LAUNCHES["corr1d_bank"] == before + 1
    _assert_close(got.cpu().numpy(),
                  bank.apply(x, method="xla").cpu().numpy(), F32_TOL)
