"""The padded-boundary 1D path of the port against the JAX package: the
plain version of kernel K2 (``ops.cuda_conv.savgol_padded_plain``),
``Savgol1D.apply`` with the REFLECT / PERIODIC / CONSTANT boundaries, its
gradients, and the scipy drop-in ``savgol_tpu_torch.scipy_compat``.

On the CPU the port runs the plain PyTorch versions of its kernels; the JAX
side runs the fused-pad Pallas kernel in interpret mode, its XLA twin, and
``savgol_tpu.scipy_compat``. The test marked ``cuda`` holds K2 against its
plain version on the card and skips without one (on-card lane:
``python -m pytest --noconftest -m cuda tests/test_torch_padded.py``).

K2's schedule on the exact 1D tile (``tests/_exact_plan.py`` with off =
-n, ``csrc/sg1d_exact.cuh``) is checked on the CPU: the samples a pad mode
maps lie only in a row's end tiles, and staging each tile with the mode's
index map and storing by the plan gives ``savgol_padded_plain``.

Tolerance for f32: abs error <= 2e-6 * max(1, max|ref|), for the reason
given in ``tests/test_torch_conv.py`` (summation order, ``dt_inv`` folded
into the taps on one side). f64 and scipy comparisons: 1e-9 (scipy's lstsq
weights carry ~1e-12 of their own error).
"""

import numpy as np
import pytest
import torch
from _exact_plan import exact_tile_plan
from scipy.signal import savgol_coeffs as sp_coeffs
from scipy.signal import savgol_filter as sp_filter

import savgol_tpu_torch as sgt
from savgol_tpu_torch import scipy_compat as tsc
from savgol_tpu_torch.ops import cuda_conv as cc

F32_TOL = 2e-6
PAD_BOUNDARIES = ["reflect", "periodic", "constant"]
PAD_MODES = {"reflect": "symmetric", "periodic": "wrap", "constant": "edge"}
SCIPY_MODES = ["interp", "mirror", "nearest", "wrap", "constant"]


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


def _data(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _assert_close(got, want, tol=F32_TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} * {scale:.3e}"


def _filters(sg, jnp, n, d=0, dtype="float32"):
    kw = dict(half_window=n, poly_order=min(4, 2 * n), derivative=d,
              time_step=0.5)
    fj = sg.Savgol1D.create(sg.SavgolConfig(**kw), dtype=getattr(jnp, dtype))
    ft = sgt.Savgol1D.create(sgt.SavgolConfig(**kw),
                             dtype=getattr(torch, dtype), device="cpu")
    return fj, ft


# -- K2's plain version against the fused-pad Pallas kernel -----------------


@pytest.mark.parametrize("pad_mode,N,n", [("symmetric", 12289, 12),
                                          ("wrap", 512, 6),
                                          ("edge", 1000, 32)])
def test_padded_plain_matches_pallas(jax_side, pad_mode, N, n):
    """One interpret-mode call a mode; N = 12289 is the JAX package's
    inadmissible block length (its jnp.pad + VALID-kernel fallback)."""
    sg, _, jnp = jax_side
    from savgol_tpu.ops import pallas_conv as pc
    fj, ft = _filters(sg, jnp, n, d=1)
    x = _data((3, N), seed=N + n)
    want = pc.savgol_padded_pallas_mxu(jnp.asarray(x), fj.center_weights,
                                       pad_mode, n, dt_inv=fj.dt_inv,
                                       interpret=True)
    got = cc.savgol_padded_plain(torch.from_numpy(x), ft.center_weights,
                                 pad_mode, n, ft.dt_inv)
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("pad_mode", ["symmetric", "wrap", "edge",
                                      "reflect"])
@pytest.mark.parametrize("n", [1, 3, 7, 20])
def test_pad_index_matches_numpy_for_any_width(pad_mode, n):
    """The host twin of the kernels' index map, for rows shorter than the
    pad too."""
    for N in (2, 5, 9, 40):
        x = np.arange(N, dtype=np.float64) * 1.5 - 2.0
        got = cc.pad_last(torch.from_numpy(x), n, pad_mode).numpy()
        np.testing.assert_array_equal(got, np.pad(x, n, mode=pad_mode))
    x = np.arange(6.0)
    np.testing.assert_array_equal(cc.pad_last(torch.from_numpy(x), n,
                                              None).numpy(), np.pad(x, n))


@pytest.mark.parametrize("pad_mode", [None, "constant", "edge", "wrap",
                                      "symmetric", "reflect"])
def test_pad_last_counts_its_mode_after_the_pad(pad_mode):
    """Each host pad adds one to its mode's count in ``PADS`` and its
    padded bytes; a pad that raises adds nothing."""
    x = torch.arange(10, dtype=torch.float64).reshape(2, 5)
    before = dict(cc.PADS)
    y = cc.pad_last(x, 3, pad_mode, 7.0)
    want = np.pad(x.numpy(), ((0, 0), (3, 3)), mode=pad_mode or "constant",
                  **({"constant_values": 7.0} if pad_mode == "constant"
                     else {}))
    np.testing.assert_array_equal(y.numpy(), want)
    with pytest.raises(ValueError):
        cc.pad_last(x, 3, "bogus")
    added = {k: cc.PADS[k] - before[k] for k in before}
    assert added == {**dict.fromkeys(before, 0), pad_mode or "zeros": 1,
                     "bytes": 2 * 11 * 8}


def test_a_mirror_call_counts_one_reflect_pad_and_its_bytes():
    before = dict(cc.PADS)
    tsc.savgol_filter(torch.zeros(3, 100), 25, 4, mode="mirror")
    added = {k: cc.PADS[k] - before[k] for k in before}
    assert added == {**dict.fromkeys(before, 0), "reflect": 1,
                     "bytes": 3 * 124 * 4}


def test_padded_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    x = torch.from_numpy(_data((2, 300), seed=3))
    w = torch.from_numpy(_data(11, seed=4))
    cc.reset_launches()
    for pad_mode in PAD_MODES.values():
        assert torch.equal(cc.savgol_padded_cuda(x, w, pad_mode, 5, 0.25),
                           cc.savgol_padded_plain(x, w, pad_mode, 5, 0.25))
    assert cc.LAUNCHES == {"sg1d_poly": 0, "sg1d_pad": 0, "corr1d_valid": 0}
    # numpy's reflect (scipy's mirror) is the host pad, the VALID
    # correlation and the multiply, bit for bit
    assert torch.equal(cc.savgol_padded_plain(x, w, "reflect", 5, 0.25),
                       cc.correlate_valid_plain(cc.pad_last(x, 5, "reflect"),
                                                w) * 0.25)
    with pytest.raises(ValueError, match="pad mode"):
        cc.savgol_padded_plain(x, w, "bogus", 5)


@pytest.mark.parametrize("n", [1, 2, 12, 64])
def test_padded_plain_reflect_matches_numpy_at_every_length(n):
    """``savgol_padded_plain`` in numpy's reflect from one window long,
    where the reflections at both ends meet, to many tiles long, against
    ``np.pad(mode="reflect")`` and the window sums in float64."""
    ws = 2 * n + 1
    w = _data(ws, seed=n, dtype=np.float64)
    for N in (ws, ws + 1, 2 * ws + 3, 4099):
        x = _data((2, N), seed=N + n, dtype=np.float64)
        got = cc.savgol_padded_plain(torch.from_numpy(x), torch.from_numpy(w),
                                     "reflect", n, 0.5).numpy()
        win = np.lib.stride_tricks.sliding_window_view(
            np.pad(x, ((0, 0), (n, n)), mode="reflect"), ws, axis=-1)
        np.testing.assert_allclose(got, (win @ w) * 0.5, rtol=0, atol=1e-12)


# -- Savgol1D.apply with a pad boundary ---------------------------------------


@pytest.mark.parametrize("boundary", PAD_BOUNDARIES)
def test_apply_matches_jax(jax_side, boundary):
    sg, _, jnp = jax_side
    fj, ft = _filters(sg, jnp, 6, d=1)
    bj = sg.BoundaryMode(boundary)
    x = _data((3, 517), seed=11)
    got = ft.apply(torch.from_numpy(x), boundary=boundary)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _assert_close(got.numpy(), fj.apply(jnp.asarray(x), boundary=bj,
                                        method="xla"))
    # the CPU auto route is the plain version itself
    assert torch.equal(got, ft.apply(torch.from_numpy(x), boundary=boundary,
                                     method="xla"))
    x3 = _data((60, 3, 2), seed=12)
    got0 = ft.apply(torch.from_numpy(x3), axis=0, boundary=boundary)
    _assert_close(got0.numpy(), fj.apply(jnp.asarray(x3), axis=0,
                                         boundary=bj, method="xla"))


@pytest.mark.parametrize("boundary", PAD_BOUNDARIES)
def test_int_half_complex_input(jax_side, boundary):
    """Integer input promotes to the weights' dtype, half input computes in
    f32 and rounds once, complex input is filtered part by part."""
    sg, _, jnp = jax_side
    fj, ft = _filters(sg, jnp, 3)
    bj = sg.BoundaryMode(boundary)
    yi = ft.apply(torch.arange(40), boundary=boundary)
    assert yi.dtype == torch.float32
    _assert_close(yi.numpy(), fj.apply(jnp.arange(40), boundary=bj,
                                       method="xla"))
    x = _data((2, 90), seed=13)
    for half, ulp in ((torch.bfloat16, 2.0 ** -7), (torch.float16, 2.0 ** -10)):
        yh = ft.apply(torch.from_numpy(x).to(half), boundary=boundary)
        assert yh.dtype == half
        want = ft.apply(torch.from_numpy(x).to(half).float(),
                        boundary=boundary).double().numpy()
        got = yh.double().numpy()
        assert np.all(np.abs(got - want)
                      <= ulp * np.maximum(np.abs(want), 1.0))
    xc = (x + 1j * _data((2, 90), seed=14)).astype(np.complex64)
    yc = ft.apply(torch.from_numpy(xc), boundary=boundary)
    assert yc.dtype == torch.complex64
    wc = np.asarray(fj.apply(jnp.asarray(xc), boundary=bj, method="xla"))
    _assert_close(yc.numpy().real, wc.real)
    _assert_close(yc.numpy().imag, wc.imag)


@pytest.mark.parametrize("boundary", PAD_BOUNDARIES)
def test_gradients_match_jax_vjp(jax_side, boundary):
    """Gradients for x, the stencil and dt_inv through the kernel route's
    autograd.Function (the plain version on the CPU), against jax.vjp of
    ``_pallas_pad_diff``'s XLA twin (jnp.pad + the VALID correlation), in
    f64."""
    sg, jax, jnp = jax_side
    from savgol_tpu.ops.apply import correlate_valid
    n, pm = 5, PAD_MODES[boundary]
    fj, ft = _filters(sg, jnp, n, d=1, dtype="float64")
    x = _data((3, 201), seed=20, dtype=np.float64)
    g = _data((3, 201), seed=21, dtype=np.float64)

    def twin(xv, cw, dt):
        xp = jnp.pad(xv, ((0, 0), (n, n)), mode=pm)
        return correlate_valid(xp, cw) * dt

    _, vjp = jax.vjp(twin, jnp.asarray(x), fj.center_weights, fj.dt_inv)
    want = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    cw = ft.center_weights.clone().requires_grad_()
    dt = ft.dt_inv.clone().requires_grad_()
    y = sgt.savgol_apply(xt, cw, half_window=n, boundary=boundary,
                         dt_inv=dt, derivative=1)
    got = torch.autograd.grad(y, [xt, cw, dt], torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


def test_kernel_methods_need_cuda():
    ft = sgt.Savgol1D.create(sgt.SavgolConfig(4, 2), device="cpu")
    x = torch.from_numpy(_data((2, 100), seed=9))
    for method in ("pallas", "mxu"):
        with pytest.raises(ValueError, match="CUDA"):
            ft.apply(x, boundary="periodic", method=method)
    # "bf16" needs no card: a CPU tensor takes K2's bf16 plain version
    np.testing.assert_array_equal(
        ft.apply(x, boundary="reflect", method="bf16").numpy(),
        cc.savgol_padded_bf16_plain(x, ft.center_weights, "symmetric", 4,
                                    ft.dt_inv).numpy())


# -- scipy_compat ------------------------------------------------------------


@pytest.fixture(scope="module")
def row():
    return np.random.default_rng(0).standard_normal(400)


@pytest.mark.parametrize("wl,po,d", [(25, 4, 0), (11, 3, 1), (101, 4, 1)])
@pytest.mark.parametrize("mode", SCIPY_MODES)
def test_savgol_filter_matches_scipy_and_jax(jax_side, row, mode, wl, po, d):
    """Every mode against scipy in f64, and against the JAX module; window
    101 is past the reference caps (the direct Gram path)."""
    _, _, jnp = jax_side
    from savgol_tpu import scipy_compat as jsc
    got = tsc.savgol_filter(torch.from_numpy(row), wl, po, deriv=d,
                            delta=0.5, mode=mode, cval=1.5)
    assert got.dtype == torch.float64 and got.shape == row.shape
    ref = sp_filter(row, wl, po, deriv=d, delta=0.5, mode=mode, cval=1.5)
    scale = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-9 * scale)
    want = jsc.savgol_filter(jnp.asarray(row), wl, po, deriv=d, delta=0.5,
                             mode=mode, cval=1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


@pytest.mark.parametrize("mode", SCIPY_MODES)
def test_savgol_filter_axis_and_f32(row, mode):
    a = np.stack([row[:120], row[120:240]], axis=1)          # (120, 2)
    got = tsc.savgol_filter(torch.from_numpy(a), 11, 3, axis=0, mode=mode)
    np.testing.assert_allclose(got.numpy(),
                               sp_filter(a, 11, 3, axis=0, mode=mode),
                               atol=1e-9)
    got32 = tsc.savgol_filter(torch.from_numpy(row.astype(np.float32)), 25,
                              4, mode=mode)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), sp_filter(row, 25, 4,
                                                        mode=mode),
                               atol=1e-5)


@pytest.mark.parametrize("dtype, tol", [(np.float32, F32_TOL),
                                        (np.float64, 1e-9)])
@pytest.mark.parametrize("N", [25, 26, 37, 4096])
def test_savgol_filter_mirror_matches_scipy_at_every_length(N, dtype, tol):
    """``mode="mirror"`` at window 25, order 4 (the host reflect pad, then
    the VALID correlation) on rows from one window long, where the
    reflections at both ends meet, to many tiles long."""
    x = _data((3, N), N, dtype)
    got = tsc.savgol_filter(x, 25, 4, mode="mirror", device="cpu")
    assert got.dtype == x.dtype and got.shape == x.shape
    _assert_close(got, sp_filter(x.astype(np.float64), 25, 4,
                                 mode="mirror"), tol)


def test_savgol_filter_corners(row):
    x = torch.from_numpy(row)
    # scipy semantics: the fit's higher derivatives vanish
    assert torch.equal(tsc.savgol_filter(x, 11, 3, deriv=4),
                       torch.zeros_like(x))
    assert tsc.savgol_filter(torch.arange(30), 11, 3, deriv=4).dtype == \
        torch.float32
    yi = tsc.savgol_filter(torch.arange(30), 5, 1, mode="mirror")
    np.testing.assert_allclose(yi.numpy(), sp_filter(np.arange(30.0), 5, 1,
                                                     mode="mirror"),
                               atol=1e-5)
    xc = torch.from_numpy(row + 1j * row[::-1].copy())
    yc = tsc.savgol_filter(xc, 11, 3, mode="constant", cval=0.0)
    np.testing.assert_allclose(yc.numpy().real, sp_filter(row, 11, 3,
                                                          mode="constant"),
                               atol=1e-9)
    with pytest.raises(ValueError, match="odd"):
        tsc.savgol_filter(x, 10, 3)
    with pytest.raises(ValueError, match="polyorder"):
        tsc.savgol_filter(x, 11, 11)
    with pytest.raises(ValueError, match="mode"):
        tsc.savgol_filter(x, 11, 3, mode="banana")
    with pytest.raises(ValueError, match="method"):
        tsc.savgol_filter(x, 11, 3, mode="mirror", method="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tsc.savgol_filter(x, 11, 3, mode="wrap", method="pallas")
    with pytest.raises(ValueError, match="window_length"):
        tsc.savgol_filter(x[:9], 11, 3, mode="mirror")


@pytest.mark.parametrize("wl,po,d,pos", [
    (11, 3, 1, None), (11, 3, 1, 0), (11, 3, 1, 8), (11, 3, 2, 2.25),
    (9, 4, 1, 3.5), (15, 6, 5, 7.5), (13, 5, 5, 2), (101, 5, 5, None),
    (75, 12, 2, None), (33, 14, 14, 30)])
def test_savgol_coeffs_match_jax_module(jax_side, wl, po, d, pos):
    """Past the reference caps (window 101, order 12 and 14, deriv 5-14)
    and at fractional pos: the JAX module's numbers, and scipy's where its
    lstsq is exact enough to compare (window <= 33, order <= 6)."""
    from savgol_tpu import scipy_compat as jsc
    for use in ("conv", "dot"):
        got = tsc.savgol_coeffs(wl, po, deriv=d, delta=0.5, pos=pos, use=use)
        want = jsc.savgol_coeffs(wl, po, deriv=d, delta=0.5, pos=pos,
                                 use=use)
        np.testing.assert_array_equal(got, want)
        if po <= 6:
            ref = sp_coeffs(wl, po, deriv=d, delta=0.5, pos=pos, use=use)
            scale = max(1.0, np.abs(ref).max())
            np.testing.assert_allclose(got, ref, atol=1e-8 * scale)


def test_savgol_filter_takes_numpy_input(row):
    """The import swap: numpy input is computed on ``device`` (the card by
    default, which raises without one and names the CPU option) as a tensor
    would be, and comes back as a numpy array, as scipy returns it; a
    tensor comes back as a tensor."""
    want = tsc.savgol_filter(torch.from_numpy(row), 25, 4, mode="wrap")
    assert isinstance(want, torch.Tensor)
    got = tsc.savgol_filter(row, 25, 4, mode="wrap", device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want.numpy())
    if torch.cuda.is_available():
        default = tsc.savgol_filter(row, 25, 4, mode="wrap")
        assert isinstance(default, np.ndarray)
        np.testing.assert_allclose(default, want.numpy(), atol=1e-12)
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tsc.savgol_filter(row, 25, 4, mode="wrap")


@pytest.mark.parametrize("mode", SCIPY_MODES)
def test_savgol_filter_returns_what_it_was_given(row, mode):
    """numpy in, numpy out (np.asarray works on the result, as on scipy's);
    a list too; a tensor in, a tensor out on its own device; the zero
    output of deriv > polyorder as well."""
    for x in (row, list(row[:60])):
        y = tsc.savgol_filter(x, 11, 3, mode=mode, device="cpu")
        assert isinstance(y, np.ndarray)
        np.testing.assert_allclose(np.asarray(y), sp_filter(
            np.asarray(x), 11, 3, mode=mode), atol=1e-9)
    assert isinstance(tsc.savgol_filter(row, 11, 3, deriv=4, mode=mode,
                                        device="cpu"), np.ndarray)
    t = torch.from_numpy(row)
    yt = tsc.savgol_filter(t, 11, 3, mode=mode)
    assert isinstance(yt, torch.Tensor) and yt.device == t.device


def exact_weights(n, m, t):
    """Exact least-squares smoothing weights of the window [-n, n] at
    position t, by the rational Vandermonde normal equations: the oracle of
    ``tests/test_weights.py::exact_weights`` (d = 0), kept here because that
    module imports JAX and the ``cuda`` tests run without it."""
    from fractions import Fraction
    pts = range(-n, n + 1)
    A = [[Fraction(i) ** k for k in range(m + 1)] for i in pts]
    M = [[sum(a[i] * a[j] for a in A) for j in range(m + 1)]
         + [Fraction(t) ** i] for i in range(m + 1)]
    for col in range(m + 1):
        piv = max(range(col, m + 1), key=lambda r: abs(M[r][col]))
        M[col], M[piv] = M[piv], M[col]
        for r in range(m + 1):
            if r != col and M[r][col] != 0:
                f = M[r][col] / M[col][col]
                M[r] = [a - f * b for a, b in zip(M[r], M[col])]
    y = [M[i][m + 1] / M[i][i] for i in range(m + 1)]
    return np.array([float(sum(a[k] * y[k] for k in range(m + 1)))
                     for a in A])


def _exact_filter(x, wl, po, mode, cval=0.0):
    """scipy.signal.savgol_filter by exact rational weights: the centred
    weights over scipy's padded signal, and for ``interp`` the window's fit
    evaluated at each of the first and last ``wl // 2`` positions."""
    n, N = wl // 2, len(x)
    wc = exact_weights(n, po, 0)
    if mode == "interp":
        y = np.array([wc @ x[j - n:j + n + 1] if n <= j < N - n else 0.0
                      for j in range(N)])
        for j in range(n):
            y[j] = exact_weights(n, po, j - n) @ x[:wl]
            y[N - 1 - j] = exact_weights(n, po, n - j) @ x[N - wl:]
        return y
    pad = {"mirror": dict(mode="reflect"), "nearest": dict(mode="edge"),
           "wrap": dict(mode="wrap"),
           "constant": dict(mode="constant", constant_values=cval)}[mode]
    xp = np.pad(x, n, **pad)
    return np.array([wc @ xp[j:j + wl] for j in range(N)])


@pytest.mark.parametrize("mode", SCIPY_MODES)
def test_savgol_filter_window_101(row, mode):
    """Window 101 (past SavgolConfig's 65, within the 129 taps K1, K2 and
    K3 take): scipy and the exact weights, numpy in and out."""
    got = tsc.savgol_filter(row, 101, 4, mode=mode, cval=0.5, device="cpu")
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, sp_filter(row, 101, 4, mode=mode,
                                              cval=0.5), atol=1e-9)
    np.testing.assert_allclose(got, _exact_filter(row, 101, 4, mode, 0.5),
                               atol=1e-12)


def test_bf16_messages_name_a_roadmap_heading():
    """The 1D and 2D ``method="bf16"`` errors that named ROADMAP Queue 1's
    "`method="bf16"` in 1D and 2D" are gone with that item: the mode runs,
    on a CPU tensor through the kernels' bf16 plain versions, and gives
    what they give."""
    from savgol_tpu_torch.ops import cuda_conv2d as c2
    ft = sgt.Savgol1D.create(sgt.SavgolConfig(4, 2), device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 64)))
    np.testing.assert_array_equal(
        ft.apply(x, method="bf16").numpy(),
        cc.savgol_polynomial_bf16_plain(x, ft.center_weights,
                                        ft.edge_weights, 4).numpy())
    w = torch.ones(3, 3) / 9
    np.testing.assert_array_equal(
        sgt.savgol2d_apply(x, w, method="bf16").numpy(),
        c2.correlate2d_valid_bf16_plain(x, w, "edge").numpy())


def test_savgol_coeffs_errors():
    assert np.array_equal(tsc.savgol_coeffs(11, 3, deriv=4), np.zeros(11))
    with pytest.raises(ValueError, match="odd"):
        tsc.savgol_coeffs(10, 2)
    with pytest.raises(ValueError, match="polyorder"):
        tsc.savgol_coeffs(11, 11)
    with pytest.raises(ValueError, match="pos"):
        tsc.savgol_coeffs(11, 3, pos=11.5)
    with pytest.raises(ValueError, match="use"):
        tsc.savgol_coeffs(11, 3, use="both")


# -- K2 on the exact tile's schedule (csrc/sg1d_exact.cuh) -----------------


def _k2_plan(N: int, n: int, base: int, B: int, itemsize: int) -> dict:
    vec = 16 // itemsize
    return exact_tile_plan(N, 2 * n + 1, -n,
                              [(base + b * N) % vec for b in range(B)],
                              itemsize)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("pad_mode", ["symmetric", "wrap", "edge",
                                      "reflect"])
@pytest.mark.parametrize("ws", [3, 25, 101, 129])
def test_exact_tile_plan_k2(pad_mode, ws, itemsize):
    """Over N around tile boundaries (every residue mod 4), row offsets 0-3
    and B in {1, 3, 130}: a tile stages samples past [0, N), the ones the
    pad mode maps, only at a row's ends (its first tile and its last two),
    each output is stored once, and staged and stored by the plan in
    float64 (B = 3) the rows give ``savgol_padded_plain``."""
    n = ws // 2
    tile = exact_tile_plan(1, 1, 0, [0], itemsize)["tile"]
    w = np.random.default_rng(ws).standard_normal(ws)
    for N in [ws, ws + 1] + [m for t in (tile, 2 * tile)
                             for m in range(t - 2, t + 2)]:
        for B in (1, 3, 130):
            for base in range(4):
                p = _k2_plan(N, n, base, B, itemsize)
                seen = {}
                for i, (b, o0, in0, lo, hi) in enumerate(p["plan"]):
                    t = i % p["tiles"]
                    if in0 < 0 or in0 + p["span"] > N:
                        assert t in (0, p["tiles"] - 2, p["tiles"] - 1)
                    seen.setdefault(b, []).append((lo, hi))
                for ranges in seen.values():
                    stored = sum(hi - lo for lo, hi in ranges if hi > lo)
                    assert stored == N and ranges[0][0] == 0
        x = _data((3, N), seed=N + ws, dtype=np.float64)
        want = cc.savgol_padded_plain(torch.from_numpy(x),
                                      torch.from_numpy(w), pad_mode,
                                      n).numpy()
        for base in (0, 3):
            p = _k2_plan(N, n, base, 3, itemsize)
            out = np.full((3, N), np.nan)
            for b, o0, in0, lo, hi in p["plan"]:
                # the mode's map of the staged indices (pad_index, the
                # host twin of csrc map_index) over [-lo, N + hi)
                lo_pad = max(-in0, 0)
                src = cc.pad_index(N, lo_pad, max(in0 + p["span"] - N, 0),
                                   pad_mode, "cpu").numpy()
                staged = x[b, src[in0 + lo_pad:in0 + lo_pad + p["span"]]]
                win = np.lib.stride_tricks.sliding_window_view(staged, ws)
                assert np.isnan(out[b, lo:hi]).all()
                out[b, lo:hi] = win[np.arange(lo, hi) - o0] @ w
            np.testing.assert_allclose(out, want, rtol=0, atol=1e-12)


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N_kind", ["ws", "ws+1", 4099])
@pytest.mark.parametrize("n", [1, 12, 32])
def test_cuda_padded_kernel_matches_plain(cuda, n, N_kind, dtype):
    ws = 2 * n + 1
    N = {"ws": ws, "ws+1": ws + 1}.get(N_kind, N_kind)
    tol = F32_TOL if dtype == torch.float32 else 1e-12
    x = torch.from_numpy(_data((3, N), seed=n + N, dtype=np.float64)).to(
        cuda, dtype)
    w = torch.from_numpy(_data(ws, seed=n, dtype=np.float64)).to(cuda, dtype)
    for pad_mode in PAD_MODES.values():
        before = cc.LAUNCHES["sg1d_pad"]
        got = cc.savgol_padded_cuda(x, w, pad_mode, n, 0.01)
        assert cc.LAUNCHES["sg1d_pad"] == before + 1
        want = cc.savgol_padded_plain(x, w, pad_mode, n, 0.01)
        _assert_close(got.cpu().numpy(), want.cpu().numpy(), tol)
    f = sgt.Savgol1D.create(sgt.SavgolConfig(n, min(4, 2 * n)),
                            dtype=dtype, device=cuda)
    with pytest.raises(TypeError):
        cc.savgol_padded_cuda(x.half(), w, "wrap", n)
    with pytest.raises(ValueError, match="pad mode"):
        cc.savgol_padded_cuda(x, w, "bogus", n)
    before = dict(cc.LAUNCHES)
    f.apply(x, boundary="periodic")
    assert cc.LAUNCHES["sg1d_pad"] == before["sg1d_pad"] + 1
    assert cc.LAUNCHES["corr1d_valid"] == before["corr1d_valid"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,key", [("interp", "sg1d_poly"),
                                      ("wrap", "sg1d_pad"),
                                      ("mirror", "sg1d_pad")])
def test_cuda_savgol_filter_numpy_input_reaches_kernel(cuda, row, mode, key):
    """A scipy user's numpy array goes to the card and one kernel launch."""
    x = row.astype(np.float32)
    before = dict(cc.LAUNCHES)
    got = tsc.savgol_filter(x, 25, 4, mode=mode)
    assert isinstance(got, np.ndarray)
    assert {k: cc.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == key) for k in before}
    np.testing.assert_allclose(got, sp_filter(row, 25, 4, mode=mode),
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,key", [
    ("interp", "sg1d_poly"), ("wrap", "sg1d_pad"), ("nearest", "sg1d_pad"),
    ("mirror", "sg1d_pad"), ("constant", "corr1d_valid")])
def test_cuda_savgol_filter_window_101(cuda, row, mode, key):
    """Window 101 on the card: one launch of K1, K2 or K3 for a numpy
    array, within 1e-6 of scipy and of the exact weights."""
    before = dict(cc.LAUNCHES)
    got = tsc.savgol_filter(row.astype(np.float32), 101, 4, mode=mode,
                            cval=0.5)
    assert {k: cc.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == key) for k in before}
    np.testing.assert_allclose(got, sp_filter(row, 101, 4, mode=mode,
                                              cval=0.5), atol=1e-6)
    np.testing.assert_allclose(got, _exact_filter(row, 101, 4, mode, 0.5),
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N_kind", ["ws", "ws+1", 4099, 9233])
@pytest.mark.parametrize("n", [1, 2, 12, 33, 64])
def test_cuda_k2_reflect_matches_plain(cuda, n, N_kind, dtype):
    """K2 maps numpy's reflect while it stages: against its plain version
    (the host pad, the VALID correlation, the multiply) from one window
    long, where both ends' reflections meet, to three tiles and more; one
    launch and one ``MAPPED["reflect"]``, no host pad."""
    ws = 2 * n + 1
    N = {"ws": ws, "ws+1": ws + 1}.get(N_kind, N_kind)
    tol = F32_TOL if dtype == torch.float32 else 1e-12
    x = torch.from_numpy(_data((3, N), seed=n + N, dtype=np.float64)).to(
        cuda, dtype)
    w = torch.from_numpy(_data(ws, seed=n, dtype=np.float64)).to(cuda, dtype)
    launches, mapped, pads = (dict(cc.LAUNCHES), dict(cc.MAPPED),
                              dict(cc.PADS))
    got = cc.savgol_padded_cuda(x, w, "reflect", n, 0.01)
    assert {k: cc.LAUNCHES[k] - launches[k] for k in launches} == {
        k: int(k == "sg1d_pad") for k in launches}
    assert {k: cc.MAPPED[k] - mapped[k] for k in mapped} == {
        k: int(k == "reflect") for k in mapped}
    assert cc.PADS == pads
    want = cc.savgol_padded_plain(x, w, "reflect", n, 0.01)
    _assert_close(got.cpu().numpy(), want.cpu().numpy(), tol)


@pytest.mark.cuda
def test_cuda_mirror_call_is_one_k2_launch_and_no_host_pad(cuda):
    """An exact ``mode="mirror"`` call launches K2 once, maps its reflect
    in the kernel and pads nothing on the host; ``method="bf16"`` keeps the
    host pad and K3."""
    x = torch.from_numpy(_data((4, 5000), seed=7)).to(cuda)
    launches, mapped, pads = (dict(cc.LAUNCHES), dict(cc.MAPPED),
                              dict(cc.PADS))
    tsc.savgol_filter(x, 25, 4, mode="mirror")
    assert {k: cc.LAUNCHES[k] - launches[k] for k in launches} == {
        k: int(k == "sg1d_pad") for k in launches}
    assert {k: cc.MAPPED[k] - mapped[k] for k in mapped} == {
        k: int(k == "reflect") for k in mapped}
    assert cc.PADS == pads
    launches = dict(cc.LAUNCHES)
    tsc.savgol_filter(x, 25, 4, mode="mirror", method="bf16")
    assert {k: cc.LAUNCHES[k] - launches[k] for k in launches} == {
        k: int(k == "corr1d_valid") for k in launches}
    assert cc.PADS["reflect"] == pads["reflect"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("deriv,delta", [(0, 1.0), (1, 0.5)])
def test_cuda_mirror_matches_the_host_pad_route(cuda, deriv, delta, dtype):
    """K2's mirror against the route it replaced (the host reflect pad, K3,
    then ``* 1/delta**deriv``): within the f32 tolerance, and bit for bit
    at ``dt_inv`` = 1, where both run one fma chain over the same samples
    and taps in the same order."""
    x = torch.from_numpy(_data((5, 9233), seed=8, dtype=np.float64)).to(
        cuda, dtype)
    got = tsc.savgol_filter(x, 25, 4, deriv=deriv, delta=delta,
                            mode="mirror")
    cw = torch.from_numpy(tsc._compat_weights_np(12, 4, deriv)[0]).to(
        cuda, dtype)
    want = cc.correlate_valid_cuda(cc.pad_last(x, 12, "reflect"), cw) * (
        1.0 / delta ** deriv)
    if deriv == 0:
        assert torch.equal(got, want)
    _assert_close(got.cpu().numpy(), want.cpu().numpy(),
                  F32_TOL if dtype == torch.float32 else 1e-12)
