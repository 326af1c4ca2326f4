"""The ported 2D slice end to end: ``savgol_tpu_torch.Savgol2D`` and the
``savgol2d_*`` functions against ``savgol_tpu``'s on the same numpy-seeded
inputs, and the 2D host weights against ``savgol_tpu.ops.weights``.

On the CPU the port runs the plain PyTorch versions of its kernels (dense,
or separable for ``method="sep"`` and stencils wider than 17 taps); the JAX
side runs ``method="xla"`` with x64 on (``tests/conftest.py``).

Tolerance: abs error <= 2e-5 * max(1, max|ref|) for f32 (summation order,
scale folded into the stencil on one side, see ``tests/test_torch_conv2d.py``)
and 1e-12 for f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import savgol_tpu as sg
import savgol_tpu.ops.weights as jw
import savgol_tpu_torch as sgt
import savgol_tpu_torch.config as tcfg
import savgol_tpu_torch.ops.weights as tw
from savgol_tpu.ops.apply2d import savgol2d_apply_stack as jax_apply_stack

F32_TOL = 2e-5
F64_TOL = 1e-12
BOUNDARIES = [b.value for b in sg.Boundary2D]

CONFIGS = {
    "smooth5x5": dict(half_window_x=5, half_window_y=5, poly_order=3),
    "dxdy_rect": dict(half_window_x=2, half_window_y=4, poly_order=3,
                      deriv_x=1, deriv_y=1, delta_x=0.5, delta_y=0.25),
    "wide_dy": dict(half_window_x=12, half_window_y=9, poly_order=4,
                    deriv_y=2, delta_y=0.1),
}


def _pair(name, dtype="float32"):
    kw = CONFIGS[name]
    fj = sg.Savgol2D.create(sg.Savgol2DConfig(**kw), dtype=getattr(jnp, dtype))
    ft = sgt.Savgol2D.create(sgt.Savgol2DConfig(**kw),
                             dtype=getattr(torch, dtype), device="cpu")
    return fj, ft


def _data(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _assert_close(got, want, tol=F32_TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} * {scale:.3e}"


def _outcome(fn):
    """The array fn returns, or the type of the error it raises."""
    try:
        return fn()
    except (ValueError, np.linalg.LinAlgError) as err:
        return type(err)


# -- host weights -------------------------------------------------------------


@pytest.mark.parametrize("hy", [1, 2, 5, 16])
@pytest.mark.parametrize("hx", [1, 2, 5, 16])
def test_2d_weights_bit_identical(hx, hy):
    """Every order <= 6 and derivative pair: the f64 stencils are equal bit
    for bit, and so are the errors for invalid configs and ill-posed
    windows (``numpy.linalg.LinAlgError``)."""
    for order in range(7):
        for dx in range(order + 1):
            for dy in range(order + 1 - dx):
                kw = dict(half_window_x=hx, half_window_y=hy,
                          poly_order=order, deriv_x=dx, deriv_y=dy)
                got = _outcome(lambda: tw.savgol2d_weights_np(
                    tcfg.Savgol2DConfig(**kw), np.float64))
                want = _outcome(lambda: jw.savgol2d_weights_np(
                    sg.Savgol2DConfig(**kw), np.float64))
                if isinstance(want, type):
                    assert got is want, kw
                    continue
                assert got.dtype == np.float64 and np.array_equal(got, want)
                assert np.array_equal(
                    tw.savgol2d_weights_np(tcfg.Savgol2DConfig(**kw)),
                    jw.savgol2d_weights_np(sg.Savgol2DConfig(**kw)))
    assert tw.monomial_index(hx, hy) == jw.monomial_index(hx, hy)


# the singular geometries of tests/test_2d.py (TestSingularGeometry)
ACCEPT = [(1, 14, 3, 1, 2), (13, 1, 3, 1, 0), (16, 2, 5, 0, 4),
          (1, 2, 3, 1, 2)]
REJECT = [(8, 1, 3, 0, 1), (2, 1, 3, 0, 1), (1, 2, 3, 3, 0), (1, 14, 3, 1, 0)]


@pytest.mark.parametrize("hx,hy,order,dx,dy", ACCEPT)
def test_wellposed_singular_window_same_min_norm_stencil(hx, hy, order, dx,
                                                         dy):
    cfg = dict(half_window_x=hx, half_window_y=hy, poly_order=order,
               deriv_x=dx, deriv_y=dy)
    got = tw.savgol2d_weights_np(tcfg.Savgol2DConfig(**cfg), np.float64)
    want = jw.savgol2d_weights_np(sg.Savgol2DConfig(**cfg), np.float64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("hx,hy,order,dx,dy", REJECT)
def test_illposed_window_raises(hx, hy, order, dx, dy):
    cfg = tcfg.Savgol2DConfig(hx, hy, order, deriv_x=dx, deriv_y=dy)
    with pytest.raises(np.linalg.LinAlgError, match="ill-posed"):
        tw.savgol2d_weights_np(cfg)
    with pytest.raises(np.linalg.LinAlgError, match="ill-posed"):
        sgt.Savgol2D.create(cfg, device="cpu")


# -- the module ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_from_jax_gives_identical_buffers(name, dtype):
    fj, ft = _pair(name, dtype)
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(fj)]
    fx = sgt.Savgol2D.from_jax(ft.config, leaves, device="cpu")
    for buf_from_jax, buf_created, leaf in zip(
            (fx.weights, fx.scale), (ft.weights, ft.scale), leaves):
        assert np.array_equal(buf_from_jax.numpy(), leaf)
        assert buf_from_jax.numpy().dtype == leaf.dtype
        assert np.array_equal(buf_created.numpy(), leaf)
    assert dict(fx.named_buffers()).keys() == {"weights", "scale"}
    assert fx.valid_size(40, 50) == fj.valid_size(40, 50)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_matches_jax(name, boundary):
    fj, ft = _pair(name)
    x = _data((2, 41, 57), seed=len(name) + len(boundary))
    xt = torch.from_numpy(x)
    want = fj.apply(jnp.asarray(x), boundary=sg.Boundary2D(boundary),
                    method="xla")
    for method in ("auto", "xla", "sep"):
        got = ft.apply(xt, boundary=boundary, method=method)
        assert got.dtype == torch.float32
        _assert_close(got.numpy(), want)
    if boundary == "valid":
        _assert_close(ft.apply_valid(xt).numpy(), want)
    assert torch.equal(ft(xt, boundary=boundary),
                       ft.apply(xt, boundary=boundary))


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_apply_f64_matches_jax(boundary):
    fj, ft = _pair("dxdy_rect", "float64")
    x = _data((3, 30, 26), seed=11, dtype=np.float64)
    want = fj.apply(jnp.asarray(x), boundary=sg.Boundary2D(boundary),
                    method="xla")
    for method in ("auto", "sep"):
        got = ft.apply(torch.from_numpy(x), boundary=boundary, method=method)
        _assert_close(got.numpy(), want, F64_TOL)


@pytest.mark.parametrize("shape", [(1, 1), (2, 3, 5), (4, 2)])
def test_tiny_images_shorter_than_the_pad(shape):
    """Pads wider than the image follow numpy's rules on both sides."""
    fj, ft = _pair("wide_dy", "float64")
    x = _data(shape, seed=12, dtype=np.float64)
    for boundary in ("constant", "reflect", "periodic"):
        want = fj.apply(jnp.asarray(x), boundary=sg.Boundary2D(boundary),
                        method="xla")
        got = ft.apply(torch.from_numpy(x), boundary=boundary)
        _assert_close(got.numpy(), want, F64_TOL)
    with pytest.raises(ValueError, match="smaller than the stencil"):
        ft.apply_valid(torch.from_numpy(x))


# -- gradient, Hessian, Laplacian ----------------------------------------------


@pytest.mark.parametrize("boundary", ["constant", "reflect", "periodic",
                                      "valid"])
@pytest.mark.parametrize("fn", ["savgol2d_gradient", "savgol2d_hessian",
                                "savgol2d_laplacian"])
def test_derivative_stacks_match_jax(fn, boundary):
    x = _data((2, 33, 40), seed=len(fn) + len(boundary))
    kw = dict(delta_x=0.5, delta_y=2.0, boundary=boundary)
    want = getattr(sg, fn)(jnp.asarray(x), 4, 3, 3, method="xla",
                           **{**kw, "boundary": sg.Boundary2D(boundary)})
    if fn == "savgol2d_laplacian":
        want = (want,)
    for method in ("auto", "sep"):
        got = getattr(sgt, fn)(torch.from_numpy(x), 4, 3, 3, method=method,
                               **kw)
        if fn == "savgol2d_laplacian":
            got = (got,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            _assert_close(g.numpy(), w)


def test_apply_stack_matches_jax_with_scales():
    rng = np.random.default_rng(13)
    x = _data((3, 25, 31), seed=13, dtype=np.float64)
    ws = rng.standard_normal((4, 5, 7))
    scales = np.array([1.0, 0.5, 3.0, -2.0])
    for boundary in BOUNDARIES:
        want = jax_apply_stack(jnp.asarray(x), jnp.asarray(ws),
                               boundary=sg.Boundary2D(boundary),
                               scales=jnp.asarray(scales), method="xla")
        for method in ("auto", "xla", "sep"):
            got = sgt.savgol2d_apply_stack(
                torch.from_numpy(x), torch.from_numpy(ws), boundary=boundary,
                scales=torch.from_numpy(scales), method=method)
            _assert_close(got.numpy(), want, F64_TOL)


def test_hessian_and_laplacian_need_order_2():
    x = torch.zeros(10, 10)
    with pytest.raises(ValueError, match="hessian"):
        sgt.savgol2d_hessian(x, 2, 2, 1)
    with pytest.raises(ValueError, match="laplacian"):
        sgt.savgol2d_laplacian(x, 2, 2, 1)


# -- dtypes and shapes ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.bool_])
def test_int_input_promoted(dtype):
    """Integer/bool images compute in result_type(weights, float32): casting
    the stencil down to the image's dtype would truncate it to zero."""
    fj, ft = _pair("smooth5x5")
    x = (np.arange(24 * 30).reshape(24, 30) % 7).astype(dtype)
    y = ft.apply(torch.from_numpy(x))
    assert y.dtype == torch.float32
    _assert_close(y.numpy(), fj.apply(jnp.asarray(x)))
    gx, _ = sgt.savgol2d_gradient(torch.from_numpy(x), 2, 2, 2)
    assert gx.dtype == torch.float64      # f64 host stencils, as in JAX x64
    jx, _ = sg.savgol2d_gradient(jnp.asarray(x), 2, 2, 2)
    _assert_close(gx.numpy(), jx, F64_TOL)


def test_complex_input_is_real_linear():
    fj, ft = _pair("dxdy_rect")
    x = (_data((2, 20, 30), seed=80)
         + 1j * _data((2, 20, 30), seed=81)).astype(np.complex64)
    for boundary in ("reflect", "valid"):
        got = ft.apply(torch.from_numpy(x), boundary=boundary)
        assert got.dtype == torch.complex64
        want = np.asarray(fj.apply(jnp.asarray(x),
                                   boundary=sg.Boundary2D(boundary)))
        _assert_close(got.numpy().real, want.real)
        _assert_close(got.numpy().imag, want.imag)
    gx, gy = sgt.savgol2d_gradient(torch.from_numpy(x), 3, 3, 2)
    jx, jy = sg.savgol2d_gradient(jnp.asarray(x), 3, 3, 2)
    assert gx.dtype == torch.complex64
    _assert_close(gy.numpy().imag, np.asarray(jy).imag)


def test_batched_leading_axes_and_string_boundaries():
    fj, ft = _pair("dxdy_rect")
    x = _data((2, 3, 19, 23), seed=14)
    for boundary in ("constant", "reflect", "periodic", "valid"):
        got = ft.apply(torch.from_numpy(x), boundary=boundary)
        for i in range(2):
            _assert_close(got[i].numpy(), fj.apply(
                jnp.asarray(x[i]), boundary=sg.Boundary2D(boundary)))
        assert torch.equal(got, ft.apply(
            torch.from_numpy(x), boundary=sgt.Boundary2D(boundary)))
    with pytest.raises(ValueError):
        ft.apply(torch.from_numpy(x), boundary="mirror")


# -- gradients --------------------------------------------------------------------


@pytest.mark.parametrize("boundary", ["reflect", "periodic", "valid"])
def test_gradients_match_jax_vjp(boundary):
    """Gradients for the image, the stencil and the scale buffer, through
    the kernel path's autograd.Function (plain version on the CPU), against
    jax.vjp of the JAX filter, in f64."""
    fj, ft = _pair("dxdy_rect", "float64")
    x = _data((2, 21, 26), seed=90, dtype=np.float64)
    out_shape = (2, 13, 22) if boundary == "valid" else x.shape
    g = _data(out_shape, seed=91, dtype=np.float64)
    _, vjp = jax.vjp(lambda xv, f: f.apply(
        xv, boundary=sg.Boundary2D(boundary), method="xla"),
        jnp.asarray(x), fj)
    gx_j, gf_j = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    params = [ft.weights, ft.scale]
    for p in params:
        p.requires_grad_()
    y = ft.apply(xt, boundary=boundary)
    grads = torch.autograd.grad(y, [xt, *params], torch.from_numpy(g))
    for got, ref in zip(grads, (gx_j, gf_j.weights, gf_j.scale)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9,
                                   atol=1e-12)


def test_sep_route_gradient_in_x():
    """K2D-sep is differentiable in the image, as ``_pallas_sep_diff``."""
    fj, ft = _pair("wide_dy", "float64")
    x = _data((1, 30, 40), seed=92, dtype=np.float64)
    g = _data((1, 30, 40), seed=93, dtype=np.float64)
    _, vjp = jax.vjp(lambda v: fj.apply(v, boundary=sg.Boundary2D.REFLECT,
                                        method="xla"), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    for method in ("auto", "sep"):     # 25 taps wide: "auto" is K2D-sep too
        (gx,) = torch.autograd.grad(
            ft.apply(xt, boundary="reflect", method=method), [xt],
            torch.from_numpy(g))
        np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(
            jnp.asarray(g))[0]), rtol=1e-9, atol=1e-12)


def test_sep_route_factors_float32_stencils_at_their_structural_rank(
        monkeypatch):
    """A float32 stencil's rounding noise is not rank: the 33x33 order-3
    smoothing stencil reaches K2D-sep as 2 rank passes, not 13."""
    from savgol_tpu_torch.ops import apply2d
    ranks = []
    real = apply2d.correlate2d_sep_cuda

    def spy(x, u, v, pad_mode=None):
        ranks.append(u.shape[0])
        return real(x, u, v, pad_mode)

    monkeypatch.setattr(apply2d, "correlate2d_sep_cuda", spy)
    for dtype in (torch.float32, torch.float64):
        f = sgt.Savgol2D.create(sgt.Savgol2DConfig(16, 16, 3), dtype=dtype,
                                device="cpu")
        for x_dtype in (dtype, torch.float64):
            f.apply(torch.from_numpy(_data((40, 40), seed=15)).to(x_dtype))
    assert ranks == [2, 2, 2, 2]


def test_sep_route_factors_each_stencil_tensor_once(monkeypatch):
    """The host SVD (and, for a CUDA stencil, its copy to the host) runs
    once per stencil tensor: again only after the tensor changes in place,
    and the entry goes with the tensor. The derivative conveniences reuse
    one device stencil stack per geometry."""
    import gc

    from savgol_tpu_torch.ops import apply2d
    calls = []
    real = apply2d._svd_stencil_np

    def spy(w, rtol=1e-9):
        calls.append(w.shape)
        return real(w, rtol)

    monkeypatch.setattr(apply2d, "_svd_stencil_np", spy)
    apply2d._device_stencils.cache_clear()
    f = sgt.Savgol2D.create(sgt.Savgol2DConfig(16, 16, 3), device="cpu")
    x = torch.from_numpy(_data((2, 40, 40), seed=16))
    y = f.apply(x)                     # 33 taps wide: K2D-sep under "auto"
    assert torch.equal(f.apply(x), y) and len(calls) == 1
    f.weights.mul_(2.0)
    _assert_close(f.apply(x).numpy(), 2 * y.numpy())
    assert len(calls) == 2
    with torch.inference_mode():       # inference tensors: no version
        fi = sgt.Savgol2D.create(sgt.Savgol2DConfig(16, 16, 3), device="cpu")
        assert torch.equal(fi.apply(x), y) and torch.equal(fi.apply(x), y)
    assert len(calls) == 3

    first = sgt.savgol2d_hessian(x, 9, 9, 3, delta_x=0.5)   # 19 taps: sep
    assert len(calls) == 6
    again = sgt.savgol2d_hessian(x, 9, 9, 3, delta_x=0.5)
    assert len(calls) == 6
    assert all(torch.equal(a, b) for a, b in zip(first, again))

    w = torch.from_numpy(_data((19, 19), seed=17, dtype=np.float64))
    before = len(apply2d._FACTORS)
    sgt.savgol2d_apply(x, w)
    assert len(apply2d._FACTORS) == before + 1
    del w
    gc.collect()
    assert len(apply2d._FACTORS) == before


def test_scale_that_needs_grad_leaves_the_sep_route():
    """A scale buffer that requires grad takes K2D-dense (differentiable in
    the stencil and the scale) even where "auto" would pick K2D-sep."""
    fj, ft = _pair("wide_dy", "float64")
    x = _data((1, 30, 40), seed=94, dtype=np.float64)
    g = _data((1, 30, 40), seed=95, dtype=np.float64)
    _, vjp = jax.vjp(lambda f: f.apply(jnp.asarray(x), method="xla"), fj)
    (gf_j,) = vjp(jnp.asarray(g))
    ft.scale.requires_grad_()
    (gs,) = torch.autograd.grad(ft.apply(torch.from_numpy(x)), [ft.scale],
                                torch.from_numpy(g))
    np.testing.assert_allclose(gs.numpy(), np.asarray(gf_j.scale), rtol=1e-9,
                               atol=1e-12)


def test_method_values():
    _, ft = _pair("smooth5x5")
    x = torch.from_numpy(_data((2, 30, 30), seed=9))
    assert torch.equal(ft.apply(x, method="auto"), ft.apply(x, method="xla"))
    with pytest.raises(ValueError, match="method"):
        ft.apply(x, method="bogus")
    with pytest.raises(ValueError, match="CUDA"):
        ft.apply(x, method="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        sgt.savgol2d_gradient(x, 2, 2, 2, method="pallas")
    # "bf16" runs on a CPU tensor (K2D-dense's bf16 plain version), within
    # the mode's contract of the exact route: f32 input gets the f32 sums,
    # f64 input the sums rounded to bf16, in f64
    for v in (x, x.double()):
        for bf16, exact in (
                (lambda: ft.apply(v, method="bf16"), lambda: ft.apply(v)),
                (lambda: ft.apply_valid(v, method="bf16"),
                 lambda: ft.apply_valid(v)),
                (lambda: sgt.savgol2d_hessian(v, 2, 2, 2, method="bf16")[1],
                 lambda: sgt.savgol2d_hessian(v, 2, 2, 2)[1])):
            got, want = bf16(), exact()
            assert got.dtype == want.dtype == v.dtype
            rounded = torch.equal(got, got.to(torch.bfloat16).to(got.dtype))
            assert rounded == (v.dtype == torch.float64)
            _assert_close(got, want, tol=3e-2)


def test_module_on_other_device_raises():
    f = sgt.Savgol2D.create(sgt.Savgol2DConfig(2, 2, 2), device="meta")
    x = torch.from_numpy(_data((20, 20), seed=10))
    with pytest.raises(ValueError, match="on meta"):
        f.apply(x)
    with pytest.raises(ValueError, match="on meta"):
        f.apply_valid(x)
