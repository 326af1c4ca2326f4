"""The ported slice end to end: ``savgol_tpu_torch.Savgol1D`` against
``savgol_tpu.Savgol1D`` on the same numpy-seeded inputs.

On the CPU the port runs the plain PyTorch versions of its kernels; the JAX
side runs ``method="pallas"`` (the Pallas kernels interpreted through the
custom VJPs) and ``method="xla"``. Inputs are cast to float32 explicitly
because ``tests/conftest.py`` turns x64 on.

Tolerance for f32: abs error <= 2e-6 * max(1, max|ref|), for the reason
given in ``tests/test_torch_conv.py`` (summation order, ``dt_inv`` folded
into the weights on one side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import savgol_tpu as sg
import savgol_tpu_torch as sgt

F32_TOL = 2e-6

CONFIGS = {
    "smooth12": dict(half_window=12, poly_order=4),
    "deriv1_5": dict(half_window=5, poly_order=3, derivative=1,
                     time_step=0.01),
}


def _pair(name, dtype="float32"):
    kw = CONFIGS[name]
    fj = sg.Savgol1D.create(sg.SavgolConfig(**kw), dtype=getattr(jnp, dtype))
    ft = sgt.Savgol1D.create(sgt.SavgolConfig(**kw),
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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_from_jax_gives_identical_buffers(name, dtype):
    fj, ft = _pair(name, dtype)
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(fj)]
    fx = sgt.Savgol1D.from_jax(ft.config, leaves, device="cpu")
    for buf_from_jax, buf_created, leaf in zip(
            (fx.center_weights, fx.edge_weights, fx.dt_inv),
            (ft.center_weights, ft.edge_weights, ft.dt_inv), leaves):
        assert np.array_equal(buf_from_jax.numpy(), leaf)
        assert buf_from_jax.numpy().dtype == leaf.dtype
        assert np.array_equal(buf_created.numpy(), leaf)
    assert dict(fx.named_buffers()).keys() == {
        "center_weights", "edge_weights", "dt_inv"}


@pytest.mark.parametrize("boundary", [b.value for b in sg.BoundaryMode])
@pytest.mark.parametrize("shape", [(24, 4099), (3, 517)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_matches_jax(name, shape, boundary):
    fj, ft = _pair(name)
    x = _data(shape, seed=shape[0] + shape[1])
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for edge_sign in (False, True):
        got = ft.apply(xt, boundary=boundary, reference_edge_sign=edge_sign)
        assert got.dtype == torch.float32 and got.shape == shape
        for method in ("pallas", "xla"):
            want = fj.apply(xj, boundary=sg.BoundaryMode(boundary),
                            reference_edge_sign=edge_sign, method=method)
            _assert_close(got.numpy(), want)
    assert torch.equal(ft(xt, boundary=boundary), ft.apply(
        xt, boundary=boundary, method="xla"))


@pytest.mark.parametrize("shape", [(24, 4099), (3, 517)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_valid_matches_jax(name, shape):
    fj, ft = _pair(name)
    x = _data(shape, seed=5 + shape[0] + shape[1])
    got = ft.apply_valid(torch.from_numpy(x))
    n = ft.half_window
    assert got.shape == (shape[0], shape[1] - 2 * n)
    for method in ("pallas", "xla"):
        _assert_close(got.numpy(), fj.apply_valid(jnp.asarray(x),
                                                  method=method))


def test_axis0_on_3d_input():
    fj, ft = _pair("deriv1_5")
    x = _data((60, 3, 2), seed=8)
    got = ft.apply(torch.from_numpy(x), axis=0)
    assert got.shape == x.shape
    _assert_close(got.numpy(), fj.apply(jnp.asarray(x), axis=0))
    gotv = ft.apply_valid(torch.from_numpy(x), axis=0)
    _assert_close(gotv.numpy(), fj.apply_valid(jnp.asarray(x), axis=0))


def test_int_input_promoted():
    """Integer input computes in the weights' dtype: casting the weights
    down to int would truncate them to zero."""
    fj = sg.Savgol1D.create(sg.SavgolConfig(2, 1), dtype=jnp.float32)
    ft = sgt.Savgol1D.create(sgt.SavgolConfig(2, 1), device="cpu")
    y = ft.apply(torch.arange(10))
    assert y.dtype == torch.float32
    _assert_close(y.numpy(), fj.apply(jnp.arange(10)))
    np.testing.assert_allclose(y.numpy(), np.arange(10.0), atol=1e-5)
    yv = ft.apply_valid(torch.arange(10))
    np.testing.assert_allclose(yv.numpy(), np.arange(2.0, 8.0), atol=1e-5)


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_half_input_computes_in_f32(half):
    fj, ft = _pair("smooth12")
    x = _data((2, 300), seed=30)
    xt = torch.from_numpy(x).to(getattr(torch, half))
    xj = jnp.asarray(x, dtype=getattr(jnp, half))
    y = ft.apply(xt)
    assert y.dtype == getattr(torch, half)
    want = np.asarray(fj.apply(xj), dtype=np.float64)
    got = y.to(torch.float64).numpy()
    # both round the same f32 result to the half dtype: at most one ulp
    ulp = 2.0 ** -7 if half == "bfloat16" else 2.0 ** -10
    assert np.all(np.abs(got - want) <= ulp * np.maximum(np.abs(want), 1.0))
    assert ft.apply_valid(xt).dtype == getattr(torch, half)


def test_complex_input_is_real_linear():
    fj, ft = _pair("deriv1_5")
    x = _data((2, 300), seed=80) + 1j * _data((2, 300), seed=81)
    xc = x.astype(np.complex64)
    got = ft.apply(torch.from_numpy(xc))
    assert got.dtype == torch.complex64
    want = np.asarray(fj.apply(jnp.asarray(xc)))
    _assert_close(got.numpy().real, want.real)
    _assert_close(got.numpy().imag, want.imag)
    gv = ft.apply_valid(torch.from_numpy(xc))
    assert gv.dtype == torch.complex64 and gv.shape == (2, 290)
    wv = np.asarray(fj.apply_valid(jnp.asarray(xc)))
    _assert_close(gv.numpy().real, wv.real)
    gr = ft.apply(torch.from_numpy(xc), boundary="reflect")
    wr = np.asarray(fj.apply(jnp.asarray(xc),
                             boundary=sg.BoundaryMode.REFLECT))
    _assert_close(gr.numpy().imag, wr.imag)


@pytest.mark.parametrize("boundary", ["polynomial", "reflect", "valid"])
def test_gradients_match_jax_vjp(boundary):
    """Gradients for x, both weight buffers and dt_inv, through the
    kernel path's autograd.Function (plain version on the CPU), against
    jax.vjp of the JAX filter through its custom VJP, in f64."""
    fj, ft = _pair("deriv1_5", "float64")
    x = _data((3, 517), seed=90, dtype=np.float64)
    out_len = 517 - 10 if boundary == "valid" else 517
    g = _data((3, out_len), seed=91, dtype=np.float64)

    def run_jax(xv, f):
        if boundary == "valid":
            return f.apply_valid(xv, method="pallas")
        return f.apply(xv, boundary=sg.BoundaryMode(boundary),
                       method="pallas")

    _, vjp = jax.vjp(run_jax, jnp.asarray(x), fj)
    gx_j, gf_j = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    params = [ft.center_weights, ft.edge_weights, ft.dt_inv]
    for p in params:
        p.requires_grad_()
    if boundary == "valid":
        y = ft.apply_valid(xt)
    else:
        y = ft.apply(xt, boundary=boundary)
    wanted = [xt, *params] if boundary == "polynomial" else [
        xt, params[0], params[2]]
    grads = torch.autograd.grad(y, wanted, torch.from_numpy(g))
    want = [gx_j, gf_j.center_weights, gf_j.edge_weights, gf_j.dt_inv]
    if boundary != "polynomial":
        want = [want[0], want[1], want[3]]
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-9)


def test_method_values():
    _, ft = _pair("smooth12")
    x = torch.from_numpy(_data((2, 100), seed=9))
    assert torch.equal(ft.apply(x, method="auto"), ft.apply(x, method="xla"))
    with pytest.raises(ValueError, match="method"):
        ft.apply(x, method="bogus")
    with pytest.raises(ValueError, match="method"):
        ft.apply_valid(x, method="bogus")
    for method in ("pallas", "mxu"):
        with pytest.raises(ValueError, match="CUDA"):
            ft.apply(x, method=method)
        with pytest.raises(ValueError, match="CUDA"):
            ft.apply_valid(x, method=method)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ft.apply(x, method="bf16")
    with pytest.raises(ValueError, match="window size"):
        ft.apply(x[:, :24])


def test_module_on_other_device_raises():
    f = sgt.Savgol1D.create(sgt.SavgolConfig(3, 2), device="meta")
    x = torch.from_numpy(_data((2, 50), seed=10))
    with pytest.raises(ValueError, match="device|on meta"):
        f.apply(x)
    with pytest.raises(ValueError, match="device|on meta"):
        f.apply_valid(x)
