"""2D VALID on an image smaller than the stencil: the port returns the JAX
package's shape, (..., max(0, R - H + 1), max(0, C - W + 1)), in the
input's dtype and on its device, and launches no kernel.

The reference is ``savgol_tpu`` on the CPU through the routes that take
such an image (``Savgol2D.apply_valid``, ``apply(boundary="valid")``,
``ops.apply2d.correlate2d_valid`` and ``savgol2d_apply_stack``).
Its ``method="sep"`` and ``method="bf16"`` routes fail inside Pallas on
such an image (ROADMAP, known reference faults, R5), so the port's
``"sep"`` and ``"bf16"`` are held to its own default route.
"""

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch.ops import apply2d as torch_apply2d
from savgol_tpu_torch.ops import cuda_conv2d as c2

SHAPES = [(7, 8), (8, 2), (9, 2), (2, 7, 8)]
CFG = dict(half_window_x=1, half_window_y=4, poly_order=1, deriv_y=1)


@pytest.fixture(scope="module")
def jx():
    """(savgol_tpu, jax.numpy, savgol_tpu.ops.apply2d); skips where JAX is
    not installed (the on-card lane)."""
    sg = pytest.importorskip("savgol_tpu")
    import jax.numpy as jnp
    from savgol_tpu.ops import apply2d
    return sg, jnp, apply2d


def _pair(jx, dtype):
    sg, jnp, _ = jx
    fj = sg.Savgol2D.create(sg.Savgol2DConfig(**CFG),
                            dtype=getattr(jnp, dtype))
    return fj, _port(dtype)


def _port(dtype):
    return sgt.Savgol2D.create(sgt.Savgol2DConfig(**CFG),
                               dtype=getattr(torch, dtype), device="cpu")


def _same(got: torch.Tensor, want, dtype) -> None:
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == getattr(torch, dtype) and str(want.dtype) == dtype
    assert got.device.type == "cpu"


def _data(shape, dtype):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("route", ["apply_valid", "apply", "correlate",
                                   "stack"])
@pytest.mark.parametrize("shape", SHAPES)
def test_small_image_valid_matches_jax(jx, shape, route, dtype):
    sg, jnp, jax_apply2d = jx
    fj, ft = _pair(jx, dtype)
    x = _data(shape, dtype)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if route == "apply_valid":
        want, got = fj.apply_valid(xj), ft.apply_valid(xt)
    elif route == "apply":
        want = fj.apply(xj, boundary=sg.Boundary2D.VALID)
        got = ft.apply(xt, boundary="valid")
    elif route == "correlate":
        w = np.array(fj.weights)
        want = jax_apply2d.correlate2d_valid(xj, jnp.asarray(w))
        got = torch_apply2d.correlate2d_valid(xt, torch.from_numpy(w))
    else:
        ws = np.stack([np.asarray(fj.weights), -np.asarray(fj.weights)])
        want = jax_apply2d.savgol2d_apply_stack(
            xj, jnp.asarray(ws), boundary=sg.Boundary2D.VALID)
        got = sgt.savgol2d_apply_stack(xt, torch.from_numpy(ws),
                                       boundary="valid")
    _same(got, want, dtype)
    if got.numel():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 1), (3, 20), (2, 5, 1)])
def test_small_image_past_the_jax_shortfall(jx, shape):
    """Two or more samples shorter than the stencil, where every JAX route
    raises (its output shape goes negative, ROADMAP R5): the port returns
    the contract's empty shape."""
    jnp = jx[1]
    fj, ft = _pair(jx, "float64")
    x = _data(shape, "float64")
    with pytest.raises(TypeError):
        fj.apply_valid(jnp.asarray(x), method="xla")
    got = ft.apply_valid(torch.from_numpy(x))
    assert tuple(got.shape) == shape[:-2] + (max(0, shape[-2] - 8),
                                             max(0, shape[-1] - 2))
    assert got.dtype == torch.float64 and got.numel() == 0


@pytest.mark.parametrize("method", ["sep", "bf16", "xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_small_image_methods_match_the_default_route(shape, method):
    """R5: JAX's sep and bf16 routes raise here, so the port's methods are
    held to its default route (and "pallas", which needs the card, to the
    error that names it)."""
    ft = _port("float32")
    xt = torch.from_numpy(_data(shape, "float32"))
    want = ft.apply_valid(xt)
    if method == "pallas":
        with pytest.raises(ValueError, match="CUDA tensor"):
            ft.apply_valid(xt, method=method)
        return
    got = ft.apply_valid(xt, method=method)
    assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("shape", SHAPES)
def test_small_image_wrappers_launch_nothing(shape):
    x = torch.from_numpy(_data(shape, "float32"))
    w = torch.ones(9, 3)
    u, v = torch.ones(1, 9), torch.ones(1, 3)
    c2.reset_launches()
    outs = [c2.correlate2d_valid_cuda(x, w), c2.correlate2d_sep_cuda(x, u, v),
            c2.correlate2d_valid_bf16_cuda(x, w),
            c2.correlate2d_valid_cuda(x, torch.stack([w, w]))]
    want = shape[:-2] + (max(0, shape[-2] - 8), max(0, shape[-1] - 2))
    for y in outs[:3]:
        assert tuple(y.shape) == want and y.dtype == torch.float32
    assert tuple(outs[3].shape) == shape[:-2] + (2,) + want[-2:]
    assert c2.LAUNCHES == {"corr2d_valid": 0, "corr2d_sep": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_small_image_launches_nothing(cuda, shape):
    """On the card: the JAX shape, on the card, with 0 launches of the
    dense, separable and bf16 kernels through every method."""
    f = sgt.Savgol2D.create(sgt.Savgol2DConfig(**CFG), device=cuda)
    x = torch.from_numpy(_data(shape, "float32")).to(cuda)
    want = shape[:-2] + (max(0, shape[-2] - 8), max(0, shape[-1] - 2))
    c2.reset_launches()
    for method in ("auto", "pallas", "sep", "bf16"):
        y = f.apply_valid(x, method=method)
        assert tuple(y.shape) == want and y.device == x.device
        assert y.dtype == torch.float32
    y = sgt.savgol2d_apply_stack(x, torch.stack([f.weights, f.weights]),
                                 boundary="valid")
    assert tuple(y.shape) == shape[:-2] + (2,) + want[-2:]
    torch.cuda.synchronize()
    assert c2.LAUNCHES == {"corr2d_valid": 0, "corr2d_sep": 0}
