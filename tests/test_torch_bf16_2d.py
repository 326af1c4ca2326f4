"""``method="bf16"`` of the port's 2D paths against the JAX package's bf16
routes: ``Savgol2D.apply`` / ``apply_valid`` (VALID and the three same-size
boundaries), ``savgol2d_apply_stack`` and the gradient / Hessian /
Laplacian conveniences, and the kernels' bf16 plain version against the
row-banded Pallas kernels themselves, on the same numpy-seeded inputs.

On the CPU the port runs K2D-dense's bf16 plain version; the JAX side runs
its row-banded kernels on bf16 operands at single-pass precision, in
interpret mode, as ``tests/test_2d.py:415-497`` does. Both round the image
and the stencil to bf16 and sum exact products in f32; for f32 input both
return the f32 sums, so they differ only by the order of those sums:
2e-6 * max(1, max|y|). For bf16 input both round the sums to bf16: one bf16
ulp (``ops.cuda_conv.bf16_ulp_gate``). On the card the tensor-core kernel's
f32 sums meet 1e-5 scaled against the plain version at random 33 x 33
stencils (2e-6 at the Savitzky-Golay stencils of ``chip_smoke.py``). Against float64 the gate is the JAX
tests' 3e-2 of max|y|; gradients go through the exact route (rtol 3e-2,
atol 1e-3, as ``tests/test_2d.py:457-465``; f64 1e-12).

The JAX references are computed once per module, at small sizes. The
tensor-core kernel's band matrices (``row_bands``) are held against the JAX
kernel's, and their products against the plain version (2e-6 scaled). The
tests marked ``cuda`` hold K2D-dense's bf16 mode against its plain version
on the card and count launches.
"""

import functools

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch.ops import cuda_conv2d as c2
from savgol_tpu_torch.ops.cuda_conv import bf16_ulp_gate

F32_TOL = 2e-6
# the tensor-core kernel's f32 sums against the plain version's, f32
# storage, at random 33 x 33 stencils: the gate of the other 2D kernels
# (tests/test_hw_parity.py:499-503); the plain versions keep F32_TOL
F32_TOL_2D = 1e-5
CONTRACT = 3e-2
BOUNDARIES = ["valid", "constant", "reflect", "periodic"]
CFG = dict(half_window_x=3, half_window_y=2, poly_order=3, deriv_x=1,
           delta_x=0.5)


def _data(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, tol=F32_TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _within_ulp(got, want):
    got = torch.as_tensor(np.asarray(got, dtype=np.float64))
    want = torch.as_tensor(np.asarray(want, dtype=np.float64))
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= bf16_ulp_gate(want)).all())


@pytest.fixture(scope="module")
def jx():
    sg = pytest.importorskip("savgol_tpu")
    import jax.numpy as jnp
    return sg, jnp


def _port(dtype=torch.float32, **kw):
    return sgt.Savgol2D.create(sgt.Savgol2DConfig(**(kw or CFG)),
                               dtype=dtype, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_apply(boundary, shape, seed, dtype="float32"):
    import jax.numpy as jnp

    import savgol_tpu as sg
    x = _data(shape, seed)
    f = sg.Savgol2D.create(sg.Savgol2DConfig(**CFG), dtype=jnp.float32)
    y = f.apply(jnp.asarray(x).astype(getattr(jnp, dtype)),
                boundary=sg.Boundary2D(boundary), method="bf16")
    return x, np.asarray(y.astype(jnp.float32)), str(y.dtype)


# -- against the JAX package's bf16 routes ------------------------------------


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_apply_matches_jax_bf16(jx, boundary):
    x, want, _ = _jax_apply(boundary, (2, 64, 48), 70)
    y = _port().apply(torch.from_numpy(x), boundary=boundary, method="bf16")
    assert y.dtype == torch.float32
    _close(y, want)


def test_bf16_image_matches_jax_and_stays_bf16(jx):
    x, want, dtype = _jax_apply("constant", (2, 40, 56), 71, "bfloat16")
    y = _port().apply(torch.from_numpy(x).to(torch.bfloat16), method="bf16")
    assert y.dtype == torch.bfloat16 and dtype == "bfloat16"
    _within_ulp(y.float(), want)


def test_tiny_image_split_path_matches_jax_bf16(jx):
    """The JAX package pads twice for images shorter than its tile pad
    (``savgol2d_same_pallas_rowmxu``'s split path); the port's kernel maps
    the pad while staging at any size: the same values."""
    x, want, _ = _jax_apply("reflect", (3, 9, 11), 72)
    _close(_port().apply(torch.from_numpy(x), boundary="reflect",
                         method="bf16"), want)


@pytest.mark.parametrize("name", ["savgol2d_gradient", "savgol2d_hessian",
                                  "savgol2d_laplacian"])
def test_derivative_stacks_match_jax_bf16(jx, name):
    sg, jnp = jx
    x = _data((2, 50, 40), 73)
    want = getattr(sg, name)(jnp.asarray(x), 3, 2, 3, delta_x=0.5,
                             delta_y=0.25, boundary=sg.Boundary2D.REFLECT,
                             method="bf16")
    got = getattr(sgt, name)(torch.from_numpy(x), 3, 2, 3, delta_x=0.5,
                             delta_y=0.25, boundary="reflect", method="bf16")
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        _close(g, np.asarray(w))


def test_apply_stack_with_scales_matches_jax_bf16(jx):
    sg, jnp = jx
    from savgol_tpu.ops.apply2d import savgol2d_apply_stack
    x = _data((1, 30, 36), 74)
    ws = np.stack([_data((5, 7), 75 + k) for k in range(3)])
    scales = np.array([1.0, 0.5, 4.0], dtype=np.float32)
    for b in ("valid", "periodic"):
        want = savgol2d_apply_stack(jnp.asarray(x), jnp.asarray(ws),
                                       boundary=sg.Boundary2D(b),
                                       scales=jnp.asarray(scales),
                                       method="bf16")
        got = sgt.savgol2d_apply_stack(torch.from_numpy(x),
                                       torch.from_numpy(ws), boundary=b,
                                       scales=torch.from_numpy(scales),
                                       method="bf16")
        _close(got, np.asarray(want))


# -- the plain version against the row-banded Pallas kernels ------------------


@pytest.mark.parametrize("form", ["valid", "same", "stack"])
def test_plain_matches_rowmxu_pallas_kernels(jx, form):
    """``correlate2d_valid_bf16_plain`` against
    ``correlate2d_valid_pallas_rowmxu`` / ``savgol2d_same_pallas_rowmxu``
    / ``correlate2d_valid_pallas_rowmxu_stack`` on bf16 operands at DEFAULT
    precision (interpret mode), both with f32 and bf16 output."""
    sg, jnp = jx
    import jax
    from savgol_tpu.ops import pallas_conv as pc
    x = _data((2, 40, 70), 76)
    w = _data((3, 5, 7) if form == "stack" else (5, 7), 77)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    for out_dtype in (jnp.float32, None):
        kw = dict(mxu_precision=jax.lax.Precision.DEFAULT,
                  out_dtype=out_dtype)
        if form == "valid":
            want = pc.correlate2d_valid_pallas_rowmxu(xb, w, **kw)
            got = c2.correlate2d_valid_bf16_plain(
                torch.from_numpy(x), torch.from_numpy(w))
        elif form == "same":
            want = pc.savgol2d_same_pallas_rowmxu(xb, w, "symmetric", **kw)
            got = c2.correlate2d_valid_bf16_plain(
                torch.from_numpy(x), torch.from_numpy(w), "symmetric")
        else:
            want = jnp.moveaxis(pc.correlate2d_valid_pallas_rowmxu_stack(
                xb, w, **kw), 0, -3)
            got = c2.correlate2d_valid_bf16_plain(
                torch.from_numpy(x), torch.from_numpy(w))
        want = np.asarray(want.astype(jnp.float32))
        if out_dtype is None:      # bf16 out: the port's bf16 storage
            got = c2.correlate2d_valid_bf16_plain(
                torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                "symmetric" if form == "same" else None).float()
            _within_ulp(got, want)
        else:
            _close(got, want)


# -- the tensor-core kernel's band matrices ------------------------------------

WINDOWS = [(3, 3), (11, 11), (33, 33)]


@pytest.mark.parametrize("H,W", WINDOWS)
def test_row_bands_match_jax_rowband_matrices(jx, H, W):
    """``row_bands`` is the first S rows and 16 columns of the JAX row-band
    kernel's band stack, stencil row by stencil row."""
    from savgol_tpu.ops import pallas_conv as pc
    w = _data((H, W), 85 + W)
    S = c2.band_depth(W)
    want = np.asarray(pc._rowband_matrices(w))[:, :S, :16]
    got = c2.row_bands(torch.from_numpy(w), S)
    assert got.shape == (H, S, 16) and S >= 15 + W and S % 16 == 0
    np.testing.assert_array_equal(got.numpy(), want)


def _band_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The VALID correlation as the tensor-core kernel forms it: each block
    of 16 output columns at c is sum_y X[r + y, c : c + S] @ B_y, with X
    zero past its last column."""
    H, W = w.shape
    S = c2.band_depth(W)
    bands = c2.row_bands(w, S)
    R, C = x.shape
    Ro, Co = R - H + 1, C - W + 1
    nb = -(-Co // 16)
    xp = torch.nn.functional.pad(x, (0, 16 * (nb - 1) + S - C))
    cols = xp.unfold(-1, S, 16)                       # (R, nb, S)
    out = sum(torch.einsum("rbq,qp->rbp", cols[y:y + Ro], bands[y])
              for y in range(H))
    return out.reshape(Ro, nb * 16)[:, :Co]


@pytest.mark.parametrize("H,W", WINDOWS)
def test_row_band_product_matches_bf16_plain(H, W):
    """The band products over ``row_bands`` give the bf16 plain version's
    VALID correlation: the same exact products, summed in another order."""
    from savgol_tpu_torch.ops.cuda_conv import _bf16_operand, bf16_taps
    x = torch.from_numpy(_data((H + 20, W + 37), 86 + W))
    w = torch.from_numpy(_data((H, W), 87 + W))
    got = _band_product(_bf16_operand(x), bf16_taps(w))
    _close(got, c2.correlate2d_valid_bf16_plain(x, w))


# -- against float64 and the exact route's gradients --------------------------


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_within_contract_of_f64(boundary):
    x = _data((2, 60, 70), 78)
    y = _port(half_window_x=5, half_window_y=5, poly_order=3).apply(
        torch.from_numpy(x), boundary=boundary, method="bf16")
    want = _port(torch.float64, half_window_x=5, half_window_y=5,
                 poly_order=3).apply(torch.from_numpy(x.astype(np.float64)),
                                     boundary=boundary)
    _close(y, want, CONTRACT)


def test_gradient_matches_jax_exact_route(jx):
    sg, jnp = jx
    import jax
    f = sg.Savgol2D.create(sg.Savgol2DConfig(2, 2, 2), dtype=jnp.float32)
    img = (np.arange(64.0 * 64).reshape(64, 64) / 4096).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(f.apply(v, method="bf16") ** 2))(
        jnp.asarray(img))
    xt = torch.from_numpy(img).requires_grad_()
    (g,) = torch.autograd.grad(
        _port(half_window_x=2, half_window_y=2, poly_order=2).apply(
            xt, method="bf16").square().sum(), xt)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=3e-2,
                               atol=1e-3)


@pytest.mark.parametrize("stack", [False, True])
def test_f64_gradients_are_the_exact_routes(stack):
    """In f64 the image's and the stencil's gradients through the bf16 route
    equal the exact route's to 1e-12 (its backward is the exact plain
    version)."""
    x = torch.from_numpy(_data((2, 30, 26), 79, np.float64))
    w = torch.from_numpy(_data((3, 5, 5) if stack else (5, 5), 80,
                               np.float64))
    g = torch.from_numpy(_data((2, 3, 30, 26) if stack else (2, 30, 26), 81,
                               np.float64))
    grads = []
    for method in ("bf16", "xla"):
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = (sgt.savgol2d_apply_stack(xi, wi, boundary="reflect",
                                      method=method) if stack else
             sgt.savgol2d_apply(xi, wi, boundary="reflect", method=method))
        grads.append(torch.autograd.grad(y, [xi, wi], g))
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-12


def test_dtypes_of_the_2d_bf16_route():
    """f64 comes back f64 with bf16-rounded sums; f16 computes from f32
    and comes back f16; integers promote; complex filters its parts; wide
    stencils stay on the dense route."""
    x = _data((2, 30, 40), 82)
    f = _port()
    y32 = f.apply(torch.from_numpy(x), method="bf16")
    y64 = f.apply(torch.from_numpy(x).double(), method="bf16")
    assert y64.dtype == torch.float64
    assert torch.equal(y64, y32.to(torch.bfloat16).double())
    x16 = torch.from_numpy(x).half()
    assert torch.equal(f.apply(x16, method="bf16"),
                       f.apply(x16.float(), method="bf16").half())
    xi = torch.arange(600).reshape(20, 30) % 5
    assert torch.equal(f.apply(xi, method="bf16"),
                       f.apply(xi.float(), method="bf16"))
    xc = torch.complex(torch.from_numpy(x), torch.from_numpy(-x))
    assert torch.equal(f.apply(xc, method="bf16").real, y32)
    w = torch.from_numpy(_data((21, 21), 83))
    _close(sgt.savgol2d_apply(torch.from_numpy(x), w, method="bf16"),
           c2.correlate2d_valid_bf16_plain(torch.from_numpy(x), w, "edge"),
           0.0)


def test_unit_scale_is_not_multiplied(monkeypatch):
    """A ``Savgol2D`` scale buffer of exactly 1 reaches the route as no
    scale (``cuda_conv.scale_of``), so the bf16 route makes no pass over
    its output to multiply by 1 (as the JAX package's ``_apply_scale``
    skips a concrete 1.0); the buffer is read again after a change to it,
    and any other value, or a buffer that needs a gradient, reaches the
    route as a tensor. The values are those of a multiply by the buffer
    either way."""
    from savgol_tpu_torch.ops import apply2d
    real = apply2d._correlate
    seen = []

    def spy(x, w, s, *a):
        seen.append(s)
        return real(x, w, s, *a)

    monkeypatch.setattr(apply2d, "_correlate", spy)
    f = _port(half_window_x=2, half_window_y=2, poly_order=3)
    x = torch.from_numpy(_data((2, 24, 20), 85)).to(torch.bfloat16)
    for boundary in ("constant", "valid"):
        y = f.apply(x, boundary=boundary, method="bf16")
        assert seen[-1] is None
        one = torch.tensor(1.0, requires_grad=True)     # multiplied by 1
        assert torch.equal(y, sgt.savgol2d_apply(
            x, f.weights, boundary=boundary, scale=one,
            method="bf16").detach())
        assert seen[-1] is not None
    f.load_state_dict({"weights": f.weights, "scale": torch.tensor(2.0)})
    y = f.apply(x, method="bf16")
    assert seen[-1] is not None and float(seen[-1]) == 2.0
    assert torch.equal(y, 2 * sgt.savgol2d_apply(x, f.weights,
                                                 method="bf16"))
    f.scale.fill_(1.0)
    f.apply(x, method="bf16")
    assert seen[-1] is None
    f.scale.requires_grad_()
    f.apply(x, method="bf16")
    assert seen[-1] is not None and seen[-1].requires_grad


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W", [(3, 3), (11, 11), (7, 13), (33, 33)])
@pytest.mark.parametrize("pad_mode", [None, "edge", "symmetric", "wrap"])
@pytest.mark.parametrize("K", [1, 3])
def test_cuda_bf16_dense_matches_plain(cuda, storage, H, W, pad_mode, K):
    x = torch.from_numpy(_data((2, 70, 90), H * W + K)).to(cuda, storage)
    w = torch.from_numpy(_data((K, H, W) if K > 1 else (H, W), 84)).to(cuda)
    got = c2.correlate2d_valid_bf16_cuda(x, w, pad_mode)
    want = c2.correlate2d_valid_bf16_plain(x, w, pad_mode)
    assert got.dtype == storage
    if storage == torch.float32:
        _close(got.cpu(), want.cpu(), F32_TOL_2D)
    else:
        _within_ulp(got.float().cpu(), want.float().cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", [None, "edge", "symmetric", "wrap"])
@pytest.mark.parametrize("K", [1, 3])
def test_cuda_bf16_dense_rows_not_16_byte_aligned(cuda, storage, pad_mode,
                                                  K):
    """W = 33 on images whose rows are no whole number of 16-byte words
    (C % 8 != 0), so every row starts at another offset of the kernel's
    16-byte loads."""
    for C in (101, 2049):
        x = torch.from_numpy(_data((2, 45, C), C + K)).to(cuda, storage)
        w = torch.from_numpy(_data((K, 33, 33) if K > 1 else (33, 33),
                                   88)).to(cuda)
        got = c2.correlate2d_valid_bf16_cuda(x, w, pad_mode)
        want = c2.correlate2d_valid_bf16_plain(x, w, pad_mode)
        if storage == torch.float32:
            _close(got.cpu(), want.cpu(), F32_TOL_2D)
        else:
            _within_ulp(got.float().cpu(), want.float().cpu())


@pytest.mark.cuda
def test_cuda_bf16_entry_points_launch_one_dense_kernel(cuda):
    from savgol_tpu_torch.ops import cuda_conv2d
    f = sgt.Savgol2D.create(sgt.Savgol2DConfig(5, 5, 3), device=cuda)
    img = torch.randn(2, 256, 200, device=cuda).to(torch.bfloat16)
    for run in (lambda: f.apply(img, method="bf16"),
                lambda: f.apply_valid(img, method="bf16"),
                lambda: sgt.savgol2d_hessian(img, 5, 5, 3, method="bf16"),
                lambda: sgt.savgol2d_apply(img, torch.randn(
                    23, 23, device=cuda), method="bf16")):
        torch.cuda.synchronize()
        cuda_conv2d.reset_launches()
        run()
        torch.cuda.synchronize()
        assert cuda_conv2d.LAUNCHES == {"corr2d_valid": 1, "corr2d_sep": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W", [(3, 3), (11, 11), (7, 13), (33, 33)])
@pytest.mark.parametrize("K", [1, 3])
def test_cuda_bf16_dense_nonfinite_pattern_matches_plain(cuda, storage, H,
                                                         W, K):
    """A NaN or inf reaches exactly the outputs whose window holds it, as
    in the plain version (a tile holding one runs its window sums on the
    CUDA cores, not the band product, whose zeros would spread it over
    16-column blocks); the other outputs stay within the kernel's gate. A
    finite f32 sample past bf16's range rounds to inf on both sides."""
    x = torch.from_numpy(_data((2, 150, 300), H * W + K)).to(cuda)
    for b, r, c, v in ((0, 75, 90, "nan"), (0, 2, 1, "inf"),
                       (1, 64, 128, "-inf"), (1, 40, 40, "inf"),
                       (1, 40, 43, "-inf"), (1, 120, 250, 3.4e38)):
        x[b, r, c] = float(v)
    x = x.to(storage)
    from savgol_tpu_torch.ops.apply2d import _stencil_stack
    ws, _ = _stencil_stack((W - 1) // 2, (H - 1) // 2, 2,
                           [(2, 0), (1, 1), (0, 2)][:K], 0.5, 0.25)
    w = torch.from_numpy(ws if K > 1 else ws[0]).to(cuda, torch.float32)
    for pad_mode in (None, "edge", "symmetric", "wrap"):
        got = c2.correlate2d_valid_bf16_cuda(x, w, pad_mode)
        want = c2.correlate2d_valid_bf16_plain(x, w, pad_mode)
        for f in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(f(got), f(want)), (pad_mode, f.__name__)
        fin = torch.isfinite(want)
        assert not bool(fin.all())
        if storage == torch.float32:
            _close(got[fin].cpu(), want[fin].cpu(), F32_TOL)
        else:
            _within_ulp(got[fin].float().cpu(), want[fin].float().cpu())
