"""The port's 2D kernels (``savgol_tpu_torch.ops.cuda_conv2d``) against the
JAX package's 2D Pallas kernels.

On the CPU the plain PyTorch versions are compared with the Pallas kernels
run in interpret mode, as ``tests/test_2d.py`` and ``tests/test_pallas.py``
run them. The tests marked ``cuda`` compare the CUDA kernels with the plain
versions on the card and skip without one; they are the on-card lane of this
file:

    python -m pytest --noconftest -m cuda tests/test_torch_conv2d.py -q

Tolerance: abs error <= 2e-5 * max(1, max|ref|) for f32, the JAX package's
own for its 2D wrappers against XLA (``tests/test_2d.py:537``): the sides
sum the taps in different orders (the Pallas MXU kernels through HIGHEST-
precision matmul passes, the separable ones rank by rank). 1e-12 for f64.
On the card the kernels are held to 1e-5 against their plain versions, the
JAX package's exact-2D gate (``tests/test_2d.py:387``).
"""

import numpy as np
import pytest
import torch

from savgol_tpu_torch.config import Savgol2DConfig
from savgol_tpu_torch.ops import cuda_conv2d as c2
from savgol_tpu_torch.ops.apply2d import _stencil_stack
from savgol_tpu_torch.ops.weights import savgol2d_weights_np

F32_TOL = 2e-5
F64_TOL = 1e-12
MODES = ("edge", "symmetric", "wrap")


@pytest.fixture(scope="module")
def jax_kernels():
    """(pallas_conv, apply2d, jax.numpy); skips where JAX is not
    installed."""
    pallas_conv = pytest.importorskip("savgol_tpu.ops.pallas_conv")
    from savgol_tpu.ops import apply2d
    import jax.numpy as jnp
    return pallas_conv, apply2d, jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _stencil(H, W, dx=1, dy=0, dtype=np.float64):
    """A 2D derivative stencil of H x W taps (order 2 for 3-tap sides)."""
    order = 2 if min(H, W) == 3 else 3
    cfg = Savgol2DConfig((W - 1) // 2, (H - 1) // 2, order, deriv_x=dx,
                         deriv_y=dy)
    return savgol2d_weights_np(cfg, dtype=dtype)


def _data(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _tol(dtype):
    return F32_TOL if np.dtype(dtype) == np.float32 else F64_TOL


def _assert_close(got, want, tol=F32_TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} * {scale:.3e}"


# -- plain versions against the Pallas kernels (interpret mode) -------------


@pytest.mark.parametrize("H,W,dtype", [(5, 3, np.float32),
                                       (11, 11, np.float32),
                                       (7, 13, np.float64)])
def test_valid_plain_matches_dense_pallas(jax_kernels, H, W, dtype):
    """K5a/K5b through ``correlate2d_valid_pallas``."""
    pc, _, jnp = jax_kernels
    x = _data((2, 70, 90), seed=H * 100 + W, dtype=dtype)
    w = _stencil(H, W).astype(dtype)
    got = c2.correlate2d_valid_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (2, 70 - H + 1, 90 - W + 1)
    want = pc.correlate2d_valid_pallas(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True)
    _assert_close(got.numpy(), want, _tol(dtype))


@pytest.mark.parametrize("mode,shape,dtype", [
    ("edge", (2, 70, 90), np.float32),
    ("symmetric", (2, 70, 90), np.float64),
    ("wrap", (2, 70, 90), np.float32),
    ("edge", (2, 3, 5), np.float32),          # shorter than the pad
])
def test_same_plain_matches_fused_pad_pallas(jax_kernels, mode, shape,
                                             dtype):
    """K5b with the boundary pad fused (``savgol2d_same_pallas``); the tiny
    image takes its split-pad branch."""
    pc, _, jnp = jax_kernels
    x = _data(shape, seed=len(mode) + shape[1], dtype=dtype)
    w = _stencil(7, 9)
    got = c2.correlate2d_valid_plain(torch.from_numpy(x),
                                     torch.from_numpy(w.astype(dtype)), mode)
    assert got.shape == shape
    want = pc.savgol2d_same_pallas(jnp.asarray(x), w, mode, interpret=True)
    _assert_close(got.numpy(), want, _tol(dtype))


@pytest.mark.parametrize("mode", MODES)
def test_same_plain_matches_rowmxu(jax_kernels, mode):
    """K6a on the TPU's same-size route for 11+-tap windows."""
    _, a2, jnp = jax_kernels
    x = _data((2, 70, 90), seed=60 + len(mode))
    w = _stencil(11, 13).astype(np.float32)
    got = c2.correlate2d_valid_plain(torch.from_numpy(x), torch.from_numpy(w),
                                     mode)
    want = a2._pallas_rowmxu_same_exact_diff(mode, 5, 6)(jnp.asarray(x),
                                                        jnp.asarray(w))
    _assert_close(got.numpy(), want)


def test_valid_plain_matches_rowmxu(jax_kernels):
    _, a2, jnp = jax_kernels
    x = _data((60, 80), seed=61)
    w = _stencil(11, 15).astype(np.float32)
    got = c2.correlate2d_valid_plain(torch.from_numpy(x), torch.from_numpy(w))
    want = a2._pallas_rowmxu_exact_diff()(jnp.asarray(x), jnp.asarray(w))
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("K", [2, 3])
def test_stack_plain_matches_rowmxu_stack(jax_kernels, K):
    """K6b: K stencils over one read of the image, (..., K, R', C')."""
    _, a2, jnp = jax_kernels
    x = _data((2, 60, 80), seed=64 + K)
    derivs = [(1, 0), (0, 1)] if K == 2 else [(2, 0), (1, 1), (0, 2)]
    ws = _stencil_stack(6, 6, 3, derivs, 1.0, 1.0)[0].astype(np.float32)
    got = c2.correlate2d_valid_plain(torch.from_numpy(x),
                                     torch.from_numpy(ws))
    assert got.shape == (2, K, 48, 68)
    want = a2._pallas_rowmxu_stack_exact_diff()(jnp.asarray(x),
                                               jnp.asarray(ws))
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("engine,H,W,dtype", [
    ("vpu", 11, 11, np.float32),
    ("vpu", 33, 33, np.float32),
    ("vpu", 23, 17, np.float64),
    ("mxu", 11, 11, np.float32),
    ("mxu", 23, 23, np.float32),
])
def test_sep_plain_matches_sep_pallas(jax_kernels, engine, H, W, dtype):
    """K7a (engine "vpu") and K7b ("mxu") on the same host factors."""
    pc, _, jnp = jax_kernels
    x = _data((2, 70, 90), seed=H + W + len(engine), dtype=dtype)
    w = _stencil(H, W, dx=1, dy=1)
    u, v = c2._svd_stencil_np(w)
    assert np.array_equal(u, pc._svd_stencil_np(w)[0])
    got = c2.correlate2d_sep_plain(torch.from_numpy(x), torch.from_numpy(u),
                                   torch.from_numpy(v))
    want = pc.correlate2d_valid_pallas_sep(jnp.asarray(x), w, engine=engine,
                                           interpret=True)
    _assert_close(got.numpy(), want, _tol(dtype))


# -- CPU behaviour of the plain versions and wrappers ------------------------


@pytest.mark.parametrize("mode", MODES)
def test_pad2d_plain_matches_numpy_for_any_width(mode):
    x = _data((2, 3, 5), seed=3, dtype=np.float64)
    for ny, nx in ((0, 0), (1, 2), (3, 5), (16, 16)):
        got = c2.pad2d_plain(torch.from_numpy(x), ny, nx, mode).numpy()
        want = np.pad(x, ((0, 0), (ny, ny), (nx, nx)), mode=mode)
        assert np.array_equal(got, want), (ny, nx)


def test_sep_plain_equals_dense_plain_in_f64():
    x = torch.from_numpy(_data((3, 37, 29), seed=5, dtype=np.float64))
    for H, W in ((3, 3), (33, 25), (5, 23)):
        w = _stencil(H, W, dx=0, dy=1)
        u, v = (torch.from_numpy(f) for f in c2._svd_stencil_np(w))
        for mode in (None, *MODES):
            _assert_close(c2.correlate2d_sep_plain(x, u, v, mode).numpy(),
                          c2.correlate2d_valid_plain(
                              x, torch.from_numpy(w), mode).numpy(), F64_TOL)


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    x = torch.from_numpy(_data((2, 40, 30), seed=7))
    w = torch.from_numpy(_stencil(5, 7).astype(np.float32))
    ws = torch.stack([w, 2 * w])
    u, v = (torch.from_numpy(f.astype(np.float32))
            for f in c2._svd_stencil_np(w.double().numpy()))
    c2.reset_launches()
    for mode in (None, *MODES):
        assert torch.equal(c2.correlate2d_valid_cuda(x, w, mode),
                           c2.correlate2d_valid_plain(x, w, mode))
        assert torch.equal(c2.correlate2d_valid_cuda(x, ws, mode),
                           c2.correlate2d_valid_plain(x, ws, mode))
        assert torch.equal(c2.correlate2d_sep_cuda(x, u, v, mode),
                           c2.correlate2d_sep_plain(x, u, v, mode))
    assert c2.LAUNCHES == {"corr2d_valid": 0, "corr2d_sep": 0}


def test_plain_rejects_what_neither_version_takes():
    x = torch.zeros(4, 10)
    w = torch.ones(11, 3)
    # an image smaller than the stencil has no VALID rows (the JAX package's
    # shape), not an error
    y = c2.correlate2d_valid_plain(x, w)
    assert y.shape == (0, 8) and y.dtype == x.dtype
    with pytest.raises(ValueError, match="pad mode"):
        c2.correlate2d_valid_plain(x, w, "reflect")
    with pytest.raises(ValueError, match="two axes"):
        c2.correlate2d_valid_plain(torch.zeros(30), w, "edge")
    assert c2.correlate2d_valid_plain(x, w, "wrap").shape == (4, 10)


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 2047, 2049), (3, 37, 29), (2, 3, 5)])
@pytest.mark.parametrize("H,W", [(3, 3), (5, 3), (11, 11), (7, 13), (17, 15),
                                 (23, 23), (33, 33)])
def test_cuda_kernels_match_plain(cuda, H, W, shape, dtype):
    npdt = np.float32 if dtype == torch.float32 else np.float64
    tol = 1e-5 if dtype == torch.float32 else F64_TOL
    x = torch.from_numpy(_data(shape, seed=H + W + shape[1], dtype=npdt)).to(
        cuda)
    ws = torch.from_numpy(_stencil_stack(
        (W - 1) // 2, (H - 1) // 2, 2 if min(H, W) == 3 else 3,
        [(2, 0), (1, 1), (0, 2)], 1.0, 1.0)[0]).to(cuda, dtype)
    u, v = (torch.from_numpy(f).to(cuda, dtype)
            for f in c2._svd_stencil_np(ws[1].double().cpu().numpy()))
    for mode in (None, *MODES):
        if mode is None and (shape[1] < H or shape[2] < W):
            continue
        for w in (ws[1], ws):
            before = c2.LAUNCHES["corr2d_valid"]
            got = c2.correlate2d_valid_cuda(x, w, mode)
            assert c2.LAUNCHES["corr2d_valid"] == before + 1
            _assert_close(got.cpu(), c2.correlate2d_valid_plain(
                x, w, mode).cpu(), tol)
        before = c2.LAUNCHES["corr2d_sep"]
        got = c2.correlate2d_sep_cuda(x, u, v, mode)
        assert c2.LAUNCHES["corr2d_sep"] == before + 1
        _assert_close(got.cpu(), c2.correlate2d_sep_plain(
            x, u, v, mode).cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,rank,dtype,want", [
    (11, 11, 2, torch.float32, "sweep 11x11"),
    (11, 11, 6, torch.float32, "sweep 11x11"),
    (21, 21, 3, torch.float32, "sweep 21x21"),
    (33, 33, 4, torch.float32, "sweep 33x33"),
    (33, 33, 6, torch.float32, "sweep 33x33"),
    (33, 33, 13, torch.float32, "tile"), (17, 25, 3, torch.float32, "sweep"),
    (13, 13, 2, torch.float32, "sweep"),
    (11, 11, 2, torch.float64, "sweep 11x11"),
    (33, 33, 4, torch.float64, "sweep 33x33"),
    (33, 33, 7, torch.float64, "tile")])
def test_sep_instance_follows_the_sweep_rule(cuda, H, W, rank, dtype, want):
    """K2D-sep's instance, as the kernel library decides it: the sweep
    while its ring fits in the 227 KB a block may hold, at compile-time
    widths for the square windows 11 and 19-33 and at runtime widths
    otherwise, else the tiles."""
    assert c2.sep_instance(H, W, rank, dtype) == want


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(2, 40, 50, device=cuda)
    w = torch.ones(5, 5, device=cuda)
    with pytest.raises(TypeError):
        c2.correlate2d_valid_cuda(x.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        c2.correlate2d_valid_cuda(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="weights on"):
        c2.correlate2d_valid_cuda(x, w.cpu())
    with pytest.raises(ValueError, match="odd"):
        c2.correlate2d_valid_cuda(x, torch.ones(4, 5, device=cuda))
    with pytest.raises(ValueError, match="odd"):
        c2.correlate2d_valid_cuda(x, torch.ones(35, 5, device=cuda), "edge")
    # an image smaller than the stencil: an empty result and no launch
    before = dict(c2.LAUNCHES)
    y = c2.correlate2d_valid_cuda(x[:, :3].contiguous(), w)
    assert y.shape == (2, 0, 46) and y.device == x.device
    assert c2.LAUNCHES == before
    with pytest.raises(ValueError, match="factors"):
        c2.correlate2d_sep_cuda(x, torch.ones(2, 5, device=cuda),
                                torch.ones(3, 5, device=cuda))


def _same_nonfinite(got, want):
    """NaN, +inf and -inf in the same outputs; the finite ones returned."""
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(got), f(want)), f.__name__
    fin = torch.isfinite(want)
    assert not bool(fin.all())
    return got[fin], want[fin]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("H,W", [(3, 3), (11, 11), (7, 13), (5, 3),
                                 (33, 33)])
def test_cuda_nonfinite_pattern_matches_plain(cuda, H, W, dtype):
    """K2D-dense (one stencil and three) and K2D-sep on an image holding
    NaN, +inf and -inf inside, at an edge, on a tile corner and +inf with
    -inf in one window: the same non-finite outputs as the plain versions
    in every boundary, the finite ones within 1e-5 scaled (f32)."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x = torch.from_numpy(_data((2, 150, 300), seed=H * W, dtype=npdt)).to(
        cuda)
    for b, r, c, v in ((0, 75, 90, "nan"), (0, 2, 1, "inf"),
                       (1, 64, 128, "-inf"), (1, 40, 40, "inf"),
                       (1, 40, 43, "-inf")):
        x[b, r, c] = float(v)
    ws = torch.from_numpy(_stencil_stack(
        (W - 1) // 2, (H - 1) // 2, 2 if min(H, W) == 3 else 3,
        [(2, 0), (1, 1), (0, 2)], 1.0, 1.0)[0]).to(cuda, dtype)
    u, v = (torch.from_numpy(f).to(cuda, dtype)
            for f in c2._svd_stencil_np(ws[1].double().cpu().numpy()))
    tol = 1e-5 if dtype == torch.float32 else F64_TOL
    for mode in (None, *MODES):
        for w in (ws[1], ws):
            got, want = _same_nonfinite(c2.correlate2d_valid_cuda(x, w, mode),
                                        c2.correlate2d_valid_plain(x, w, mode))
            _assert_close(got.cpu(), want.cpu(), tol)
        got, want = _same_nonfinite(c2.correlate2d_sep_cuda(x, u, v, mode),
                                    c2.correlate2d_sep_plain(x, u, v, mode))
        _assert_close(got.cpu(), want.cpu(), tol)


# K2D-sep's sweep windows: the compile-time square widths (every one that
# method="auto" sends past 17, and 11), then windows of the runtime-width
# instance: square widths without one, rectangles both ways (17 x 25 is one
# "auto" sends), single rows and columns
_SWEEP_WINDOWS = [(h, h) for h in (11, 19, 21, 23, 25, 27, 29, 31, 33)] + [
    (13, 13), (15, 15), (17, 17), (17, 25), (25, 17), (5, 5), (3, 33),
    (1, 11), (11, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rank", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("H,W", _SWEEP_WINDOWS)
def test_cuda_sep_sweep_matches_plain(cuda, H, W, rank, dtype):
    """K2D-sep's sweep at every width its compile-time instances take (and
    that ``method="auto"`` sends past 17) and at runtime widths, ranks 1-4
    and 6, random factors, every boundary, on images whose last strip and
    band are ragged: within 1e-5 scaled (f32) and 1e-12 (f64) of the plain
    version, one launch each."""
    assert c2.sep_instance(H, W, rank, dtype).startswith("sweep")
    npdt = np.float32 if dtype == torch.float32 else np.float64
    tol = 1e-5 if dtype == torch.float32 else F64_TOL
    x = torch.from_numpy(_data((2, 300, 131), seed=H * W * rank,
                               dtype=npdt)).to(cuda)
    u = torch.from_numpy(_data((rank, H), H + rank, npdt)).to(cuda)
    v = torch.from_numpy(_data((rank, W), 2 * W + rank, npdt)).to(cuda)
    for mode in (None, *MODES):
        before = c2.LAUNCHES["corr2d_sep"]
        got = c2.correlate2d_sep_cuda(x, u, v, mode)
        assert c2.LAUNCHES["corr2d_sep"] == before + 1
        _assert_close(got.cpu(), c2.correlate2d_sep_plain(
            x, u, v, mode).cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("H,W,rank", [(11, 11, 2), (21, 21, 3), (33, 33, 4),
                                      (11, 11, 6), (17, 25, 3), (13, 13, 3)])
def test_cuda_sep_sweep_nonfinite_pattern_matches_plain(cuda, H, W, rank,
                                                        dtype):
    """K2D-sep's sweep on an image holding NaN, +inf and -inf on the
    boundaries of its chunks (32 rows), bands (256 rows) and strips (64
    columns), at an edge and +inf with -inf in one window: the plain
    version's non-finite outputs, the finite ones within its gate."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x = torch.from_numpy(_data((2, 300, 150), seed=H + rank, dtype=npdt)).to(
        cuda)
    for b, r, c, v in ((0, 31, 63, "nan"), (0, 32, 64, "inf"),
                       (0, 255, 100, "-inf"), (1, 256, 127, "nan"),
                       (1, 0, 149, "inf"), (1, 150, 40, "inf"),
                       (1, 150, 42, "-inf")):
        x[b, r, c] = float(v)
    u = torch.from_numpy(_data((rank, H), H, npdt)).to(cuda)
    v = torch.from_numpy(_data((rank, W), W + 1, npdt)).to(cuda)
    tol = 1e-5 if dtype == torch.float32 else F64_TOL
    for mode in (None, *MODES):
        got, want = _same_nonfinite(c2.correlate2d_sep_cuda(x, u, v, mode),
                                    c2.correlate2d_sep_plain(x, u, v, mode))
        _assert_close(got.cpu(), want.cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rank", [(torch.float32, 13),
                                        (torch.float64, 7)])
def test_cuda_sep_tile_matches_plain(cuda, dtype, rank):
    """K2D-sep's tile instance, which takes the rings past 227 KB (33 x 33
    at rank 13 in f32, 7 in f64), on a ragged image in every boundary:
    within 1e-5 scaled (f32) and 1e-12 (f64) of the plain version."""
    assert c2.sep_instance(33, 33, rank, dtype) == "tile"
    npdt = np.float32 if dtype == torch.float32 else np.float64
    tol = 1e-5 if dtype == torch.float32 else F64_TOL
    x = torch.from_numpy(_data((2, 150, 131), seed=rank, dtype=npdt)).to(
        cuda)
    u = torch.from_numpy(_data((rank, 33), 33 + rank, npdt)).to(cuda)
    v = torch.from_numpy(_data((rank, 33), 66 + rank, npdt)).to(cuda)
    for mode in (None, *MODES):
        _assert_close(c2.correlate2d_sep_cuda(x, u, v, mode).cpu(),
                      c2.correlate2d_sep_plain(x, u, v, mode).cpu(), tol)


# K2D-sep's staging: the input ring (bulk copies) where a ring keeps the
# blocks an SM and the rows are 16-byte aligned, stage4 otherwise
@pytest.mark.cuda
@pytest.mark.parametrize("H,W,rank,dtype,want", [
    (11, 11, 2, torch.float32, "ring"), (11, 11, 6, torch.float32, "ring"),
    (13, 13, 2, torch.float32, "ring"), (17, 25, 3, torch.float32, "stage4"),
    (21, 21, 3, torch.float32, "stage4"), (23, 23, 3, torch.float32, "ring"),
    (25, 25, 3, torch.float32, "stage4"), (33, 33, 4, torch.float32, "stage4"),
    (33, 33, 4, torch.float64, "ring"),
    (11, 11, 2, torch.float64, "ring"), (33, 33, 2, torch.float64, "stage4"),
    (33, 33, 13, torch.float32, None), (33, 33, 7, torch.float64, None)])
def test_sep_staging_follows_the_ring_rule(cuda, H, W, rank, dtype, want):
    """K2D-sep's staging, as the kernel library decides it: the ring where
    up to 3 stages keep the SM's blocks (21 x 21 rank 3 in f32 would lose
    one, 33 x 33 rank 2 in f64 too) and an f32 stencil takes at most 144
    FMAs a pixel (25 x 25 rank 3 takes 150), stage4 otherwise and for an
    image whose base or rows are not 16-byte aligned; None for the
    tiles."""
    x = torch.zeros(1, 64, 64, device=cuda, dtype=dtype)
    assert c2.sep_staging(x, H, W, rank) == want
    for bad in (_misaligned(x), torch.zeros(1, 64, 63, device=cuda,
                                            dtype=dtype)):
        assert c2.sep_staging(bad, H, W, rank) == (want and "stage4")


def _misaligned(x):
    """A contiguous copy of ``x`` one sample past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def _bits(t):
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


# every compile-time width of the sweep and two of its runtime one
_RING_WINDOWS = [(h, h) for h in (11, 19, 21, 23, 25, 27, 29, 31, 33)] + [
    (13, 13), (17, 25)]


@pytest.mark.cuda
@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("H,W", _RING_WINDOWS)
def test_cuda_sep_ring_matches_plain_and_stage4(cuda, H, W, dtype,
                                                nonfinite):
    """K2D-sep's input ring at every compile-time width and at runtime
    widths, rank 1 (a ring at every width) and the widths' ring ranks, on
    an image of 600 rows (neither a multiple of 32 nor of 512) and 200
    columns (not a multiple of 64), in every boundary, with and without
    NaN, +inf and -inf on chunk, band and strip boundaries and at an edge:
    within the plain version's gate (the same non-finite outputs), and bit
    for bit the stage4 route's outputs for the same image one sample past
    a 16-byte boundary; one count in STAGING each."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    tol = 1e-5 if dtype == torch.float32 else F64_TOL
    x = torch.from_numpy(_data((2, 600, 200), seed=H * W, dtype=npdt)).to(
        cuda)
    if nonfinite:
        for b, r, c, v in ((0, 31, 63, "nan"), (0, 32, 64, "inf"),
                           (0, 511, 100, "-inf"), (1, 512, 127, "nan"),
                           (1, 0, 199, "inf"), (1, 300, 40, "inf"),
                           (1, 300, 42, "-inf"), (1, 599, 0, "nan")):
            x[b, r, c] = float(v)
    shifted = _misaligned(x)
    ranks = [r for r in (1, 2, 3) if c2.sep_staging(x, H, W, r) == "ring"]
    assert ranks[0] == 1
    for rank in ranks:
        u = torch.from_numpy(_data((rank, H), H + rank, npdt)).to(cuda)
        v = torch.from_numpy(_data((rank, W), W + rank, npdt)).to(cuda)
        for mode in (None, *MODES):
            before = dict(c2.STAGING)
            got = c2.correlate2d_sep_cuda(x, u, v, mode)
            assert c2.STAGING == {**before, "ring": before["ring"] + 1}
            other = c2.correlate2d_sep_cuda(shifted, u, v, mode)
            assert c2.STAGING == {"ring": before["ring"] + 1,
                                  "stage4": before["stage4"] + 1}
            assert torch.equal(_bits(got), _bits(other)), (rank, mode)
            want = c2.correlate2d_sep_plain(x, u, v, mode)
            if nonfinite:
                got, want = _same_nonfinite(got, want)
            _assert_close(got.cpu(), want.cpu(), tol)


@pytest.mark.cuda
def test_cuda_headline_counts_one_ring_and_unaligned_rows_stage4(cuda):
    """Savgol2D(5, 5, 3).apply on an aligned (16, 2048, 2048) f32 batch is
    one K2D-sep launch through the ring; a column slice x[..., 1:] and
    2047-sample rows go through stage4 and give, bit for bit, the ring's
    outputs for the same rows with their last column repeated (the
    CONSTANT border repeats it anyway)."""
    from savgol_tpu_torch import Savgol2D
    f = Savgol2D.create(Savgol2DConfig(5, 5, 3), device=cuda)
    x = torch.from_numpy(_data((16, 2048, 2048), seed=28)).to(cuda)
    before = dict(c2.STAGING), dict(c2.LAUNCHES)
    f.apply(x)
    assert c2.STAGING == {**before[0], "ring": before[0]["ring"] + 1}
    assert c2.LAUNCHES == {**before[1],
                           "corr2d_sep": before[1]["corr2d_sep"] + 1}
    for part in (x[..., 1:], x[..., :2047]):
        before = dict(c2.STAGING)
        got = f.apply(part)
        assert c2.STAGING == {**before, "stage4": before["stage4"] + 1}
        ring = f.apply(torch.cat([part, part[..., -1:]], -1))[..., :2047]
        assert c2.STAGING["ring"] == before["ring"] + 1
        assert torch.equal(_bits(got), _bits(ring.contiguous()))
