"""``method="bf16"`` of the port's 1D paths against the JAX package's bf16
routes: ``Savgol1D.apply`` (POLYNOMIAL and the three padded boundaries),
``apply_valid``, ``scipy_compat.savgol_filter`` and
``parallel.apply_sharded``, on the same numpy-seeded inputs.

On the CPU the port runs its kernels' bf16 plain versions; the JAX side runs
its bf16 Pallas kernels in interpret mode, as its own tests do
(``tests/test_apply.py:431-498``). Both round the samples and the taps
(``bf16(bf16(w) * bf16(dt_inv))``) to bf16, sum exact products in f32 and
round each output to bf16, so they may differ where the two f32 sums, taken
in other orders, straddle a bf16 rounding boundary. Tolerance: one bf16 ulp
of each output plus 1e-6 * max|y| (``ops.cuda_conv.bf16_ulp_gate``). The
padded boundaries are held to the JAX CPU route at ``time_step = 1`` only:
there JAX pads, then runs its VALID kernel and multiplies by ``dt_inv``
after the bf16 output, where the port (as the TPU's fused route) folds
``dt_inv`` into the taps. Against float64 the gate is the JAX tests' 3e-2
of max|y| (``tests/test_apply.py:442``); gradients go through the exact
route (``tests/test_apply.py:496-498``: rtol 2e-2, atol 1e-3; f64 1e-12).

The JAX references are computed once per module (each interpret-mode call
costs seconds), at small sizes. The tests marked ``cuda`` hold the kernels'
bf16 modes against their plain versions on the card and count launches.
"""

import functools

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch import scipy_compat as tsc
from savgol_tpu_torch.ops import cuda_conv as cc
from savgol_tpu_torch.ops import cuda_conv2d as c2
from savgol_tpu_torch.ops.cuda_conv import bf16_ulp_gate
from savgol_tpu_torch.ops.weights import savgol_weights_np
from savgol_tpu_torch.parallel.launch import (Full, Pool, Sharded,
                                              run_sharded)

CONTRACT = 3e-2
POLY = [(8, 3, 0, False), (8, 3, 1, False), (8, 3, 1, True), (6, 4, 2, False)]
PADDED = ["reflect", "periodic", "constant"]
SCIPY_MODES = ["interp", "mirror", "nearest", "wrap", "constant"]
SEQ4 = (("batch", "seq"), (1, 4))


def _data(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _f64(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double()
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _within_ulp(got, want):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    err = (got - want).abs()
    gate = bf16_ulp_gate(want)
    assert bool((err <= gate).all()), (
        f"{int((err > gate).sum())} outputs past one bf16 ulp, max "
        f"{err.max().item():.3e}")


def _within_contract(got, want, tol=CONTRACT):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


@pytest.fixture(scope="module")
def jx():
    sg = pytest.importorskip("savgol_tpu")
    import jax.numpy as jnp
    return sg, jnp


@functools.lru_cache(maxsize=None)
def _jax_apply(n, m, d, sign, boundary, shape, seed, step, valid=False,
               dtype="float32"):
    """The JAX package's bf16 ``apply`` (or ``apply_valid``), memoised:
    (x, y) as numpy arrays."""
    import jax.numpy as jnp

    import savgol_tpu as sg
    x = _data(shape, seed)
    f = sg.Savgol1D.create(sg.SavgolConfig(n, m, d, time_step=step,
                                           boundary=boundary),
                           dtype=jnp.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    y = (f.apply_valid(xj, method="bf16") if valid else
         f.apply(xj, method="bf16", reference_edge_sign=sign))
    return x, np.asarray(y.astype(jnp.float32))


def _port(n, m, d, boundary="polynomial", step=1.0, dtype=torch.float32):
    return sgt.Savgol1D.create(sgt.SavgolConfig(n, m, d, time_step=step,
                                                boundary=boundary),
                               dtype=dtype, device="cpu")


# -- against the JAX package's bf16 routes ------------------------------------


@pytest.mark.parametrize("n,m,d,sign", POLY)
def test_polynomial_matches_jax_bf16(jx, n, m, d, sign):
    x, want = _jax_apply(n, m, d, sign, "polynomial", (4, 2048), 40, 0.5)
    y = _port(n, m, d, step=0.5).apply(torch.from_numpy(x), method="bf16",
                                       reference_edge_sign=sign)
    assert y.dtype == torch.float32
    _within_ulp(y, want)


@pytest.mark.parametrize("boundary", PADDED)
def test_padded_matches_jax_bf16_at_unit_step(jx, boundary):
    x, want = _jax_apply(6, 2, 0, False, boundary, (2, 700), 41, 1.0)
    y = _port(6, 2, 0, boundary).apply(torch.from_numpy(x), method="bf16")
    _within_ulp(y, want)


def test_valid_matches_jax_bf16(jx):
    x, want = _jax_apply(6, 2, 1, False, "polynomial", (2, 600), 42, 0.25,
                         valid=True)
    y = _port(6, 2, 1, step=0.25).apply_valid(torch.from_numpy(x),
                                              method="bf16")
    _within_ulp(y, want)


@pytest.mark.parametrize("valid", [False, True])
def test_bf16_input_matches_jax_and_stays_bf16(jx, valid):
    x, want = _jax_apply(4, 2, 1, False, "polynomial", (2, 512), 44, 0.5,
                         valid=valid, dtype="bfloat16")
    f = _port(4, 2, 1, step=0.5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    y = f.apply_valid(xt, method="bf16") if valid else f.apply(
        xt, method="bf16")
    assert y.dtype == torch.bfloat16
    _within_ulp(y.float(), want)


@pytest.mark.parametrize("mode", SCIPY_MODES)
def test_scipy_compat_matches_jax_bf16(jx, mode):
    sg, jnp = jx
    from savgol_tpu import scipy_compat as jsc
    row = _data(500, 45)
    want = np.asarray(jsc.savgol_filter(jnp.asarray(row), 11, 3, deriv=1,
                                        delta=0.5, mode=mode, cval=0.5,
                                        method="bf16"))
    got = tsc.savgol_filter(row, 11, 3, deriv=1, delta=0.5, mode=mode,
                            cval=0.5, method="bf16", device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    _within_ulp(got, want)


# -- against float64 ------------------------------------------------------------


@pytest.mark.parametrize("N,n,m", [(2048, 8, 3), (12289, 12, 4), (509, 5, 2),
                                   (25, 12, 4)])
def test_polynomial_within_contract_of_f64(N, n, m):
    """Every length runs in bf16: N = 12289, which no TPU block width
    admits (the JAX package falls back to its exact path there), is held to
    the contract against f64, as are an odd length and N = ws."""
    x = _data((2, N), 43)
    f = _port(n, m, 0)
    y = f.apply(torch.from_numpy(x), method="bf16")
    f64 = _port(n, m, 0, dtype=torch.float64)
    want = f64.apply(torch.from_numpy(x.astype(np.float64)))
    assert not torch.equal(y.double(), want)
    _within_contract(y, want)


@pytest.mark.parametrize("boundary", PADDED)
def test_padded_within_contract_of_f64_at_other_steps(boundary):
    """At time_step != 1 the port folds dt_inv into the bf16 taps (the TPU's
    fused route) where the JAX CPU route multiplies after: held to f64."""
    x = _data((3, 700), 46)
    y = _port(6, 3, 1, boundary, step=0.01).apply(torch.from_numpy(x),
                                                   method="bf16")
    want = _port(6, 3, 1, boundary, step=0.01, dtype=torch.float64).apply(
        torch.from_numpy(x.astype(np.float64)))
    _within_contract(y, want)


def test_valid_and_axis_within_contract_of_f64():
    x = _data((600, 3), 47)
    f = _port(6, 2, 2, step=0.5)
    y = f.apply_valid(torch.from_numpy(x), axis=0, method="bf16")
    want = _port(6, 2, 2, step=0.5, dtype=torch.float64).apply_valid(
        torch.from_numpy(x.astype(np.float64)), axis=0)
    assert y.shape == (588, 3)
    _within_contract(y, want)


def test_dtypes_of_the_bf16_route():
    """f16 computes from f32 and comes back f16; f64 comes back f64 with
    bf16-rounded values; integers promote to the weights' dtype; complex
    input filters its parts."""
    x = _data((2, 300), 48)
    f = _port(5, 2, 0)
    y32 = f.apply(torch.from_numpy(x), method="bf16")
    x16 = torch.from_numpy(x).half()
    y16 = f.apply(x16, method="bf16")
    assert y16.dtype == torch.float16
    assert torch.equal(y16, f.apply(x16.float(), method="bf16").half())
    y64 = f.apply(torch.from_numpy(x).double(), method="bf16")
    assert y64.dtype == torch.float64
    assert torch.equal(y64, y64.to(torch.bfloat16).double())
    _within_contract(y64, y32)
    xi = torch.arange(300).reshape(2, 150) % 7
    yi = f.apply(xi, method="bf16")
    assert yi.dtype == torch.float32
    assert torch.equal(yi, f.apply(xi.float(), method="bf16"))
    xc = torch.complex(torch.from_numpy(x), torch.from_numpy(x[::-1].copy()))
    yc = f.apply(xc, method="bf16")
    assert torch.equal(yc.real, y32)
    assert torch.equal(yc.imag, f.apply(xc.imag, method="bf16"))


# -- gradients through the exact twin -------------------------------------------


@pytest.mark.parametrize("boundary", ["polynomial", "reflect"])
def test_gradient_matches_jax_exact_route(jx, boundary):
    """jax.grad of sum(apply(x, "bf16") ** 2): the custom VJP takes the
    exact f32 twin's VJP, at the bf16 forward's cotangent."""
    sg, jnp = jx
    import jax
    x = np.arange(512.0, dtype=np.float32) / 64
    fj = sg.Savgol1D.create(sg.SavgolConfig(4, 2, boundary=boundary),
                            dtype=jnp.float32)
    want = jax.grad(lambda v: jnp.sum(fj.apply(v, method="bf16") ** 2))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(
        _port(4, 2, 0, boundary).apply(xt, method="bf16").square().sum(), xt)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=2e-2,
                               atol=1e-3)


@pytest.mark.parametrize("route", ["polynomial", "periodic", "valid"])
def test_f64_gradients_are_the_exact_routes(route):
    """The backward of every bf16 route is the exact plain version's: in
    f64, against any cotangent, the gradients in x, the weights and dt_inv
    equal the exact route's to 1e-12. (``apply_valid`` multiplies its bf16
    output by dt_inv after, as the JAX package's does, so its dt_inv
    gradient is taken at that output: it is left out there.)"""
    x = torch.from_numpy(_data((2, 200), 49, np.float64)).requires_grad_()
    g = torch.from_numpy(_data((2, 200 if route != "valid" else 186), 50,
                               np.float64))
    grads = []
    for method in ("bf16", "xla"):
        f = _port(7, 3, 1, "periodic" if route == "periodic" else
                  "polynomial", step=0.5, dtype=torch.float64)
        params = [x, f.center_weights.requires_grad_(),
                  f.dt_inv.requires_grad_()][:2 if route == "valid" else 3]
        y = (f.apply_valid(x, method=method) if route == "valid" else
             f.apply(x, method=method))
        grads.append(torch.autograd.grad(y, params, g))
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-12


def test_bf16_input_gradient_is_bf16():
    x = torch.from_numpy(_data((2, 128), 51)).to(torch.bfloat16)
    x.requires_grad_()
    (g,) = torch.autograd.grad(
        _port(4, 2, 0).apply(x, method="bf16").float().sum(), x)
    assert g.dtype == torch.bfloat16


# -- the sharded route on a gloo pool of 4 --------------------------------------


@pytest.fixture(scope="module")
def pool():
    with Pool(4, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def jax_mesh(jx):
    import jax
    from savgol_tpu.parallel.sharded import make_mesh
    return make_mesh(*SEQ4, devices=jax.devices()[:4])


@pytest.mark.parametrize("boundary", ["polynomial", "reflect", "constant",
                                      "periodic"])
def test_apply_sharded_matches_jax_bf16(jx, pool, jax_mesh, boundary):
    """Four ranks, ``method="bf16"``: K3's bf16 plain version on each
    rank's extended block, the outer POLYNOMIAL edge rows exact in f32 and
    ``dt_inv`` after, as the JAX package's sharded route; within one bf16
    ulp of it, and of the single-device bf16 apply away from the outer n
    samples."""
    sg, jnp = jx
    from savgol_tpu.parallel.sharded import apply_sharded as jax_sharded
    n, m, d, step = 6, 3, 1, 0.5
    x = _data((3, 1024), 52)
    fj = sg.Savgol1D.create(sg.SavgolConfig(n, m, d, time_step=step),
                            dtype=jnp.float32)
    want = np.asarray(jax_sharded(
        jnp.asarray(x), fj.center_weights, fj.edge_weights, half_window=n,
        mesh=jax_mesh, boundary=sg.BoundaryMode(boundary), dt_inv=fj.dt_inv,
        derivative=d, method="bf16"))
    cfg = sgt.SavgolConfig(n, m, d, time_step=step)
    cw, ew = (a.astype(np.float32) for a in savgol_weights_np(cfg))
    y, _ = pool.run(run_sharded, "apply_sharded", *SEQ4,
                    [Sharded(x, (None, "seq")), Full(cw), Full(ew)],
                    dict(half_window=n, boundary=boundary,
                         dt_inv=np.float32(1.0 / cfg.dt_scale), derivative=d,
                         method="bf16", halo="rdma"), (None, "seq"))[0]
    _within_ulp(y, want)
    single = _port(n, m, d, boundary, step=step).apply(
        torch.from_numpy(x), method="bf16").numpy()
    _within_ulp(y[:, n:-n], single[:, n:-n])


def test_apply2d_sharded_matches_jax_bf16(jx, pool, jax_mesh):
    """Rows over four ranks, ``method="bf16"``: K2D-dense's bf16 plain
    version on each rank's extended block, f32 sums (2e-6 scaled)."""
    sg, jnp = jx
    from savgol_tpu.parallel.sharded2d import apply2d_sharded as jax_2d
    from savgol_tpu_torch.ops.weights import savgol2d_weights_np
    img = _data((2, 64, 40), 53)
    cfg = sgt.Savgol2DConfig(3, 2, 3, deriv_x=1, delta_x=0.5)
    fj = sg.Savgol2D.create(sg.Savgol2DConfig(3, 2, 3, deriv_x=1,
                                              delta_x=0.5),
                            dtype=jnp.float32)
    for boundary in ("constant", "valid"):
        want = np.asarray(jax_2d(jnp.asarray(img), fj.weights,
                                 mesh=jax_mesh,
                                 boundary=sg.Boundary2D(boundary),
                                 scale=fj.scale, method="bf16"))
        y, _ = pool.run(run_sharded, "apply2d_sharded", *SEQ4,
                        [Sharded(img, (None, "seq", None)),
                         Full(savgol2d_weights_np(cfg, np.float32))],
                        dict(boundary=boundary, scale=np.float32(cfg.scale),
                             method="bf16"), (None, "seq", None))[0]
        assert y.shape == want.shape
        err = np.abs(y - want).max()
        assert err <= 2e-6 * max(1.0, np.abs(want).max()), (boundary, err)


# -- the tensor-core tile's band (csrc/sg1d_bf16.cuh) -------------------------

BAND_WINDOWS = [3, 25, 65, 101, 129]
# windows K3-bf16 takes on the tile and K1's odd ones >= 3 never reach: one
# tap (one chunk), and even windows
VALID_BAND_WINDOWS = [1, 2, 4, 24, 128]


@pytest.mark.parametrize("ws", BAND_WINDOWS + [1, 2, 24])
def test_1d_band_is_jax_valid_band_cut(jx, ws):
    """The bf16 1D tile's band is ``row_bands`` of a 1 x ws stencil: the
    first S rows and 16 columns of the JAX package's VALID band stack
    (``_valid_band_matrices``), S the tile's band depth."""
    from savgol_tpu.ops import pallas_conv as pc
    _, jnp = jx
    w = _data((ws,), 90 + ws)
    S = c2.band_depth(ws)
    want = np.asarray(pc._valid_band_matrices(jnp.asarray(w)))[:S, :16]
    got = c2.row_bands(torch.from_numpy(w)[None], S)[0]
    assert S % 16 == 0 and 15 + ws <= S < 31 + ws
    np.testing.assert_array_equal(got.numpy(), want)


def _band_product_1d(xv: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_k w[k] * xv[..., j + k]`` for every full window of ``xv`` as the
    tensor-core tile forms it: each block of 16 outputs at c is
    ``xv[..., c : c + S] @ B``, B the band of the taps, xv zero past its
    end; float32 sums."""
    ws = w.shape[0]
    S = c2.band_depth(ws)
    band = c2.row_bands(w[None], S)[0]
    n_out = xv.shape[-1] - ws + 1
    nb = -(-n_out // 16)
    xp = torch.nn.functional.pad(xv, (0, 16 * (nb - 1) + S - xv.shape[-1]))
    y = xp.unfold(-1, S, 16) @ band                    # (..., nb, 16)
    return y.reshape(*xv.shape[:-1], nb * 16)[..., :n_out]


@pytest.mark.parametrize("ws", BAND_WINDOWS)
def test_1d_band_product_matches_bf16_plain(ws):
    """The band products give the bf16 plain versions: the VALID
    correlation, and the same-length apply in each pad mode (the row
    extended as the tile stages it), within one bf16 ulp."""
    from savgol_tpu_torch.ops.cuda_conv import _bf16_operand, bf16_taps
    n = (ws - 1) // 2
    x = torch.from_numpy(_data((3, 3 * ws + 37), 91 + ws))
    w = torch.from_numpy(_data((ws,), 92 + ws))
    xb, wb = _bf16_operand(x), bf16_taps(w)
    got = _band_product_1d(xb, wb).to(torch.bfloat16).float()
    _within_ulp(got, cc.correlate_valid_bf16_plain(x, w))
    for mode in ("symmetric", "wrap", "edge", "reflect"):
        got = _band_product_1d(cc.pad_last(xb, n, mode), wb)
        _within_ulp(got.to(torch.bfloat16).float(),
                    cc.savgol_padded_bf16_plain(x, w, mode, n))


@pytest.mark.parametrize("ws", VALID_BAND_WINDOWS)
def test_1d_valid_band_product_matches_bf16_plain(ws):
    """K3-bf16's band products (the tile staged from t0, zeros past N) give
    the VALID bf16 plain version within one bf16 ulp at one tap, at even
    windows and at 128, on rows of ws to ws + 40 samples (partial and
    single 16-output blocks)."""
    from savgol_tpu_torch.ops.cuda_conv import _bf16_operand, bf16_taps
    w = torch.from_numpy(_data((ws,), 93 + ws))
    wb = bf16_taps(w)
    for N in (ws, ws + 1, ws + 15, ws + 16, 3 * ws + 40):
        x = torch.from_numpy(_data((3, N), 94 + ws + N))
        got = _band_product_1d(_bf16_operand(x), wb)
        _within_ulp(got.to(torch.bfloat16).float(),
                    cc.correlate_valid_bf16_plain(x, w))


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16,
                                     torch.float64])
@pytest.mark.parametrize("n", [1, 12, 32, 64])
@pytest.mark.parametrize("N_kind", ["ws", "ws+1", 4099])
def test_cuda_bf16_kernels_match_plain(cuda, storage, n, N_kind):
    """K1, K2 and K3 in their bf16 mode against their plain versions, one
    bf16 ulp, f32 / bf16 storage and f64 through bf16."""
    ws = 2 * n + 1
    N = {"ws": ws, "ws+1": ws + 1}.get(N_kind, N_kind)
    c, e = tsc._compat_weights_np(n, min(4, 2 * n), 1)
    cw = torch.from_numpy(c).to(cuda, torch.float32)
    ew = torch.from_numpy(e).to(cuda, torch.float32)
    x = torch.from_numpy(_data((5, N), n + N)).to(cuda, storage)
    dt = torch.tensor(4.0, device=cuda)
    for sign in (1.0, -1.0):
        got = cc.savgol_polynomial_bf16_cuda(x, cw, ew, n, dt, sign)
        assert got.dtype == storage
        _within_ulp(got.cpu(), cc.savgol_polynomial_bf16_plain(
            x, cw, ew, n, dt, sign).cpu())
    for mode in ("symmetric", "wrap", "edge", "reflect"):
        _within_ulp(cc.savgol_padded_bf16_cuda(x, cw, mode, n, dt).cpu(),
                    cc.savgol_padded_bf16_plain(x, cw, mode, n, dt).cpu())
    _within_ulp(cc.correlate_valid_bf16_cuda(x, cw).cpu(),
                cc.correlate_valid_bf16_plain(x, cw).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("call,key", [
    ("apply", "sg1d_poly"), ("reflect", "sg1d_pad"), ("valid", "corr1d_valid"),
    ("scipy_mirror", "corr1d_valid"), ("scipy_interp", "sg1d_poly")])
def test_cuda_bf16_entry_points_launch_one_kernel(cuda, call, key):
    f = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4), device=cuda)
    x = torch.from_numpy(_data((4, 5000), 60)).to(cuda, torch.bfloat16)
    runs = {"apply": lambda: f.apply(x, method="bf16"),
            "reflect": lambda: f.apply(x, boundary="reflect", method="bf16"),
            "valid": lambda: f.apply_valid(x, method="bf16"),
            "scipy_mirror": lambda: tsc.savgol_filter(x, 25, 4, mode="mirror",
                                                      method="bf16"),
            "scipy_interp": lambda: tsc.savgol_filter(x, 25, 4,
                                                      method="bf16")}
    torch.cuda.synchronize()
    cc.reset_launches()
    y = runs[call]()
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {k: int(k == key) for k in cc.LAUNCHES}
    assert y.dtype == torch.bfloat16


@pytest.mark.cuda
def test_cuda_bf16_wrappers_reject_what_the_kernels_do_not_take(cuda):
    c, e = savgol_weights_np(sgt.SavgolConfig(4, 2), np.float32)
    cw, ew = torch.from_numpy(c).to(cuda), torch.from_numpy(e).to(cuda)
    x = torch.randn(4, 100, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cc.savgol_polynomial_bf16_cuda(x.t(), cw, ew, 4)
    with pytest.raises(ValueError, match="weights on"):
        cc.correlate_valid_bf16_cuda(x, cw.cpu())
    with pytest.raises(ValueError, match="taps"):
        cc.correlate_valid_bf16_cuda(x, torch.ones(cc._MAX_WS + 1,
                                                   device=cuda))
    with pytest.raises(TypeError):
        cc.correlate_valid_bf16_cuda(x.int(), cw)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 12, 64])
def test_cuda_bf16_nonfinite_pattern_matches_plain(cuda, storage, n):
    """K1, K2 and K3 in their bf16 mode on rows holding NaN, +inf and -inf
    at the ends, at tile boundaries and inside (and a finite f32 sample
    past bf16's range): the same non-finite outputs as the plain versions,
    the finite ones within one bf16 ulp."""
    x = torch.from_numpy(_data((6, 4099), n)).to(cuda)
    for row, (j, v) in enumerate(((0, "nan"), (1023, "inf"), (1024, "-inf"),
                                  (4098, "nan"), (2000, 3.4e38))):
        x[row, j] = float(v)
    x[5, 2000], x[5, 2003] = float("inf"), float("-inf")
    x = x.to(storage)
    c, e = tsc._compat_weights_np(n, min(4, 2 * n), 1)
    cw = torch.from_numpy(c).to(cuda, torch.float32)
    ew = torch.from_numpy(e).to(cuda, torch.float32)
    dt = torch.tensor(4.0, device=cuda)
    pairs = [(cc.savgol_polynomial_bf16_cuda(x, cw, ew, n, dt, -1.0),
              cc.savgol_polynomial_bf16_plain(x, cw, ew, n, dt, -1.0)),
             (cc.correlate_valid_bf16_cuda(x, cw),
              cc.correlate_valid_bf16_plain(x, cw))]
    pairs += [(cc.savgol_padded_bf16_cuda(x, cw, mode, n, dt),
               cc.savgol_padded_bf16_plain(x, cw, mode, n, dt))
              for mode in ("symmetric", "wrap", "edge")]
    for got, want in pairs:
        for f in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(f(got), f(want)), f.__name__
        fin = torch.isfinite(want)
        assert not bool(fin.all())
        _within_ulp(got[fin].cpu(), want[fin].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 12, 32, 64])
@pytest.mark.parametrize("N_kind", ["ws", "ws+1", 8195])
@pytest.mark.parametrize("offset", [0, 3])
def test_cuda_bf16_tile_matches_plain_at_any_alignment(cuda, storage, n,
                                                       N_kind, offset):
    """The tensor-core tile (K1-bf16 with both edge signs, K2-bf16 in each
    pad mode) against the plain versions, one bf16 ulp, on rows that start
    ``offset`` samples past a 16-byte boundary (a view into a larger
    buffer), N = ws, ws + 1 and 8k + 3 (a ragged second tile)."""
    ws = 2 * n + 1
    N = {"ws": ws, "ws+1": ws + 1}.get(N_kind, N_kind)
    c, e = tsc._compat_weights_np(n, min(4, 2 * n), 2)
    cw = torch.from_numpy(c).to(cuda, torch.float32)
    ew = torch.from_numpy(e).to(cuda, torch.float32)
    base = torch.from_numpy(_data((3 * N + 8,), 7 * n + N)).to(cuda, storage)
    x = base[offset:offset + 3 * N].view(3, N)
    assert x.is_contiguous() and x.data_ptr() % 16 == offset * x.element_size()
    dt = torch.tensor(16.0, device=cuda)
    for sign in (1.0, -1.0):
        _within_ulp(cc.savgol_polynomial_bf16_cuda(x, cw, ew, n, dt,
                                                   sign).cpu(),
                    cc.savgol_polynomial_bf16_plain(x, cw, ew, n, dt,
                                                    sign).cpu())
    for mode in ("symmetric", "wrap", "edge"):
        _within_ulp(cc.savgol_padded_bf16_cuda(x, cw, mode, n, dt).cpu(),
                    cc.savgol_padded_bf16_plain(x, cw, mode, n, dt).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 12, 32, 64])
def test_cuda_bf16_tile_nonfinite_pattern_matches_plain(cuda, storage, n):
    """K1-bf16 and K2-bf16 with NaN, +inf and -inf on both sides of the
    tensor-core tiles' 8192-output boundary (bf16 storage shifts it by up
    to 7 samples), at the row's ends and +inf with -inf in one window: the
    plain versions' non-finite outputs, the finite ones within one bf16
    ulp."""
    x = torch.from_numpy(_data((6, 8195), 40 + n)).to(cuda)
    for row, (j, v) in enumerate(((8185, "nan"), (8191, "inf"),
                                  (8194, "-inf"), (0, "inf"),
                                  (4000, "nan"))):
        x[row, j] = float(v)
    x[5, 5000], x[5, 5002] = float("inf"), float("-inf")
    x = x.to(storage)
    c, e = tsc._compat_weights_np(n, min(4, 2 * n), 0)
    cw = torch.from_numpy(c).to(cuda, torch.float32)
    ew = torch.from_numpy(e).to(cuda, torch.float32)
    pairs = [(cc.savgol_polynomial_bf16_cuda(x, cw, ew, n),
              cc.savgol_polynomial_bf16_plain(x, cw, ew, n))]
    pairs += [(cc.savgol_padded_bf16_cuda(x, cw, mode, n),
               cc.savgol_padded_bf16_plain(x, cw, mode, n))
              for mode in ("symmetric", "wrap", "edge")]
    for got, want in pairs:
        for f in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(f(got), f(want)), f.__name__
        fin = torch.isfinite(want)
        assert not bool(fin.all())
        _within_ulp(got[fin].cpu(), want[fin].cpu())


# K3-bf16 on the tensor-core tile: every band depth KC = 1-9, even windows,
# lengths around the 8192-output tiles
K3_WINDOWS = [1, 2, 3, 24, 25, 65, 128, 129]


def _k3_lengths(ws):
    return (ws, ws + 1, ws + 7, 8195 + ws, 3 * 8192 + 5)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws", K3_WINDOWS)
def test_cuda_k3_bf16_tile_matches_plain(cuda, storage, ws):
    """K3-bf16 against ``correlate_valid_bf16_plain``, one bf16 ulp, one
    launch a call: N = ws, ws + 1, ws + 7, 8195 + ws and 3 x 8192 + 5, B =
    1, 3 and 130 (output rows of n_out samples, whose starts fall anywhere
    within a 16-byte unit), rows that start 0 or 3 samples past a 16-byte
    boundary (a view into a larger buffer)."""
    w = torch.from_numpy(_data((ws,), 300 + ws)).to(cuda)
    for N in _k3_lengths(ws):
        for B in (1, 3, 130):
            base = torch.from_numpy(_data((B * N + 8,), ws + N + B)).to(
                cuda, storage)
            for offset in (0, 3):
                x = base[offset:offset + B * N].view(B, N)
                cc.reset_launches()
                got = cc.correlate_valid_bf16_cuda(x, w)
                torch.cuda.synchronize()
                assert cc.LAUNCHES == {k: int(k == "corr1d_valid")
                                       for k in cc.LAUNCHES}
                assert got.dtype == storage
                assert got.shape == (B, N - ws + 1)
                _within_ulp(got.cpu(),
                            cc.correlate_valid_bf16_plain(x, w).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws", [1, 2, 24, 25, 129])
def test_cuda_k3_bf16_nonfinite_pattern_matches_plain(cuda, storage, ws):
    """K3-bf16 with NaN, +inf and -inf on both sides of the 8192-output
    tile boundary, just past a tile's last window (staged by the tile, read
    by none of its outputs), at the row's ends and +inf with -inf in one
    window, rows 3 samples past a 16-byte boundary: the plain version's
    non-finite outputs, the finite ones within one bf16 ulp."""
    N = 3 * 8192 + 5
    x = torch.from_numpy(_data((7, N), 60 + ws)).to(cuda)
    for row, (j, v) in enumerate(((8185, "nan"), (8191, "inf"),
                                  (8192 + ws, "-inf"), (0, "inf"),
                                  (N - 1, "nan"), (16384 + 3, 3.4e38))):
        x[row, j] = float(v)
    x[6, 5000], x[6, 5002] = float("inf"), float("-inf")
    base = torch.empty(7 * N + 8, device=cuda, dtype=storage)
    xs = base[3:3 + 7 * N].view(7, N)
    xs.copy_(x)
    w = torch.from_numpy(_data((ws,), 70 + ws)).to(cuda)
    got = cc.correlate_valid_bf16_cuda(xs, w)
    want = cc.correlate_valid_bf16_plain(xs, w)
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(got), f(want)), f.__name__
    fin = torch.isfinite(want)
    assert not bool(fin.all())
    _within_ulp(got[fin].cpu(), want[fin].cpu())
