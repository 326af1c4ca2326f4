"""The port's 1D kernels (``savgol_tpu_torch.ops.cuda_conv``) against the
JAX package's Pallas kernels.

On the CPU the plain PyTorch versions are compared with the Pallas kernels
run in interpret mode, as the JAX package's own tests run them. The tests
marked ``cuda`` compare the CUDA kernels with the plain versions on the
card and skip without one; they are the on-card lane of this file:

    python -m pytest --noconftest -m cuda tests/test_torch_conv.py -q

(``--noconftest`` because the GPU machine has no JAX, which
``tests/conftest.py`` imports; this file imports JAX only inside the
fixture of the tests that need it.)

Tolerance for f32: abs error <= 2e-6 * max(1, max|ref|). The two sides sum
the taps in different orders (the Pallas MXU kernel through HIGHEST-
precision matmul passes) and the kernels fold ``dt_inv`` into the weights
where the plain version multiplies after, so they differ by a few f32 ulps
of the largest partial sum, not bit for bit.
"""

import numpy as np
import pytest
import torch

from savgol_tpu_torch.config import SavgolConfig
from savgol_tpu_torch.ops import cuda_conv as cc
from savgol_tpu_torch.ops.weights import savgol_weights_np

F32_TOL = 2e-6
DT = 0.01


@pytest.fixture(scope="module")
def jax_kernels():
    """(pallas_conv, jax.numpy); skips where JAX is not installed."""
    pallas_conv = pytest.importorskip("savgol_tpu.ops.pallas_conv")
    import jax.numpy as jnp
    return pallas_conv, jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _weights(n, d, dtype=np.float32):
    cfg = SavgolConfig(n, min(4, 2 * n), d, time_step=DT)
    c, e = savgol_weights_np(cfg, dtype)
    return c, e, 1.0 / cfg.dt_scale


def _length(n, kind):
    ws = 2 * n + 1
    return {"ws": ws, "ws+1": ws + 1}.get(kind, kind)


def _data(B, N, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, N)).astype(dtype)


def _assert_close(got, want, tol=F32_TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} * {scale:.3e}"


@pytest.mark.parametrize("N_kind", ["ws", "ws+1", 1000, 4099])
@pytest.mark.parametrize("B", [1, 3, 24])
@pytest.mark.parametrize("n", [1, 12, 32])
def test_poly_plain_matches_pallas(jax_kernels, n, B, N_kind):
    pc, jnp = jax_kernels
    N = _length(n, N_kind)
    x = _data(B, N, seed=1000 * n + B + N)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    # both edge signs where the sign means something: the odd derivative
    for d, sign in ((0, 1.0), (1, 1.0), (1, -1.0), (2, 1.0)):
        c, e, dt_inv = _weights(n, d)
        got = cc.savgol_polynomial_plain(
            xt, torch.from_numpy(c), torch.from_numpy(e), n, dt_inv, sign)
        assert got.dtype == torch.float32
        for fn in (pc.savgol_polynomial_pallas,
                   pc.savgol_polynomial_pallas_mxu):
            want = fn(xj, jnp.asarray(c), jnp.asarray(e), n, dt_inv,
                      lead_sign=sign, interpret=True)
            _assert_close(got.numpy(), want)


@pytest.mark.parametrize("N_kind", ["ws", 1000, 4099])
@pytest.mark.parametrize("B", [1, 24])
@pytest.mark.parametrize("n", [1, 12, 32])
def test_valid_plain_matches_pallas(jax_kernels, n, B, N_kind):
    pc, jnp = jax_kernels
    N = _length(n, N_kind)
    x = _data(B, N, seed=7 + 1000 * n + B + N)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    # first-derivative taps are antisymmetric, so a reversed stencil shows
    w = _weights(n, 1)[0]
    got = cc.correlate_valid_plain(xt, torch.from_numpy(w))
    assert got.shape == (B, N - 2 * n)
    for fn in (pc.correlate_valid_pallas, pc.correlate_valid_pallas_mxu):
        _assert_close(got.numpy(), fn(xj, jnp.asarray(w), interpret=True))


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    n = 5
    c, e, dt_inv = _weights(n, 1)
    x = torch.from_numpy(_data(2, 300, seed=3))
    ct, et = torch.from_numpy(c), torch.from_numpy(e)
    cc.reset_launches()
    assert torch.equal(
        cc.savgol_polynomial_cuda(x, ct, et, n, dt_inv, -1.0),
        cc.savgol_polynomial_plain(x, ct, et, n, dt_inv, -1.0))
    assert torch.equal(cc.correlate_valid_cuda(x, ct),
                       cc.correlate_valid_plain(x, ct))
    assert cc.LAUNCHES == {"sg1d_poly": 0, "sg1d_pad": 0, "corr1d_valid": 0}


# -- on the card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N_kind", ["ws", "ws+1", 4099])
@pytest.mark.parametrize("B", [1, 24])
@pytest.mark.parametrize("n", [1, 12, 32])
def test_cuda_kernels_match_plain(cuda, n, B, N_kind, dtype):
    N = _length(n, N_kind)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    tol = F32_TOL if dtype == torch.float32 else 1e-12
    x = torch.from_numpy(_data(B, N, seed=11 + n + B + N, dtype=npdt)).to(cuda)
    for d in (0, 1, 2):
        c, e, dt_inv = _weights(n, d, npdt)
        ct, et = torch.from_numpy(c).to(cuda), torch.from_numpy(e).to(cuda)
        for sign in (1.0, -1.0):
            before = cc.LAUNCHES["sg1d_poly"]
            got = cc.savgol_polynomial_cuda(x, ct, et, n, dt_inv, sign)
            assert cc.LAUNCHES["sg1d_poly"] == before + 1
            want = cc.savgol_polynomial_plain(x, ct, et, n, dt_inv, sign)
            _assert_close(got.cpu().numpy(), want.cpu().numpy(), tol)
        before = cc.LAUNCHES["corr1d_valid"]
        got = cc.correlate_valid_cuda(x, ct)
        assert cc.LAUNCHES["corr1d_valid"] == before + 1
        _assert_close(got.cpu().numpy(),
                      cc.correlate_valid_plain(x, ct).cpu().numpy(), tol)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    n = 4
    c, e, _ = _weights(n, 0)
    ct, et = torch.from_numpy(c).to(cuda), torch.from_numpy(e).to(cuda)
    x = torch.randn(4, 100, device=cuda)
    with pytest.raises(TypeError):
        cc.savgol_polynomial_cuda(x.half(), ct, et, n)
    with pytest.raises(ValueError, match="contiguous"):
        cc.savgol_polynomial_cuda(x.t(), ct, et, n)
    with pytest.raises(ValueError, match="weights on"):
        cc.savgol_polynomial_cuda(x, ct.cpu(), et, n)
    with pytest.raises(ValueError, match="window size"):
        cc.savgol_polynomial_cuda(x[:, :8].contiguous(), ct, et, n)
    with pytest.raises(ValueError, match="taps"):
        cc.correlate_valid_cuda(x, torch.ones(cc._MAX_WS + 1, device=cuda))


def _same_nonfinite(got, want):
    """NaN, +inf and -inf in the same outputs; the finite ones returned."""
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(got), f(want)), f.__name__
    fin = torch.isfinite(want)
    assert not bool(fin.all())
    return got[fin], want[fin]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [3, 12, 32])
def test_cuda_nonfinite_pattern_matches_plain(cuda, n, dtype):
    """K1, K2 (each pad mode) and K3 on rows holding NaN, +inf and -inf at
    the ends, at tile boundaries and inside: the same non-finite outputs as
    the plain versions, the finite ones within the kernel gate."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x = torch.from_numpy(_data(5, 4099, seed=n, dtype=npdt)).to(cuda)
    for row, (j, v) in enumerate(((0, "nan"), (1023, "inf"), (1024, "-inf"),
                                  (4098, "nan"))):
        x[row, j] = float(v)
    x[4, 2000], x[4, 2003] = float("inf"), float("-inf")
    cw, ew = (torch.from_numpy(a).to(cuda) for a in savgol_weights_np(
        SavgolConfig(n, min(4, 2 * n), 1), npdt))
    tol = F32_TOL if dtype == torch.float32 else 1e-12
    pairs = [(cc.savgol_polynomial_cuda(x, cw, ew, n, 2.0, -1.0),
              cc.savgol_polynomial_plain(x, cw, ew, n, 2.0, -1.0)),
             (cc.correlate_valid_cuda(x, cw), cc.correlate_valid_plain(x, cw))]
    pairs += [(cc.savgol_padded_cuda(x, cw, mode, n, 2.0),
               cc.savgol_padded_plain(x, cw, mode, n, 2.0))
              for mode in ("symmetric", "wrap", "edge")]
    for got, want in pairs:
        _assert_close(*(t.cpu() for t in _same_nonfinite(got, want)), tol)
