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

The schedule of the exact 1D tile of K1-K3 (``csrc/sg1d_exact.cuh``) is
stated in Python (``tests/_exact_plan.py``) and checked here on the CPU: every
output stored once, every window inside the span its tile stages and its
thread reads, 16-byte copies, every tile walked once; staged and stored by
the plan in float64, it gives the plain versions.

Tolerance for f32: abs error <= 2e-6 * max(1, max|ref|). The two sides sum
the taps in different orders (the Pallas MXU kernel through HIGHEST-
precision matmul passes) and the kernels fold ``dt_inv`` into the weights
where the plain version multiplies after, so they differ by a few f32 ulps
of the largest partial sum, not bit for bit.
"""

import numpy as np
import pytest
import torch
from _exact_plan import EXACT_THREADS, exact_tile_plan

from savgol_tpu_torch.config import SavgolConfig
from savgol_tpu_torch.ops import cuda_conv as cc
from savgol_tpu_torch.ops.weights import savgol_weights_np
from savgol_tpu_torch.scipy_compat import _compat_weights_np

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


def _wide_weights(n, d, dtype):
    """Center and edge weights of order min(4, 2n), derivative d: the
    package's for n <= 32 (SavgolConfig's cap), scipy_compat's past it."""
    if n <= 32:
        return savgol_weights_np(SavgolConfig(n, min(4, 2 * n), d), dtype)
    return tuple(a.astype(dtype) for a in _compat_weights_np(n, 4, d))


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


# -- the exact tile's schedule (csrc/sg1d_exact.cuh) -------------------------

TILE_WINDOWS = [1, 2, 3, 25, 65, 101, 128, 129]
# (ws, kernel): K3 takes any window, K1 odd windows of 3 taps or more
PLAN_CASES = [(ws, k) for ws in TILE_WINDOWS for k in ("K1", "K3")
              if k == "K3" or (ws % 2 and ws >= 3)]


def _row_offsets(base: int, N: int, B: int, itemsize: int) -> list:
    """Elements past a 16-byte boundary of each row's first sample: rows N
    apart, the first ``base`` elements past one."""
    return [(base + b * N) % (16 // itemsize) for b in range(B)]


def _plan_lengths(ws: int, kind: str, itemsize: int) -> list:
    """Rows whose outputs end around the first and second tile boundaries
    (every residue mod 4), and the shortest row."""
    tile = exact_tile_plan(1, 1, 0, [0], itemsize)["tile"]
    extra = ws - 1 if kind == "K3" else 0
    return [ws] + [m + extra for t in (tile, 2 * tile)
                   for m in range(t - 2, t + 2)]


def _geometry(ws: int, kind: str, N: int) -> tuple:
    """(n_out, off) of K1 (same length, windows from j - n) or K3."""
    return (N, -(ws // 2)) if kind == "K1" else (N - ws + 1, 0)


def check_plan(p: dict, n_out: int, ws: int, off: int, offsets: list,
               itemsize: int) -> None:
    """The exact tile's invariants on a plan of ``exact_tile_plan``."""
    vec, q, span = 16 // itemsize, p["q"], p["span"]
    # 8 threads of a 16-byte shared load phase on 8 different bank groups
    assert p["tile"] == EXACT_THREADS * q and (q * itemsize) % 32 == 16
    # every thread reads inside the stage, which is whole 16-byte copies
    assert p["tile"] - q + p["reads"] <= span
    assert span % vec == 0 and p["reads"] >= q + ws - 1
    stored = {}
    for b, o0, in0, lo, hi in p["plan"]:
        assert in0 == o0 + off and (offsets[b] + in0) % vec == 0
        assert 0 <= -o0 % p["tile"] < vec      # shifted left by under V
        if lo < hi:
            for j in (lo, hi - 1, *range(lo, hi, 997)):
                t = (j - o0) // q              # the thread that owns j
                assert 0 <= t < EXACT_THREADS
                # its window, inside what that thread reads of the stage
                assert j + off >= in0 and j - o0 + ws <= t * q + p["reads"]
            stored.setdefault(b, []).append((lo, hi))
    for b in range(len(offsets)):
        ranges = sorted(stored[b])             # each output stored once
        assert ranges[0][0] == 0 and ranges[-1][1] == n_out
        assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))
    ids = sorted(i for walk in p["walks"] for i in walk)
    assert ids == list(range(len(p["plan"])))  # every tile walked once
    assert len(p["walks"]) == p["grid"] <= len(p["plan"])


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("ws,kind", PLAN_CASES)
def test_exact_tile_plan_stores_each_output_once(ws, kind, itemsize):
    """Over N around tile boundaries, row offsets 0-3 and B in {1, 3, 130},
    on one block a tile and on 7 blocks walking the tiles."""
    for N in _plan_lengths(ws, kind, itemsize):
        n_out, off = _geometry(ws, kind, N)
        for B in (1, 3, 130):
            for base in range(4):
                offsets = _row_offsets(base, N, B, itemsize)
                for blocks in (None, 7):
                    check_plan(exact_tile_plan(n_out, ws, off, offsets,
                                                  itemsize, blocks),
                               n_out, ws, off, offsets, itemsize)


def emulate_plan(x: np.ndarray, w: np.ndarray, kind: str, base: int,
                 itemsize: int, index=None) -> np.ndarray:
    """Stages and stores x's rows by the plan in float64: each tile stages
    xv[in0, in0 + span) (``index`` maps a row index past [0, N) into it,
    else zero), and output j is sum_k w[k] staged[j - o0 + k]. NaN where
    nothing was stored; an output stored twice fails."""
    B, N = x.shape
    ws = len(w)
    n_out, off = _geometry(ws, kind, N)
    p = exact_tile_plan(n_out, ws, off, _row_offsets(base, N, B, itemsize),
                           itemsize)
    out = np.full((B, n_out), np.nan)
    for b, o0, in0, lo, hi in p["plan"]:
        i = in0 + np.arange(p["span"])
        inside = (i >= 0) & (i < N)
        if index is None:
            staged = np.where(inside, x[b, np.clip(i, 0, N - 1)], 0.0)
        else:
            staged = x[b, index(i)]
        win = np.lib.stride_tricks.sliding_window_view(staged, ws)
        j = np.arange(lo, hi)
        assert np.isnan(out[b, lo:hi]).all()
        out[b, lo:hi] = win[j - o0] @ w
    return out


@pytest.mark.parametrize("ws", [3, 25, 101])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_exact_tile_plan_computes_k1_and_k3(ws, itemsize):
    """K3's VALID correlation and K1's band outputs (those not fitted from
    its edge rows) from the plan, against the plain versions."""
    tile = exact_tile_plan(1, 1, 0, [0], itemsize)["tile"]
    x = _data(3, tile + 37, seed=ws + itemsize, dtype=np.float64)
    w = np.random.default_rng(ws).standard_normal(ws)
    want = cc.correlate_valid_plain(torch.from_numpy(x),
                                    torch.from_numpy(w)).numpy()
    n = ws // 2
    for base in (0, 1, 3):
        np.testing.assert_allclose(emulate_plan(x, w, "K3", base, itemsize),
                                   want, rtol=0, atol=1e-12)
        band = emulate_plan(x, w, "K1", base, itemsize)[:, n:-n]
        np.testing.assert_allclose(band, want, rtol=0, atol=1e-12)


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


def _rows_at(flat: torch.Tensor, base: int, B: int, N: int) -> torch.Tensor:
    """A contiguous (B, N) view of ``flat`` from element ``base`` on: its
    first sample ``base`` elements past ``flat``'s (aligned) start."""
    return flat[base:base + B * N].view(B, N)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ws", TILE_WINDOWS)
def test_cuda_exact_tile_matches_plain(cuda, ws, dtype):
    """K3, and at odd windows K1 and K2 in each pad mode, on the exact tile
    over N around its tile boundaries, row offsets 0-3 and B in {1, 3,
    130}: one launch a call, within the kernel gate of the plain
    versions."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    tol = F32_TOL if dtype == torch.float32 else 1e-12
    itemsize = 4 if dtype == torch.float32 else 8
    rng = np.random.default_rng(ws)
    w = torch.from_numpy(rng.standard_normal(ws)).to(cuda, dtype)
    n = ws // 2
    # kind -> (launch count, kernel, plain version), each called on x
    kinds = {"K3": ("corr1d_valid", lambda x: cc.correlate_valid_cuda(x, w),
                    lambda x: cc.correlate_valid_plain(x, w))}
    if ws % 2 and ws >= 3:
        c, e = _wide_weights(n, 1, npdt)
        ct, et = torch.from_numpy(c).to(cuda), torch.from_numpy(e).to(cuda)
        dt_inv = 1.0 / DT
        kinds["K1"] = ("sg1d_poly", lambda x: cc.savgol_polynomial_cuda(
            x, ct, et, n, dt_inv, -1.0), lambda x: cc.savgol_polynomial_plain(
            x, ct, et, n, dt_inv, -1.0))
        for mode in ("edge", "wrap", "symmetric"):
            kinds[f"K2 {mode}"] = (
                "sg1d_pad",
                lambda x, mode=mode: cc.savgol_padded_cuda(x, ct, mode, n,
                                                           dt_inv),
                lambda x, mode=mode: cc.savgol_padded_plain(x, ct, mode, n,
                                                            dt_inv))
    for kind, (key, run, plain) in kinds.items():
        for N in _plan_lengths(ws, kind[:2], itemsize):
            for B in (1, 3, 130) if N < 7000 else (1, 3):
                flat = torch.from_numpy(rng.standard_normal(B * N + 3)).to(
                    cuda, dtype)
                for base in range(4):
                    x = _rows_at(flat, base, B, N)
                    before = cc.LAUNCHES[key]
                    got = run(x)
                    assert cc.LAUNCHES[key] == before + 1, kind
                    _assert_close(got.cpu().numpy(), plain(x).cpu().numpy(),
                                  tol)


def _same_nonfinite(got, want):
    """NaN, +inf and -inf in the same outputs; the finite ones returned."""
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(got), f(want)), f.__name__
    fin = torch.isfinite(want)
    assert not bool(fin.all())
    return got[fin], want[fin]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [3, 12, 32, 50])
def test_cuda_nonfinite_pattern_matches_plain(cuda, n, dtype):
    """K1, K2 (each pad mode) and K3 on rows holding NaN, +inf and -inf at
    the ends, at tile boundaries (the exact tile's 2560 and 3072 outputs,
    the old tile's 1024) and inside: the same non-finite outputs as the
    plain versions, the finite ones within the kernel gate; windows of 25
    (n = 12) and 101 (n = 50) run compile-time instances."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x = torch.from_numpy(_data(5, 4099, seed=n, dtype=npdt)).to(cuda)
    for row, (j, v) in enumerate(((0, "nan"), (1023, "inf"), (1024, "-inf"),
                                  (4098, "nan"))):
        x[row, j] = float(v)
    x[4, 2000], x[4, 2003] = float("inf"), float("-inf")
    x[4, 2560], x[4, 3071] = float("nan"), float("inf")
    cw, ew = (torch.from_numpy(a).to(cuda) for a in _wide_weights(n, 1, npdt))
    tol = F32_TOL if dtype == torch.float32 else 1e-12
    pairs = [(cc.savgol_polynomial_cuda(x, cw, ew, n, 2.0, -1.0),
              cc.savgol_polynomial_plain(x, cw, ew, n, 2.0, -1.0)),
             (cc.correlate_valid_cuda(x, cw), cc.correlate_valid_plain(x, cw))]
    pairs += [(cc.savgol_padded_cuda(x, cw, mode, n, 2.0),
               cc.savgol_padded_plain(x, cw, mode, n, 2.0))
              for mode in ("symmetric", "wrap", "edge")]
    for got, want in pairs:
        _assert_close(*(t.cpu() for t in _same_nonfinite(got, want)), tol)
