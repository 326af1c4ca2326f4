"""The port's plane solves (``savgol_tpu_torch.ops.lsq``, kernels K8a/K8b in
``ops/cuda_solve.py``) against the JAX package's jnp versions
(``savgol_tpu.ops.lsq``).

On the CPU the plain PyTorch versions are compared with the JAX functions
on the same planes (made with numpy from a seed): random SPD Grams,
under-quorum positions, near-singular Grams where the shifted factor is
taken, and the ``rcond`` rule on and off. The JAX package's interpret-mode
Pallas solve is not used: off the TPU its jnp versions are its
implementation. Tolerances: f64 <= 1e-12 * max(1, max|ref|); f32 <= 1e-5 *
max(1, max|ref|) on well-conditioned planes; ``ok`` identical. The tests
marked ``cuda`` hold the kernels against the plain versions on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_lsq.py -q
"""

import numpy as np
import pytest
import torch

from savgol_tpu_torch.ops import cuda_solve as cs
from savgol_tpu_torch.ops import lsq

F64_TOL = 1e-12
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def jlsq():
    """(savgol_tpu.ops.lsq, jax.numpy); skips where JAX is not installed."""
    mod = pytest.importorskip("savgol_tpu.ops.lsq")
    import jax.numpy as jnp
    return mod, jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _pair_index(k):
    pi = np.zeros((k, k), np.int32)
    c = 0
    for a in range(k):
        for b in range(a, k):
            pi[a, b] = pi[b, a] = c
            c += 1
    return pi


def _planes(k, pos, seed, cond_scale=1.0, quorum_frac=0.9, singular=0.0):
    """(gram (Kp, pos), rhs (k, pos), quorum (pos,), pair_index, rank_one
    (pos,)): Grams of random tall designs, a share ``singular`` of them
    (``rank_one``) replaced by rank-1 Grams that only the shifted factor
    can factor."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((pos, 3 * k + 2, k))
    A[..., -1] *= cond_scale
    G = np.einsum("pwi,pwj->pij", A, A) / (3 * k + 2)
    v = rng.standard_normal((pos, k))
    rank_one = rng.random(pos) < singular
    G[rank_one] = np.einsum("pi,pj->pij", v, v)[rank_one]
    gram = np.stack([G[:, a, b] for a in range(k) for b in range(a, k)])
    rhs = rng.standard_normal((k, pos))
    quorum = rng.random(pos) < quorum_frac
    return gram, rhs, quorum, _pair_index(k), rank_one


def _close(got, want, tol, where=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if where is not None:
        got, want = got[..., where], want[..., where]
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} * {scale:.3e}"


@pytest.mark.parametrize("k", [1, 3, 5, 10])
@pytest.mark.parametrize("rcond", [None, 1e-6])
@pytest.mark.parametrize("dtype,tol", [(np.float64, F64_TOL),
                                       (np.float32, F32_TOL)])
def test_solve_matches_jax(jlsq, k, rcond, dtype, tol):
    jl, jnp = jlsq
    gram, rhs, quorum, pi, _ = _planes(k, 400, seed=k)
    gram, rhs = gram.astype(dtype), rhs.astype(dtype)
    want, wok = jl.cholesky_solve_planes(jnp.asarray(gram), pi,
                                         jnp.asarray(rhs),
                                         jnp.asarray(quorum), rcond=rcond)
    got, ok = lsq.cholesky_solve_planes(torch.from_numpy(gram), pi,
                                        torch.from_numpy(rhs),
                                        torch.from_numpy(quorum),
                                        rcond=rcond)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    _close(got, want, tol)


@pytest.mark.parametrize("rcond", [None, 1e-12])
def test_shifted_factor_on_near_singular_grams(jlsq, rcond):
    # rank-1 Grams: the plain factor breaks down, the shifted one is taken
    # (finite garbage of LU's error class); rcond marks them not ok
    jl, jnp = jlsq
    k = 4
    gram, rhs, quorum, pi, rank_one = _planes(k, 300, seed=5,
                                                singular=0.3)
    want, wok = jl.cholesky_solve_planes(jnp.asarray(gram), pi,
                                         jnp.asarray(rhs),
                                         jnp.asarray(quorum), rcond=rcond)
    got, ok = lsq.cholesky_solve_planes(torch.from_numpy(gram), pi,
                                        torch.from_numpy(rhs),
                                        torch.from_numpy(quorum),
                                        rcond=rcond)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    if rcond is not None:
        assert not np.asarray(wok).all()
    # values agree where the system is well posed: quorate and full rank
    _close(got, want, F64_TOL, where=quorum & ~rank_one)


def test_under_quorum_is_identity(jlsq):
    k = 3
    gram, rhs, _, pi, _ = _planes(k, 50, seed=7)
    quorum = np.zeros(50, bool)
    got, ok = lsq.cholesky_solve_planes(torch.from_numpy(gram), pi,
                                        torch.from_numpy(rhs),
                                        torch.from_numpy(quorum))
    assert not ok.any()
    np.testing.assert_allclose(got.numpy(), rhs, rtol=0, atol=1e-15)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("rcond", [None, 1e-6])
@pytest.mark.parametrize("dtype,tol", [(np.float64, F64_TOL),
                                       (np.float32, F32_TOL)])
def test_solve_dd_matches_jax(jlsq, k, rcond, dtype, tol):
    jl, jnp = jlsq
    gram, rhs, quorum, pi, _ = _planes(k, 300, seed=20 + k, cond_scale=1e-2)
    ghi = gram.astype(dtype)
    glo = (gram - ghi).astype(dtype)
    rhi = rhs.astype(dtype)
    rlo = (rhs - rhi).astype(dtype)
    want, wok = jl.cholesky_solve_planes_dd(
        *map(jnp.asarray, (ghi, glo)), pi, *map(jnp.asarray, (rhi, rlo)),
        jnp.asarray(quorum), rcond=rcond)
    got, ok = lsq.cholesky_solve_planes_dd(
        *map(torch.from_numpy, (ghi, glo)), pi,
        *map(torch.from_numpy, (rhi, rlo)), torch.from_numpy(quorum),
        rcond=rcond)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,m", [(3, 2), (12, 4)])
def test_correlate_valid_dd_matches_jax(jlsq, dtype, n, m):
    jl, jnp = jlsq
    from savgol_tpu_torch.ops.masked import _masked_tables
    _, _, pair_w, _ = _masked_tables(n, m)
    x = np.random.default_rng(n).standard_normal((2, 90)).astype(dtype)
    whi, wlo = jl.correlate_valid_dd(jnp.asarray(x), pair_w)
    hi, lo = lsq.correlate_valid_dd(torch.from_numpy(x), pair_w)
    assert hi.shape == (pair_w.shape[0], 2, 90 - 2 * n)
    # the same error-free transforms in the same order
    np.testing.assert_array_equal(hi.numpy(), np.asarray(whi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo))


def test_gradients_match_jax(jlsq):
    import jax
    jl, jnp = jlsq
    k = 3
    gram, rhs, quorum, pi, _ = _planes(k, 40, seed=31)
    cot = np.random.default_rng(32).standard_normal((k, 40))

    def jfun(g, r):
        return jnp.sum(jl.cholesky_solve_planes(g, pi, r, jnp.asarray(
            quorum))[0] * cot)
    wg, wr = jax.grad(jfun, argnums=(0, 1))(jnp.asarray(gram),
                                            jnp.asarray(rhs))
    g = torch.from_numpy(gram).requires_grad_()
    r = torch.from_numpy(rhs).requires_grad_()
    coef, _ = cs.plane_cholesky_solve(g, pi, r, torch.from_numpy(quorum))
    (coef * torch.from_numpy(cot)).sum().backward()
    _close(g.grad, wg, 1e-10)
    _close(r.grad, wr, 1e-10)


def test_cpu_wrappers_take_the_plain_versions():
    k = 4
    gram, rhs, quorum, pi, _ = _planes(k, 60, seed=41)
    args = (torch.from_numpy(gram), pi, torch.from_numpy(rhs),
            torch.from_numpy(quorum))
    cs.reset_launches()
    got, ok = cs.plane_solve_cuda(*args, rcond=1e-9)
    want, wok = lsq.cholesky_solve_planes(*args, rcond=1e-9)
    assert torch.equal(got, want) and torch.equal(ok, wok)
    z = torch.zeros_like(args[0])
    got, ok = cs.plane_solve_dd_cuda(args[0], z, pi, args[2],
                                     torch.zeros_like(args[2]), args[3])
    want, wok = lsq.cholesky_solve_planes_dd(args[0], z, pi, args[2],
                                             torch.zeros_like(args[2]),
                                             args[3])
    assert torch.equal(got, want) and torch.equal(ok, wok)
    got, ok = cs.plane_solve_dd_cuda(args[0], z, pi, args[2],
                                     torch.zeros_like(args[2]), args[3],
                                     runtime_form=True)
    assert torch.equal(got, want) and torch.equal(ok, wok)
    assert cs.LAUNCHES == {"plane_solve": 0, "plane_solve_dd": 0}


def test_pair_table_is_uploaded_once_per_table():
    """The kernels' pair table is copied to the device once for each
    table's bytes, k and device: an equal table (another array) gets the
    cached tensor, an edited one its own."""
    _, _, _, pi, _ = _planes(4, 8, seed=3)
    kp = 4 * 5 // 2
    first = cs._pair_table(pi, 4, kp, "cpu")
    assert cs._pair_table(pi.copy(), 4, kp, torch.device("cpu")) is first
    edited = pi.copy()
    edited[0, 0] = edited[1, 1]
    other = cs._pair_table(edited, 4, kp, "cpu")
    assert other is not first
    assert np.array_equal(other.numpy(), edited)
    assert np.array_equal(first.numpy(), pi)
    with pytest.raises(ValueError):
        cs._pair_table(pi, 4, kp - 1, "cpu")


# -- the kernels on the card ---------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 10, 15, 28, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_match_plain(cuda, k, dtype):
    gram, rhs, quorum, pi, _ = _planes(k, 5000, seed=k)
    g = torch.from_numpy(gram).to(cuda, dtype)
    r = torch.from_numpy(rhs).to(cuda, dtype)
    q = torch.from_numpy(quorum).to(cuda)
    tol = F32_TOL if dtype == torch.float32 else F64_TOL
    for rcond in (None, 1e-6):
        got, ok = cs.plane_solve_cuda(g, pi, r, q, rcond)
        want, wok = lsq.cholesky_solve_planes(g, pi, r, q, rcond)
        torch.cuda.synchronize()
        assert torch.equal(ok, wok)
        _close(got.cpu(), want.cpu(), tol)
        z, zr = torch.zeros_like(g), torch.zeros_like(r)
        got, ok = cs.plane_solve_dd_cuda(g, z, pi, r, zr, q, rcond)
        want, wok = lsq.cholesky_solve_planes_dd(g, z, pi, r, zr, q, rcond)
        torch.cuda.synchronize()
        assert torch.equal(ok, wok)
        _close(got.cpu(), want.cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_dd_compile_time_solve_is_the_runtime_form(cuda, k, dtype):
    """K8b's compile-time instance (dd_chol_solve<K>) gives its runtime
    form's coefficients bit for bit and the same ok, under-quorum
    positions included, on the same stored (hi, lo) planes."""
    gram, rhs, quorum, pi, _ = _planes(k, 5000, seed=100 + k, singular=0.05)
    g = torch.from_numpy(gram).to(cuda, dtype)
    glo = (g.double() * 2.0 ** (-30 if dtype == torch.float32 else -60)
           / 3).to(dtype)
    r = torch.from_numpy(rhs).to(cuda, dtype)
    q = torch.from_numpy(quorum).to(cuda)
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    for rcond in (None, 1e-6):
        got, ok = cs.plane_solve_dd_cuda(g, glo, pi, r, torch.zeros_like(r),
                                         q, rcond)
        want, wok = cs.plane_solve_dd_cuda(g, glo, pi, r, torch.zeros_like(r),
                                           q, rcond, runtime_form=True)
        torch.cuda.synchronize()
        assert torch.equal(ok, wok)
        assert torch.equal(got.view(bits), want.view(bits))
