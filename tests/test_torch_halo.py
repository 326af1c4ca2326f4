"""The ring halo exchange of the port against the JAX package: the plain
version of kernel K13 (``ops.cuda_halo.halo_exchange_plain``, point-to-point
sends) and both ``parallel.ici_halo`` functions, values and backward, on
rings of 1, 2 and 4 ranks.

The port's side runs in one persistent pool of 4 spawned ranks on a
``gloo`` group (``savgol_tpu_torch.parallel.launch``); each rank gets its
block of the same global numpy input. The JAX side runs
``savgol_tpu.parallel.ici_halo`` inside ``shard_map`` on 4 of the 8 virtual
CPU devices, in Pallas interpret mode, as ``tests/test_sharded.py::
TestRdmaHalo`` does. A halo is a copy, so values and gradients must agree
bit for bit (``assert_array_equal``); the gradients, sums of at most two
cotangents, within 1e-12 where JAX adds them in another order.

The tests marked ``cuda`` hold K13 against its plain version on one card,
two ranks sharing it, and show that a broken ring fails instead of
hanging; they skip without one (on-card lane:
``python -m pytest --noconftest -m cuda tests/test_torch_halo.py``).
"""

import time


import numpy as np
import pytest
import torch

from savgol_tpu_torch.parallel.launch import Pool, run_broken_ring, run_halo

P4 = 4
# (mesh shape, ring size): the "seq" axis of a ("batch", "seq") mesh over
# the 4 ranks
RINGS = {1: (4, 1), 2: (2, 2), 4: (1, 4)}


@pytest.fixture(scope="module")
def pool():
    with Pool(P4, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def jax_halo():
    """fn(x, n, rows, cotangents) -> (left, right, grad) of the JAX
    package's rdma exchange on a ring of 4 virtual devices."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from savgol_tpu.parallel.ici_halo import (halo_exchange_rdma,
                                              halo_exchange_rdma_rows)
    from savgol_tpu.parallel.sharded import make_mesh

    mesh = make_mesh(("seq",), shape=(P4,), devices=jax.devices()[:P4])

    def run(x, n, rows, cotangents):
        fn = halo_exchange_rdma_rows if rows else halo_exchange_rdma
        spec = P(None, "seq", None) if rows else P(None, "seq")
        mapped = jax.shard_map(lambda v: fn(v, n, "seq"), mesh=mesh,
                               in_specs=(spec,), out_specs=(spec, spec),
                               check_vma=False)
        (left, right), vjp = jax.vjp(jax.jit(mapped), jnp.asarray(x))
        (grad,) = vjp(tuple(jnp.asarray(c) for c in cotangents))
        return np.asarray(left), np.asarray(right), np.asarray(grad)

    return run


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cuda_pool():
    """Two ranks sharing card 0, started only when a card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    with Pool(2, device="cuda") as p:
        yield p


def _expected(x, n, ring, rows):
    """Each rank's (left, right) halos from the global array, cut and
    concatenated along the sample (or row) axis as the ranks' blocks are."""
    ax = -2 if rows else -1
    blocks = np.split(x, ring, axis=ax)
    take = (lambda b, s: b[..., s, :]) if rows else (lambda b, s: b[..., s])
    left = [take(blocks[(r - 1) % ring], slice(-n, None))
            for r in range(ring)]
    right = [take(blocks[(r + 1) % ring], slice(0, n)) for r in range(ring)]
    return np.concatenate(left, axis=ax), np.concatenate(right, axis=ax)


def _spec(rows):
    return (None, "seq", None) if rows else (None, "seq")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("rows_per", [1, 3, 8])
@pytest.mark.parametrize("ring", [1, 2, 4])
def test_exchange_values(pool, ring, rows_per, n, dtype):
    """The last-axis exchange: each rank receives exactly its neighbours'
    slices, wrap-around included; a ring of one gets its own."""
    x = np.random.default_rng(ring * 100 + rows_per * 10 + n).standard_normal(
        (rows_per, 8 * ring)).astype(dtype)
    left, right, _, launches, plain = pool.run(
        run_halo, ("batch", "seq"), RINGS[ring], x, _spec(False), n,
        False)[0]
    want_l, want_r = _expected(x, n, ring, False)
    assert left.dtype == dtype
    np.testing.assert_array_equal(left, want_l)
    np.testing.assert_array_equal(right, want_r)
    assert launches == 0 and plain is None      # CPU: the plain version


@pytest.mark.parametrize("C", [1, 6])
@pytest.mark.parametrize("ny", [1, 3])
@pytest.mark.parametrize("ring", [1, 2, 4])
def test_row_exchange_values(pool, ring, ny, C):
    x = np.random.default_rng(ring + 7 * ny + C).standard_normal(
        (2, 4 * ring, C))
    left, right, _, _, _ = pool.run(run_halo, ("batch", "seq"), RINGS[ring],
                                    x, _spec(True), ny, True)[0]
    want_l, want_r = _expected(x, ny, ring, True)
    np.testing.assert_array_equal(left, want_l)
    np.testing.assert_array_equal(right, want_r)


@pytest.mark.parametrize("ring", [1, 2, 4])
@pytest.mark.parametrize("rows", [False, True])
def test_backward_returns_cotangents(pool, ring, rows):
    """The backward sends each halo's cotangent back to the samples it
    came from: the gradient of sum(left * cl + right * cr) is cl and cr
    scattered onto the neighbours' tails and heads (added where they
    overlap, as on a ring of one with a short block)."""
    rng = np.random.default_rng(40 + ring)
    n = 3
    shape = (2, 4 * ring, 5) if rows else (2, 4 * ring)
    x = rng.standard_normal(shape)
    halo_shape = (2, n * ring, 5) if rows else (2, n * ring)
    cl, cr = rng.standard_normal(halo_shape), rng.standard_normal(halo_shape)
    _, _, grad, _, _ = pool.run(run_halo, ("batch", "seq"), RINGS[ring], x,
                                _spec(rows), n, rows, (cl, cr))[0]
    ax = -2 if rows else -1
    want = np.zeros_like(x)
    blk = x.shape[ax] // ring
    for r in range(ring):
        cl_r = np.take(cl, range(r * n, (r + 1) * n), axis=ax)
        cr_r = np.take(cr, range(r * n, (r + 1) * n), axis=ax)
        src_l = ((r - 1) % ring) * blk + blk - n     # left neighbour's tail
        src_r = ((r + 1) % ring) * blk               # right neighbour's head
        idx_l = [slice(None)] * x.ndim
        idx_l[ax] = slice(src_l, src_l + n)
        idx_r = [slice(None)] * x.ndim
        idx_r[ax] = slice(src_r, src_r + n)
        want[tuple(idx_l)] += cl_r
        want[tuple(idx_r)] += cr_r
    np.testing.assert_allclose(grad, want, atol=1e-15, rtol=0)


@pytest.mark.parametrize("rows", [False, True])
def test_matches_jax_rdma_and_vjp(pool, jax_halo, rows):
    """Values and the custom VJP against the JAX package's Pallas rdma
    exchange (interpret mode) on a ring of 4."""
    rng = np.random.default_rng(50 + rows)
    n = 4 if rows else 5
    x = rng.standard_normal((2, 24, 6) if rows else (3, 32))
    hshape = (2, 4 * n, 6) if rows else (3, 4 * n)
    cots = (rng.standard_normal(hshape), rng.standard_normal(hshape))
    left, right, grad, _, _ = pool.run(run_halo, ("batch", "seq"), RINGS[4],
                                       x, _spec(rows), n, rows, cots)[0]
    jl, jr, jg = jax_halo(x, n, rows, cots)
    np.testing.assert_array_equal(left, jl)
    np.testing.assert_array_equal(right, jr)
    np.testing.assert_allclose(grad, jg, atol=1e-12, rtol=0)


def test_plain_rejects_mismatched_blocks():
    from savgol_tpu_torch.ops.cuda_halo import halo_exchange_plain
    with pytest.raises(ValueError, match="must match"):
        halo_exchange_plain(torch.zeros(2, 3), torch.zeros(2, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rows,n,rows_per", [(False, 1, 1), (False, 12, 3),
                                             (False, 32, 128),
                                             (True, 5, 2048)])
def test_cuda_k13_matches_plain(cuda, cuda_pool, rows, n, rows_per, dtype):
    """K13 on one card, two ranks: the halos equal the neighbours' slices
    and the plain version's, bit for bit; one launch a rank, and the
    backward is one more."""
    rng = np.random.default_rng(n)
    shape = (1, 2 * 8 * n, rows_per) if rows else (rows_per, 2 * 4 * n)
    x = rng.standard_normal(shape).astype(dtype)
    halo_shape = (1, 2 * n, rows_per) if rows else (rows_per, 2 * n)
    cots = (np.ones(halo_shape, dtype), np.ones(halo_shape, dtype))
    outs = cuda_pool.run(run_halo, ("seq",), (2,), x, _spec(rows), n, rows,
                         cots, "seq", "cuda")
    want_l, want_r = _expected(x, n, 2, rows)
    for left, right, grad, launches, plain in outs:
        np.testing.assert_array_equal(left, want_l)
        np.testing.assert_array_equal(right, want_r)
        assert launches == 2 and plain
        assert grad.shape == x.shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rows,n,rows_per", [(False, 12, 3),
                                             (True, 5, 2048)])
def test_cuda_k13_sm_route_matches_plain(cuda, cuda_pool, rows, n, rows_per,
                                         dtype):
    """K13's SM route (one launch, the wait on the SMs: the route of a rank
    with a card to itself), forced on the two ranks sharing the card: the
    same halos, bit for bit, and no halo_recv launch."""
    rng = np.random.default_rng(n + 1)
    shape = (1, 2 * 8 * n, rows_per) if rows else (rows_per, 2 * 4 * n)
    x = rng.standard_normal(shape).astype(dtype)
    outs = cuda_pool.run(run_halo, ("seq",), (2,), x, _spec(rows), n, rows,
                         None, "seq", "cuda", "sms")
    want_l, want_r = _expected(x, n, 2, rows)
    for left, right, _, launches, plain in outs:
        np.testing.assert_array_equal(left, want_l)
        np.testing.assert_array_equal(right, want_r)
        assert launches == 1 and plain


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "sms"])
def test_cuda_k13_broken_ring_fails_fast(cuda, route):
    """On a pool of two ranks sharing the card, rank 1 leaves out the second
    exchange: rank 0's next synchronise must raise within ``TIMEOUT_S``
    (lowered to 2 s) + 15 s, on the route the ranks take (the stream route:
    the watchdog releases the wait and halo_recv traps) and on the SM route
    (halo_send traps); the pool then closes, no rank hung."""
    timeout_s = 2.0
    pool = Pool(2, device="cuda")
    procs = list(pool._procs)
    try:
        start = time.monotonic()
        (what0, sec0, msg0), (what1, _, _) = pool.run(run_broken_ring, 1,
                                                      timeout_s, route)
        took = time.monotonic() - start
    finally:
        pool.close(kill=True)
    assert what1 == "skipped"
    assert what0 == "raised", (what0, msg0)
    assert timeout_s <= sec0 <= timeout_s + 15.0, sec0
    # the whole call: the first exchange shares the buffers, then the second
    assert took <= timeout_s + 30.0, took
    assert not any(p.is_alive() for p in procs)
