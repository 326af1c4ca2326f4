"""The sharded uniform paths of the port against the JAX package:
``parallel.apply_sharded`` (1D overlap-save, four boundaries, batch +
sequence meshes, both halo routes, gradients) and
``parallel.apply2d_sharded`` (row shards and rows x columns tiles), with the
errors they raise.

The port's side runs in one persistent pool of 8 spawned ranks on a
``gloo`` group (``savgol_tpu_torch.parallel.launch``), the only 8-rank pool
of the suite; each rank gets its block of the same global numpy input and
the outputs are gathered back. The JAX side runs
``savgol_tpu.parallel.sharded`` / ``sharded2d`` on meshes of the same shape
over the 8 virtual CPU devices, jitted, and the Pallas rdma route in
interpret mode, as ``tests/test_sharded.py`` does. On the CPU both halo
routes of the port are the same point-to-point sends.

Tolerance: 1e-12 in f64, as ``tests/test_sharded.py:47`` holds the JAX
package's sharded calls to its single-device ones.
"""

import functools

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch.ops.weights import (savgol2d_weights_np,
                                          savgol_weights_np)
from savgol_tpu_torch.parallel.launch import (Full, Pool, Sharded, run_error,
                                              run_sharded)

SEQ8 = (("batch", "seq"), (1, 8))
B2S4 = (("batch", "seq"), (2, 4))
TILES = (("seq", "cols"), (2, 4))
BOUNDARIES = ["polynomial", "reflect", "periodic", "constant"]
BOUNDARIES_2D = ["constant", "reflect", "periodic", "valid"]


@pytest.fixture(scope="module")
def pool():
    with Pool(8, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def jx():
    """(savgol_tpu, jax, jnp, meshes by name) on the 8 virtual devices."""
    sg = pytest.importorskip("savgol_tpu")
    import jax
    import jax.numpy as jnp
    from savgol_tpu.parallel.sharded import make_mesh
    meshes = {"seq8": make_mesh(("batch", "seq"), shape=(1, 8)),
              "b2s4": make_mesh(("batch", "seq"), shape=(2, 4)),
              "tiles": make_mesh(("seq", "cols"), shape=(2, 4)),
              "ring8": make_mesh(("seq",), shape=(8,))}
    return sg, jax, jnp, meshes


def _run(pool, entry, mesh, args, kwargs, out_spec):
    return pool.run(run_sharded, entry, *mesh, args, kwargs, out_spec)[0]


def _jax_1d(jx, mesh, x, n, m, d, boundary, halo="ppermute", grad=False):
    """The JAX package's apply_sharded (jitted; and its gradient of
    sum(y ** 2))."""
    sg, jax, jnp, meshes = jx
    from savgol_tpu.parallel.sharded import apply_sharded
    f = sg.Savgol1D.create(sg.SavgolConfig(n, m, d), dtype=jnp.float64)
    fn = jax.jit(functools.partial(
        apply_sharded, center_w=f.center_weights, edge_w=f.edge_weights,
        half_window=n, mesh=meshes[mesh], boundary=sg.BoundaryMode(boundary),
        dt_inv=f.dt_inv, derivative=d, halo=halo))
    y = np.asarray(fn(jnp.asarray(x)))
    if not grad:
        return y
    g = jax.grad(lambda v: jnp.sum(fn(v) ** 2))(jnp.asarray(x))
    return y, np.asarray(g)


def _port_1d(pool, mesh, x, spec, n, m, d, boundary, halo="ppermute",
             grad=False, **kw):
    cfg = sgt.SavgolConfig(n, m, d)
    cw, ew = savgol_weights_np(cfg, np.float64)
    return _run(pool, "apply_sharded", mesh,
                [Sharded(x, spec, grad=grad), Full(cw), Full(ew)],
                dict(half_window=n, boundary=boundary, dt_inv=1.0 / cfg.time_step ** d,
                     derivative=d, halo=halo, **kw), spec)


class TestApplySharded:
    @pytest.mark.parametrize("boundary", BOUNDARIES)
    @pytest.mark.parametrize("n,m,d", [(5, 3, 0), (6, 3, 1)])
    def test_matches_jax_ring_of_8(self, pool, jx, boundary, n, m, d):
        x = np.random.default_rng(0).standard_normal((3, 512))
        y, _ = _port_1d(pool, SEQ8, x, (None, "seq"), n, m, d, boundary,
                        halo="rdma")
        want = _jax_1d(jx, "seq8", x, n, m, d, boundary)
        np.testing.assert_allclose(y, want, atol=1e-12, rtol=0)

    @pytest.mark.parametrize("boundary", ["polynomial", "periodic"])
    def test_batch_and_sequence_2x4(self, pool, jx, boundary):
        x = np.random.default_rng(2).standard_normal((4, 256))
        y, _ = _port_1d(pool, B2S4, x, ("batch", "seq"), 7, 3, 0, boundary)
        want = _jax_1d(jx, "b2s4", x, 7, 3, 0, boundary)
        np.testing.assert_allclose(y, want, atol=1e-12, rtol=0)

    def test_1d_input(self, pool):
        x = np.random.default_rng(1).standard_normal(256)
        y, _ = _port_1d(pool, SEQ8, x, ("seq",), 4, 2, 0, "polynomial")
        f = sgt.Savgol1D.create(sgt.SavgolConfig(4, 2), dtype=torch.float64,
                                device="cpu")
        np.testing.assert_allclose(y, f.apply(torch.from_numpy(x)).numpy(),
                                   atol=1e-12, rtol=0)

    def test_rdma_equals_ppermute_bitwise(self, pool):
        x = np.random.default_rng(71).standard_normal((4, 512))
        a, _ = _port_1d(pool, SEQ8, x, (None, "seq"), 5, 3, 0, "periodic",
                        halo="rdma")
        b, _ = _port_1d(pool, SEQ8, x, (None, "seq"), 5, 3, 0, "periodic",
                        halo="ppermute")
        np.testing.assert_array_equal(a, b)

    def test_rdma_matches_jax_interpret(self, pool, jx):
        """The JAX package's Pallas rdma ring (interpret mode) on a ring of
        8, derivative 1, the odd edge sign."""
        x = np.random.default_rng(70).standard_normal((3, 512))
        y, _ = _port_1d(pool, SEQ8, x, (None, "seq"), 6, 3, 1, "polynomial",
                        halo="rdma")
        _, jax, jnp, meshes = jx
        from savgol_tpu.parallel.sharded import apply_sharded
        sg = jx[0]
        f = sg.Savgol1D.create(sg.SavgolConfig(6, 3, 1), dtype=jnp.float64)
        want = np.asarray(apply_sharded(
            jnp.asarray(x), f.center_weights, f.edge_weights, half_window=6,
            mesh=meshes["ring8"], dt_inv=f.dt_inv, derivative=1,
            halo="rdma"))
        np.testing.assert_allclose(y, want, atol=1e-12, rtol=0)

    @pytest.mark.parametrize("halo", ["ppermute", "rdma"])
    @pytest.mark.parametrize("boundary", ["polynomial", "periodic"])
    def test_gradient_matches_jax(self, pool, jx, boundary, halo):
        x = np.random.default_rng(8).standard_normal((2, 256))
        _, (g,) = _port_1d(pool, SEQ8, x, (None, "seq"), 4, 2, 1, boundary,
                           halo=halo, grad=True)
        _, want = _jax_1d(jx, "seq8", x, 4, 2, 1, boundary, grad=True)
        np.testing.assert_allclose(g, want, atol=1e-12, rtol=0)

    def test_reference_edge_sign_and_xla(self, pool):
        """reference_edge_sign keeps the C's leading-edge sign, and
        method='xla' gives the same numbers as 'auto' on the CPU."""
        x = np.random.default_rng(9).standard_normal((2, 256))
        f = sgt.Savgol1D.create(sgt.SavgolConfig(5, 3, 1),
                                dtype=torch.float64, device="cpu")
        for sign in (False, True):
            for method in ("auto", "xla"):
                y, _ = _port_1d(pool, SEQ8, x, (None, "seq"), 5, 3, 1,
                                "polynomial", reference_edge_sign=sign,
                                method=method)
                want = f.apply(torch.from_numpy(x),
                               reference_edge_sign=sign).numpy()
                np.testing.assert_allclose(y, want, atol=1e-12, rtol=0)

    def test_boundary_string_coerced(self, pool):
        x = np.random.default_rng(74).standard_normal((2, 512))
        a, _ = _port_1d(pool, SEQ8, x, (None, "seq"), 5, 3, 1, "polynomial")
        b, _ = _port_1d(pool, SEQ8, x, (None, "seq"), 5, 3, 1,
                        sgt.BoundaryMode.POLYNOMIAL)
        np.testing.assert_array_equal(a, b)


def _port_2d(pool, mesh, img, spec, cfg, grad=False, **kw):
    w = savgol2d_weights_np(cfg, np.float64)
    return _run(pool, "apply2d_sharded", mesh,
                [Sharded(img, spec, grad=grad), Full(w)],
                dict(scale=cfg.scale, **kw), spec)


def _jax_2d(jx, mesh, img, cfg, grad=False, **kw):
    sg, jax, jnp, meshes = jx
    from savgol_tpu.parallel.sharded2d import apply2d_sharded
    f2 = sg.Savgol2D.create(sg.Savgol2DConfig(
        cfg.half_window_x, cfg.half_window_y, cfg.poly_order,
        deriv_x=cfg.deriv_x, deriv_y=cfg.deriv_y), dtype=jnp.float64)
    fn = jax.jit(functools.partial(apply2d_sharded, weights=f2.weights,
                                   mesh=meshes[mesh], scale=f2.scale, **kw))
    y = np.asarray(fn(jnp.asarray(img)))
    if not grad:
        return y
    return y, np.asarray(jax.grad(lambda v: jnp.sum(fn(v) ** 2))(
        jnp.asarray(img)))


class TestApply2DSharded:
    @pytest.mark.parametrize("boundary", BOUNDARIES_2D)
    def test_rows_match_jax(self, pool, jx, boundary):
        img = np.random.default_rng(5).standard_normal((64, 40))
        cfg = sgt.Savgol2DConfig(3, 2, 2, deriv_y=1)
        y, _ = _port_2d(pool, SEQ8, img, ("seq", None), cfg,
                        boundary=boundary, halo="rdma")
        want = _jax_2d(jx, "seq8", img, cfg,
                       boundary=jx[0].Boundary2D(boundary))
        assert y.shape == want.shape
        np.testing.assert_allclose(y, want, atol=1e-12, rtol=0)

    @pytest.mark.parametrize("boundary", BOUNDARIES_2D)
    def test_tiled_match_jax(self, pool, jx, boundary):
        img = np.random.default_rng(11).standard_normal((64, 48))
        cfg = sgt.Savgol2DConfig(3, 2, 2)
        y, _ = _port_2d(pool, TILES, img, ("seq", "cols"), cfg,
                        boundary=boundary, col_axis="cols")
        want = _jax_2d(jx, "tiles", img, cfg,
                       boundary=jx[0].Boundary2D(boundary), col_axis="cols")
        assert y.shape == want.shape
        np.testing.assert_allclose(y, want, atol=1e-12, rtol=0)

    def test_batched_2x4_and_rdma_rows_bitwise(self, pool, jx):
        imgs = np.random.default_rng(6).standard_normal((4, 32, 24))
        cfg = sgt.Savgol2DConfig(2, 2, 2)
        a, _ = _port_2d(pool, B2S4, imgs, ("batch", "seq", None), cfg,
                        halo="rdma")
        b, _ = _port_2d(pool, B2S4, imgs, ("batch", "seq", None), cfg)
        np.testing.assert_array_equal(a, b)
        want = _jax_2d(jx, "b2s4", imgs, cfg)
        np.testing.assert_allclose(a, want, atol=1e-12, rtol=0)

    @pytest.mark.parametrize("tiled", [False, True])
    def test_gradient_matches_jax(self, pool, jx, tiled):
        img = np.random.default_rng(13).standard_normal((64, 32))
        cfg = sgt.Savgol2DConfig(2, 2, 2)
        mesh, spec, kw = ((TILES, ("seq", "cols"), dict(col_axis="cols"))
                          if tiled else (SEQ8, ("seq", None), {}))
        bnd = "periodic"
        _, (g,) = _port_2d(pool, mesh, img, spec, cfg, grad=True,
                           boundary=bnd, **kw)
        _, want = _jax_2d(jx, "tiles" if tiled else "seq8", img, cfg,
                          grad=True, boundary=jx[0].Boundary2D(bnd), **kw)
        np.testing.assert_allclose(g, want, atol=1e-12, rtol=0)

    def test_rectangular_window_tiled(self, pool):
        imgs = np.random.default_rng(12).standard_normal((3, 32, 40))
        cfg = sgt.Savgol2DConfig(4, 2, 2)
        y, _ = _port_2d(pool, TILES, imgs, (None, "seq", "cols"), cfg,
                        batch_axis=None, col_axis="cols")
        want = sgt.savgol2d_apply(torch.from_numpy(imgs), torch.from_numpy(
            savgol2d_weights_np(cfg, np.float64)), scale=cfg.scale)
        np.testing.assert_allclose(y, want.numpy(), atol=1e-12, rtol=0)


def _error(pool, entry, mesh, args, kwargs):
    errs = pool.run(run_error, entry, *mesh, args, kwargs)
    assert all(e == errs[0] for e in errs), errs
    assert errs[0] is not None, "no error raised"
    return errs[0]


@pytest.mark.parametrize("case,kind,match", [
    ("indivisible", "ValueError", "divide evenly"),
    ("too_short", "ValueError", "window size"),
    ("halo", "ValueError", "halo"),
    ("method", "ValueError", "method"),
    ("bf16", None, None),
    ("boundary", "ValueError", "banana"),
])
def test_apply_sharded_errors(pool, case, kind, match):
    """Each bad argument raises on every rank alike; ``method="bf16"``,
    which raised here until the mode was ported, now runs: K3's bf16
    plain version on each rank's block, equal to the single-device bf16
    apply away from the outer ``n`` samples (where the sharded route fits
    its edge rows exactly, as the JAX package's does)."""
    cfg = sgt.SavgolConfig(8 if case == "too_short" else 4, 2)
    cw, ew = savgol_weights_np(cfg, np.float64)
    N = {"indivisible": 100, "too_short": 64}.get(case, 256)
    kw = dict(half_window=cfg.half_window)
    kw.update({"halo": dict(halo="nccl"), "method": dict(method="cuda"),
               "bf16": dict(method="bf16"),
               "boundary": dict(boundary="banana")}.get(case, {}))
    x = np.random.default_rng(31).standard_normal((2, N))
    args = [Sharded(x, (None, "seq")), Full(cw), Full(ew)]
    if kind is None:
        errs = pool.run(run_error, "apply_sharded", *SEQ8, args, kw)
        assert errs == [None] * len(errs), errs
        y, _ = _run(pool, "apply_sharded", SEQ8, args, kw, (None, "seq"))
        f = sgt.Savgol1D.create(cfg, dtype=torch.float64, device="cpu")
        want = f.apply(torch.from_numpy(x), method="bf16").numpy()
        n = cfg.half_window
        np.testing.assert_array_equal(y[:, n:-n], want[:, n:-n])
        return
    name, msg = _error(pool, "apply_sharded", SEQ8, args, kw)
    assert name == kind and match in msg, (name, msg)


def test_make_mesh_default_needs_a_card(tmp_path):
    """``make_mesh()`` builds a mesh of cards unless told otherwise: with no
    card it raises and names ``device_type="cpu"``, which then works."""
    import torch.distributed as dist
    from savgol_tpu_torch.parallel import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match='device_type="cpu"'):
                make_mesh()
        m = make_mesh(device_type="cpu")
        assert m.mesh_dim_names == ("batch", "seq")
        assert tuple(m.mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_pool_default_needs_a_card():
    """``Pool(P)`` starts its ranks on the card unless told otherwise: with
    no card it raises before it spawns a rank and names ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present, so Pool(2) would start on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Pool(2)


@pytest.mark.parametrize("case,kind,match", [
    ("rows_indivisible", "ValueError", "divide evenly"),
    ("cols_indivisible", "ValueError", "divide evenly"),
    ("row_shard_small", "ValueError", "window height"),
    ("col_shard_small", "ValueError", "window width"),
    ("col_axis", "ValueError", "mesh dimension"),
    ("rdma_tiled_cpu", "NotImplementedError", "rdma"),
    ("halo", "ValueError", "halo"),
])
def test_apply2d_sharded_errors(pool, case, kind, match):
    cfg = sgt.Savgol2DConfig(3, 3 if case == "row_shard_small" else 2, 2)
    w = savgol2d_weights_np(cfg, np.float64)
    shape = {"rows_indivisible": (63, 48), "cols_indivisible": (64, 42),
             "row_shard_small": (16, 40),
             "col_shard_small": (64, 24)}.get(case, (64, 48))
    tiled = case not in ("rows_indivisible", "row_shard_small", "halo")
    mesh, spec = (TILES, ("seq", "cols")) if tiled else (SEQ8, ("seq",))
    kw = dict(scale=cfg.scale)
    if tiled:
        kw["col_axis"] = "nope" if case == "col_axis" else "cols"
    kw.update({"rdma_tiled_cpu": dict(halo="rdma"),
               "halo": dict(halo="nccl")}.get(case, {}))
    name, msg = _error(pool, "apply2d_sharded", mesh,
                       [Sharded(np.zeros(shape), spec), Full(w)], kw)
    assert name == kind and match in msg, (name, msg)
