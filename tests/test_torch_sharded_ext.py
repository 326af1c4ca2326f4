"""The sharded masked and nonuniform paths of the port against the JAX
package: ``parallel.masked_apply_sharded``, ``nonuniform_apply_sharded``
and ``masked2d_apply_sharded`` over their boundaries, weighted masks, batch
meshes and gradients, with their errors.

The port's side runs in one persistent pool of 4 spawned ranks on a
``gloo`` group (``savgol_tpu_torch.parallel.launch``); each rank gets its
block of the same global numpy input. The JAX side runs
``savgol_tpu.parallel.sharded_ext`` jitted, as ``tests/
test_sharded_ext.py`` does, on meshes of the same shape over 4 of the 8
virtual CPU devices. Both exchange their halos by point-to-point sends.

Tolerance: 1e-12 in f64 with identical NaN fill patterns against the
port's single-device call on the whole array (``tests/test_sharded_ext.py::
_same``, the sharding contract); against the JAX package's sharded call,
the port's own masked / nonuniform f64 contract where it differs
(1e-10, ``tests/test_torch_masked.py:33``). A JAX gradient of the
nonuniform and the ``"qr"`` paths compiles for 20-30 s on this CPU, so those
two gradients are held to the port's single-device gradient, which
``tests/test_torch_nonuniform.py`` and ``tests/test_torch_masked.py`` hold
to JAX's.
"""

import functools

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch.parallel.launch import (Pool, Sharded, run_error,
                                              run_sharded)

JAX_TOL = 1e-10

SEQ4 = (("batch", "seq"), (1, 4))
B2S2 = (("batch", "seq"), (2, 2))
ROWS4 = (("rows",), (4,))


@pytest.fixture(scope="module")
def pool():
    with Pool(4, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def jx():
    """(savgol_tpu, jax, jnp, sharded_ext, meshes) over 4 virtual
    devices."""
    sg = pytest.importorskip("savgol_tpu")
    import jax
    import jax.numpy as jnp
    from savgol_tpu.parallel import sharded_ext
    from savgol_tpu.parallel.sharded import make_mesh
    devs = jax.devices()[:4]
    meshes = {SEQ4: make_mesh(*SEQ4, devices=devs),
              B2S2: make_mesh(*B2S2, devices=devs),
              ROWS4: make_mesh(*ROWS4, devices=devs)}
    return sg, jax, jnp, sharded_ext, meshes


def _holed(rng, shape, frac=0.15):
    x = rng.standard_normal(shape)
    x[rng.random(shape) < frac] = np.nan
    return x


def _same(got, want, atol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=0)


def _jax(jx, name, mesh, arrays, grad=False, **kw):
    """The JAX package's sharded call, jitted (and its gradients of
    sum(y ** 2) in every array)."""
    _, jax, jnp, ext, meshes = jx
    fn = jax.jit(functools.partial(getattr(ext, name), mesh=meshes[mesh],
                                   **kw))
    args = [jnp.asarray(a) for a in arrays]
    y = np.asarray(fn(*args))
    if not grad:
        return y
    gs = jax.grad(lambda *v: jnp.sum(fn(*v) ** 2),
                  argnums=tuple(range(len(args))))(*args)
    return y, [np.asarray(g) for g in gs]


def _port(pool, name, mesh, args, out_spec, **kw):
    return pool.run(run_sharded, name, *mesh, args, kw, out_spec)[0]


_SINGLE = {"masked_apply_sharded": "savgol_apply_masked",
           "nonuniform_apply_sharded": "savgol_apply_nonuniform",
           "masked2d_apply_sharded": "savgol2d_apply_masked"}


def _single(name, arrays, grad=False, **kw):
    """The port's single-device call on the whole arrays (and its
    gradients of sum(y ** 2) in every array)."""
    kw.pop("row_axis", None)
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    ts = [torch.from_numpy(np.asarray(a)).requires_grad_(grad)
          for a in arrays]
    y = getattr(sgt, _SINGLE[name])(*ts, **kw)
    if not grad:
        return y.numpy()
    gs = torch.autograd.grad(y.square().sum(), ts)
    return y.detach().numpy(), [g.numpy() for g in gs]


class TestMasked1DSharded:
    @pytest.mark.parametrize("boundary", ["truncate", "periodic", "constant",
                                          "reflect"])
    @pytest.mark.parametrize("n,m,d", [(5, 3, 0), (7, 4, 1)])
    def test_matches_jax(self, pool, jx, boundary, n, m, d):
        x = _holed(np.random.default_rng(0), (3, 256))
        kw = dict(half_window=n, poly_order=m, derivative=d,
                  boundary=boundary)
        y, _ = _port(pool, "masked_apply_sharded", SEQ4,
                     [Sharded(x, (None, "seq"))], (None, "seq"), **kw)
        _same(y, _single("masked_apply_sharded", [x], **kw))
        if (n, m, d) == (7, 4, 1):
            _same(y, _jax(jx, "masked_apply_sharded", SEQ4, [x], **kw),
                  JAX_TOL)

    def test_weighted_and_batch_mesh(self, pool, jx):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((4, 128))
        w = rng.uniform(0.0, 2.0, size=(4, 128))
        w[w < 0.3] = 0.0
        kw = dict(half_window=6, poly_order=3, fill=0.0)
        spec = ("batch", "seq")
        y, _ = _port(pool, "masked_apply_sharded", B2S2,
                     [Sharded(x, spec)], spec, mask=Sharded(w, spec), **kw)
        _same(y, _single("masked_apply_sharded", [x], mask=w, **kw))
        want = _jax(jx, "masked_apply_sharded", B2S2, [x],
                    mask=np.asarray(w), **kw)
        _same(y, want, JAX_TOL)

    @pytest.mark.parametrize("solver", ["normal", "qr"])
    def test_grad_matches_jax(self, pool, jx, solver):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 128))
        w = rng.uniform(0.5, 2.0, size=(2, 128))
        kw = dict(half_window=5, poly_order=2, fill=0.0, solver=solver)
        spec = (None, "seq")
        y, gs = _port(pool, "masked_apply_sharded", SEQ4,
                      [Sharded(x, spec, grad=True)], spec,
                      mask=Sharded(w, spec, grad=True), **kw)
        if solver == "qr":
            ts = [torch.from_numpy(a).requires_grad_() for a in (x, w)]
            yw = sgt.savgol_apply_masked(ts[0], mask=ts[1], **kw)
            want = torch.autograd.grad(yw.square().sum(), ts)
            for g, gw in zip(gs, want):
                np.testing.assert_allclose(g, gw.numpy(), atol=1e-12,
                                           rtol=0)
            return
        _, jax, jnp, ext, meshes = jx
        fn = jax.jit(functools.partial(ext.masked_apply_sharded,
                                       mesh=meshes[SEQ4], **kw))
        want = jax.grad(lambda a, b: jnp.sum(fn(a, mask=b) ** 2),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        for g, gw in zip(gs, want):
            np.testing.assert_allclose(g, np.asarray(gw), atol=1e-12, rtol=0)

    def test_1d_input(self, pool):
        x = _holed(np.random.default_rng(3), (256,))
        kw = dict(half_window=4, poly_order=2)
        y, _ = _port(pool, "masked_apply_sharded", SEQ4,
                     [Sharded(x, ("seq",))], ("seq",), **kw)
        _same(y, _single("masked_apply_sharded", [x], **kw))


class TestNonuniformSharded:
    @pytest.mark.parametrize("n,m,d", [(5, 3, 0), (6, 2, 1)])
    def test_matches_jax(self, pool, jx, n, m, d):
        rng = np.random.default_rng(10)
        t = np.cumsum(rng.uniform(0.2, 1.5, size=(3, 256)), axis=-1)
        x = _holed(rng, (3, 256), frac=0.1)
        kw = dict(half_window=n, poly_order=m, derivative=d)
        spec = (None, "seq")
        y, _ = _port(pool, "nonuniform_apply_sharded", SEQ4,
                     [Sharded(x, spec), Sharded(t, spec)], spec, **kw)
        _same(y, _single("nonuniform_apply_sharded", [x, t], **kw))
        if (n, m, d) == (6, 2, 1):
            _same(y, _jax(jx, "nonuniform_apply_sharded", SEQ4, [x, t],
                          **kw), JAX_TOL)

    def test_shared_1d_t_and_batch_mesh(self, pool, jx):
        rng = np.random.default_rng(11)
        t = np.cumsum(rng.uniform(0.2, 1.5, size=128))
        x = rng.standard_normal((4, 128))
        kw = dict(half_window=4, poly_order=2)
        y, _ = _port(pool, "nonuniform_apply_sharded", B2S2,
                     [Sharded(x, ("batch", "seq")), Sharded(t, ("seq",))],
                     ("batch", "seq"), **kw)
        _same(y, _single("nonuniform_apply_sharded", [x, t], **kw))

    def test_grad_matches_single_device(self, pool):
        rng = np.random.default_rng(12)
        t = np.cumsum(rng.uniform(0.2, 1.5, size=(2, 128)), axis=-1)
        x = rng.standard_normal((2, 128))
        kw = dict(half_window=4, poly_order=2, derivative=1, fill=0.0)
        spec = (None, "seq")
        y, gs = _port(pool, "nonuniform_apply_sharded", SEQ4,
                      [Sharded(x, spec, grad=True),
                       Sharded(t, spec, grad=True)], spec, **kw)
        want, gw = _single("nonuniform_apply_sharded", [x, t], grad=True,
                           **kw)
        _same(y, want)
        for g, w in zip(gs, gw):
            np.testing.assert_allclose(g, w, atol=1e-12, rtol=0)


class TestMasked2DSharded:
    @pytest.mark.parametrize("boundary", ["truncate", "periodic", "constant",
                                          "reflect"])
    def test_matches_jax(self, pool, jx, boundary):
        img = _holed(np.random.default_rng(20), (32, 24))
        kw = dict(half_window_x=2, half_window_y=2, poly_order=2, deriv_x=1,
                  boundary=boundary, row_axis="rows")
        y, _ = _port(pool, "masked2d_apply_sharded", ROWS4,
                     [Sharded(img, ("rows",))], ("rows",), **kw)
        _same(y, _single("masked2d_apply_sharded", [img], **kw))
        _same(y, _jax(jx, "masked2d_apply_sharded", ROWS4, [img], **kw),
              JAX_TOL)

    def test_batched_weighted_and_grad(self, pool):
        rng = np.random.default_rng(21)
        img = rng.standard_normal((2, 32, 16))
        w = rng.uniform(0.5, 2.0, size=(2, 32, 16))
        kw = dict(half_window_x=2, half_window_y=2, poly_order=2, fill=0.0,
                  row_axis="rows")
        spec = (None, "rows")
        y, (g,) = _port(pool, "masked2d_apply_sharded", ROWS4,
                        [Sharded(img, spec, grad=True)], spec,
                        mask=Sharded(w, spec), **kw)
        want, (gw,) = _single("masked2d_apply_sharded", [img], grad=True,
                              mask=w, **kw)
        _same(y, want)
        np.testing.assert_allclose(g, gw, atol=1e-12, rtol=0)


def _error(pool, entry, mesh, args, kwargs):
    errs = pool.run(run_error, entry, *mesh, args, kwargs)
    assert all(e == errs[0] for e in errs), errs
    assert errs[0] is not None, "no error raised"
    return errs[0]


@pytest.mark.parametrize("entry,mesh,shape,spec,kw,match", [
    ("masked_apply_sharded", SEQ4, (2, 250), (None, "seq"),
     dict(half_window=4, poly_order=2), "divide evenly"),
    ("masked_apply_sharded", SEQ4, (2, 32), (None, "seq"),
     dict(half_window=8, poly_order=2), "window size"),
    ("masked_apply_sharded", SEQ4, (2, 64), (None, "seq"),
     dict(half_window=4, poly_order=2, boundary="polynomial"),
     "not offered"),
    ("nonuniform_apply_sharded", SEQ4, (2, 64), (None, "seq"),
     dict(half_window=4, poly_order=2, t=np.arange(5.0)), "t shape"),
    ("masked2d_apply_sharded", ROWS4, (30, 16), ("rows",),
     dict(half_window_x=2, half_window_y=2, poly_order=2, row_axis="rows"),
     "divide evenly"),
    ("masked2d_apply_sharded", ROWS4, (32, 16), ("rows",),
     dict(half_window_x=2, half_window_y=2, poly_order=2, row_axis="rows",
          boundary="valid"), "not offered"),
    ("masked2d_apply_sharded", ROWS4, (32, 16), ("rows",),
     dict(half_window_x=2, half_window_y=2, poly_order=2, row_axis="rows",
          mask=np.ones((3, 3), bool)), "mask shape"),
])
def test_errors(pool, entry, mesh, shape, spec, kw, match):
    import torch
    kw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    name, msg = _error(pool, entry, mesh,
                       [Sharded(np.zeros(shape), spec)], kw)
    assert name == "ValueError" and match in msg, (name, msg)
