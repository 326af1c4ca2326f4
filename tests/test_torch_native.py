"""The port's loader of the host C++ engine (``savgol_tpu_torch.native``)
against the JAX package's (``savgol_tpu.native``): both compile the same
``native/`` sources with ``native/Makefile``'s flags, so every method must
give the same bits on the same input. The port's own library lives under
``build/savgol_tpu_torch/``, never at ``native/libsavgolhost.so``. The
engine is also an oracle for the port's CPU paths: ``Savgol1D`` and
``SavgolStream`` within 1e-6 and ``Savgol2D`` within 1e-5, scaled by
max(1, max|ref|).
"""

import pathlib

import numpy as np
import pytest
import torch

import savgol_tpu as sg
import savgol_tpu.native as jn
import savgol_tpu_torch as sgt
import savgol_tpu_torch.native as tn
from savgol_tpu_torch._build import BUILD_DIR

CONFIGS_1D = [(12, 4, 0, 1.0), (5, 3, 1, 0.5), (8, 4, 2, 0.1), (2, 2, 0, 1.0),
              (32, 10, 4, 1.0)]
BOUNDARIES_1D = ["polynomial", "reflect", "periodic", "constant"]
BOUNDARIES_2D = ["valid", "constant", "reflect", "periodic"]
CONFIGS_2D = [(5, 5, 3, 0, 0, 1.0, 1.0), (3, 2, 2, 1, 0, 0.5, 1.0),
              (4, 4, 4, 1, 1, 1.0, 0.25)]


def _pair(cfg, boundary="polynomial"):
    n, m, d, dt = cfg
    kw = dict(half_window=n, poly_order=m, derivative=d, time_step=dt,
              boundary=boundary)
    return (tn.HostSavgol1D(sgt.SavgolConfig(**kw)),
            jn.HostSavgol1D(sg.SavgolConfig(**kw)))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def test_library_is_the_ports_own():
    path = pathlib.Path(tn.load_library()._name).resolve()
    assert path.parent == BUILD_DIR.resolve()
    assert path.name.startswith("libsavgolhost_") and path.suffix == ".so"
    assert path != pathlib.Path(jn._SO_PATH).resolve()


@pytest.mark.parametrize("boundary", BOUNDARIES_1D)
@pytest.mark.parametrize("cfg", CONFIGS_1D, ids=str)
def test_host1d_apply_bit_equal(cfg, boundary):
    ours, theirs = _pair(cfg, boundary)
    x = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    for sign in (False, True):
        _same(ours.apply(x, reference_edge_sign=sign),
              theirs.apply(x, reference_edge_sign=sign))
    _same(ours.apply_valid(x), theirs.apply_valid(x))
    for a, b in zip(ours.weights(), theirs.weights()):
        _same(a, b)


@pytest.mark.parametrize("cfg", CONFIGS_1D[:3], ids=str)
def test_host1d_batch_threaded_strided_bit_equal(cfg):
    ours, theirs = _pair(cfg)
    rng = np.random.default_rng(2)
    xb = rng.standard_normal((5, 400)).astype(np.float32)
    for threads in (1, 0, 3):
        _same(ours.apply_batch(xb, n_threads=threads),
              theirs.apply_batch(xb, n_threads=threads))
    x1 = rng.standard_normal(20_000).astype(np.float32)
    _same(ours.apply_threaded(x1, n_threads=4),
          theirs.apply_threaded(x1, n_threads=4))
    _same(ours.apply_threaded(xb, reference_edge_sign=True),
          theirs.apply_threaded(xb, reference_edge_sign=True))
    rec = np.zeros(300, dtype=[("t", np.float64), ("value", np.float32)])
    rec["value"] = rng.standard_normal(300)
    out_a, out_b = rec.copy(), rec.copy()
    ours.apply_strided(rec["value"], out=out_a["value"])
    theirs.apply_strided(rec["value"], out=out_b["value"])
    _same(out_a["value"], out_b["value"])
    _same(out_a["t"], rec["t"])
    cols = rng.standard_normal((300, 3)).astype(np.float32)
    _same(ours.apply_strided(cols[:, 1]), theirs.apply_strided(cols[:, 1]))


def test_host1d_rejects_as_jax():
    ours, theirs = _pair((12, 4, 0, 1.0))
    short = np.ones(10, np.float32)
    for obj in (ours, theirs):
        with pytest.raises(ValueError, match="too short"):
            obj.apply(short)
        with pytest.raises(ValueError, match="1D float32 view"):
            obj.apply_strided(np.ones(30))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("cfg", CONFIGS_1D[:3], ids=str)
def test_host_stream_bit_equal(cfg, static):
    n, m, d, dt = cfg
    kw = dict(half_window=n, poly_order=m, derivative=d, time_step=dt)
    s_ours = tn.HostSavgolStream(sgt.SavgolConfig(**kw),
                                 static_storage=static)
    s_theirs = jn.HostSavgolStream(sg.SavgolConfig(**kw),
                                   static_storage=static)
    x = np.random.default_rng(3).standard_normal(120).astype(np.float32)
    for v in x[:40].tolist():
        assert s_ours.push(v) == s_theirs.push(v)
    for v in x[40:].tolist():
        _same(s_ours.push_full(v), s_theirs.push_full(v))
    assert s_ours.ready == s_theirs.ready
    assert s_ours.samples_received == s_theirs.samples_received
    _same(s_ours.flush(), s_theirs.flush())
    assert s_ours.samples_output == s_theirs.samples_output
    s_ours.reset()
    s_theirs.reset()
    lead_ours = tn.HostSavgolStream(sgt.SavgolConfig(**kw),
                                    reference_edge_sign=True)
    lead_theirs = jn.HostSavgolStream(sg.SavgolConfig(**kw),
                                      reference_edge_sign=True)
    for v in x[:2 * n + 3].tolist():
        lead_ours.push(v)
        lead_theirs.push(v)
    _same(lead_ours.flush_leading(), lead_theirs.flush_leading())
    _same(lead_ours.push_full(0.5, max_outputs=0),
          lead_theirs.push_full(0.5, max_outputs=0))


@pytest.mark.parametrize("boundary", BOUNDARIES_2D)
@pytest.mark.parametrize("cfg", CONFIGS_2D, ids=str)
def test_host2d_bit_equal(cfg, boundary):
    ours = tn.HostSavgol2D(sgt.Savgol2DConfig(*cfg))
    theirs = jn.HostSavgol2D(sg.Savgol2DConfig(*cfg))
    img = np.random.default_rng(4).standard_normal((37, 45)).astype(
        np.float32)
    _same(ours.apply(img, boundary), theirs.apply(img, boundary))
    _same(ours.apply_threaded(img, boundary, n_threads=3),
          theirs.apply_threaded(img, boundary, n_threads=3))
    _same(ours.weights(), theirs.weights())


@pytest.mark.parametrize("boundary", BOUNDARIES_2D)
def test_derivative_helpers_bit_equal(boundary):
    img = np.random.default_rng(5).standard_normal((40, 33)).astype(
        np.float32)
    args = (img, 3, 4, 3, 0.5, 2.0, boundary)
    for name in ("gradient2d", "hessian2d", "laplacian2d"):
        for threads in (None, 2):
            got = getattr(tn, name)(*args, n_threads=threads)
            want = getattr(jn, name)(*args, n_threads=threads)
            if name == "laplacian2d":
                got, want = (got,), (want,)
            for a, b in zip(got, want):
                _same(a, b)


def test_2d_rejects_as_jax():
    img = np.ones((4, 4), np.float32)
    for mod in (tn, jn):
        with pytest.raises(ValueError, match="smaller than the window"):
            mod.gradient2d(img, 3, 3, 2, boundary="valid")


@pytest.mark.parametrize("boundary", BOUNDARIES_1D)
@pytest.mark.parametrize("cfg", CONFIGS_1D, ids=str)
def test_port_savgol1d_matches_the_engine(cfg, boundary):
    ours, _ = _pair(cfg, boundary)
    n, m, d, dt = cfg
    x = np.random.default_rng(6).standard_normal((3, 300)).astype(
        np.float32)
    f = sgt.Savgol1D.create(sgt.SavgolConfig(n, m, d, time_step=dt,
                                             boundary=boundary),
                            device="cpu")
    _close(f.apply(torch.from_numpy(x)).numpy(), ours.apply_batch(x), 1e-6)
    _close(f.apply_valid(torch.from_numpy(x)).numpy(),
           np.stack([ours.apply_valid(r) for r in x]), 1e-6)


@pytest.mark.parametrize("boundary", BOUNDARIES_2D)
@pytest.mark.parametrize("cfg", CONFIGS_2D, ids=str)
def test_port_savgol2d_matches_the_engine(cfg, boundary):
    ours = tn.HostSavgol2D(sgt.Savgol2DConfig(*cfg))
    img = np.random.default_rng(7).standard_normal((37, 45)).astype(
        np.float32)
    f = sgt.Savgol2D.create(sgt.Savgol2DConfig(*cfg), device="cpu")
    _close(f.apply(torch.from_numpy(img), boundary=boundary).numpy(),
           ours.apply(img, boundary), 1e-5)


def test_port_stream_matches_the_engine():
    cfg = sgt.SavgolConfig(6, 3)
    x = np.random.default_rng(8).standard_normal(200).astype(np.float32)
    host = tn.HostSavgolStream(cfg)
    port = sgt.SavgolStream(cfg, device="cpu")
    want = np.concatenate([host.push_full(v) for v in x.tolist()]
                          + [host.flush()])
    got = torch.cat([port.push_full(v) for v in x.tolist()]
                    + [port.flush()]).numpy()
    _close(got, want, 1e-6)
