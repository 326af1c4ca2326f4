"""The port's on-device weight generators against the JAX package's.

``savgol_tpu_torch.savgol_weights`` / ``savgol_all_weights`` run the Gram
recurrence on tensors and must give ``savgol_tpu``'s jitted generator's
values: f64 within 1e-12, f32 within 1e-6 (the two sum in different
orders). ``savgol2d_weights`` solves the normal equations in the working
dtype; JAX's f32 solve itself is up to 4.4e-4 (scaled) from the host
tables at (16, 16, order 6), so the 2D generators are held to the host
f64 tables, as ``tests/test_weights.py`` holds JAX's: f64 within 1e-9
scaled by the table's largest weight, and the port's f32 no farther from
the host tables than JAX's f32 plus 1e-6 scaled. Here the tensors lie on
the CPU; ``chip_smoke.py`` phase 39 runs them on the card.
"""

import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import savgol_tpu as sg
import savgol_tpu.ops.weights as jw
import savgol_tpu_torch as sgt
import savgol_tpu_torch.ops.weights as tw

GRID_1D = [(2, 2, 0), (12, 4, 0), (12, 4, 1), (12, 4, 2), (32, 10, 4),
           (5, 3, 1)]
# chip_smoke.py phase 39's geometries (nx, ny, order, dx, dy); the last in
# f64 only, as tests/test_weights.py:308-313 runs it
GRID_2D = [(5, 5, 3, 0, 0), (4, 3, 3, 1, 1), (8, 8, 4, 0, 1),
           (3, 3, 2, 0, 0)]
F64_ONLY_2D = [(16, 16, 6, 1, 0)]
DTYPES = [(torch.float32, jnp.float32, 1e-6),
          (torch.float64, jnp.float64, 1e-12)]
IDS = ["f32", "f64"]


@pytest.mark.parametrize("dt,jdt,tol", DTYPES, ids=IDS)
@pytest.mark.parametrize("n,m,d", GRID_1D)
def test_savgol_weights_match_jax(n, m, d, dt, jdt, tol):
    c, e = tw.savgol_weights(n, m, d, dt, device="cpu")
    jc, je = jw.savgol_weights(n, m, d, jdt)
    assert c.dtype == dt and c.shape == (2 * n + 1,)
    assert e.dtype == dt and e.shape == (n, 2 * n + 1)
    assert np.abs(c.numpy() - np.asarray(jc)).max() <= tol
    assert np.abs(e.numpy() - np.asarray(je)).max() <= tol
    stack = tw.savgol_all_weights(n, m, d, dt, device="cpu")
    jstack = np.asarray(jw.savgol_all_weights(n, m, d, jdt))
    assert stack.shape == jstack.shape == (n + 1, 2 * n + 1)
    assert np.abs(stack.numpy() - jstack).max() <= tol


@pytest.mark.parametrize("n,m,d", GRID_1D)
def test_savgol_weights_f64_match_host_tables(n, m, d):
    ch, eh = tw.savgol_weights_np(sgt.SavgolConfig(n, m, d), np.float64)
    c, e = tw.savgol_weights(n, m, d, torch.float64, device="cpu")
    assert np.abs(c.numpy() - ch).max() <= 1e-12
    assert np.abs(e.numpy() - eh).max() <= 1e-12


def test_savgol_weights_new_tensors_each_call():
    """A caller may write into the result: the next call is unchanged
    (only the host constants are cached)."""
    c, e = tw.savgol_weights(6, 3, 1, device="cpu")
    want_c, want_e = c.clone(), e.clone()
    c.zero_()
    e.fill_(7.0)
    c2, e2 = tw.savgol_weights(6, 3, 1, device="cpu")
    assert torch.equal(c2, want_c) and torch.equal(e2, want_e)


def _scaled(w, host):
    return float(np.abs(w - host).max() / np.abs(host).max())


@pytest.mark.parametrize("g", GRID_2D + F64_ONLY_2D, ids=str)
def test_savgol2d_weights_f64_match_host_tables(g):
    host = tw.savgol2d_weights_np(sgt.Savgol2DConfig(*g), np.float64)
    w = tw.savgol2d_weights(*g, dtype=torch.float64, device="cpu")
    assert w.dtype == torch.float64 and w.shape == host.shape
    assert _scaled(w.numpy(), host) <= 1e-9
    jwv = np.asarray(jw.savgol2d_weights(*g, dtype=jnp.float64))
    assert _scaled(jwv, host) <= 1e-9


@pytest.mark.parametrize("g", GRID_2D, ids=str)
def test_savgol2d_weights_f32_no_farther_than_jax(g):
    host = tw.savgol2d_weights_np(sgt.Savgol2DConfig(*g), np.float64)
    w = tw.savgol2d_weights(*g, device="cpu")
    assert w.dtype == torch.float32 and w.shape == host.shape
    ours = _scaled(w.numpy().astype(np.float64), host)
    theirs = _scaled(np.asarray(jw.savgol2d_weights(*g), np.float64), host)
    assert ours <= theirs + 1e-6
    assert ours <= 1e-5


def _error_of(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("g,dt", [
    ((5, 1, 3, 0, 0), "float32"),     # y^3 == y on {-1, 0, 1}
    ((8, 1, 3, 0, 1), "float32"),     # the target mixes into the ambiguity
    ((2, 2, 5, 1, 0), "float32"),     # x^5 == 5x^3 - 4x on {-2..2}
    ((16, 1, 3, 0, 0), "float64"),    # well-posed smoothing, singular grid
    ((1, 8, 3, 0, 0), "float64"),
], ids=str)
def test_savgol2d_weights_degenerate_raise_as_jax(g, dt):
    ours = _error_of(lambda: tw.savgol2d_weights(
        *g, dtype=getattr(torch, dt), device="cpu"))
    theirs = _error_of(lambda: jw.savgol2d_weights(
        *g, dtype=getattr(jnp, dt)))
    assert ours == theirs
    assert ours[0] is np.linalg.LinAlgError


@pytest.mark.parametrize("cfg", [
    dict(half_window=12, poly_order=4),
    dict(half_window=5, poly_order=3, derivative=1, time_step=0.5),
    dict(half_window=8, poly_order=4, derivative=2, time_step=0.25,
         boundary="reflect"),
], ids=str)
def test_create_on_device_matches_jax(cfg):
    x = np.random.default_rng(17).standard_normal((3, 257)).astype(
        np.float32)
    f = sgt.Savgol1D.create_on_device(sgt.SavgolConfig(**cfg), device="cpu")
    jf = sg.Savgol1D.create_on_device(sg.SavgolConfig(**cfg))
    assert np.abs(f.center_weights.numpy()
                  - np.asarray(jf.center_weights)).max() <= 1e-6
    assert float(f.dt_inv) == float(jf.dt_inv)
    want = np.asarray(jf.apply(jnp.asarray(x)))
    got = f.apply(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())
    valid = f.apply_valid(torch.from_numpy(x)).numpy()
    want_valid = np.asarray(jf.apply_valid(jnp.asarray(x)))
    assert np.abs(valid - want_valid).max() <= 1e-6 * max(
        1.0, np.abs(want_valid).max())


@pytest.mark.parametrize("call", [
    lambda: tw.savgol_weights(4, 2),
    lambda: tw.savgol_all_weights(4, 2),
    lambda: tw.savgol2d_weights(3, 3, 2),
    lambda: sgt.Savgol1D.create_on_device(sgt.SavgolConfig(4, 2),
                                          device=None),
], ids=["savgol_weights", "savgol_all_weights", "savgol2d_weights",
        "create_on_device"])
def test_default_device_is_the_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


def test_all_covers_the_jax_package():
    assert set(sg.__all__) <= set(sgt.__all__)
    for name in sgt.__all__:
        assert hasattr(sgt, name), name


MODULES = ["savgol_tpu_torch", "savgol_tpu_torch.ops.weights",
           "savgol_tpu_torch.native", "savgol_tpu_torch.cli",
           "savgol_tpu_torch.utils.export", "savgol_tpu_torch.utils.roofline",
           "savgol_tpu_torch.utils.profiling"]


@pytest.fixture(scope="module")
def leaked():
    """For each module, imported in turn in one fresh interpreter, which of
    jax and savgol_tpu had entered sys.modules after it."""
    code = ("import importlib, json, sys\n"
            "out = {}\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "    out[m] = [k for k in ('jax', 'savgol_tpu') "
            "if k in sys.modules]\n"
            "print(json.dumps(out))\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_out(module, leaked):
    assert leaked[module] == []
