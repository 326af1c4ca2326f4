"""The port's config and host weights against the JAX package's.

``savgol_tpu_torch.config`` is a copy of ``savgol_tpu.config`` and
``savgol_tpu_torch.ops.weights`` the host half of
``savgol_tpu.ops.weights``: the validation errors must be the same and the
f64 tables bit-identical.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import savgol_tpu.config as jcfg
import savgol_tpu.ops.weights as jw
import savgol_tpu_torch.config as tcfg
import savgol_tpu_torch.ops.weights as tw

INVALID_1D = [
    dict(half_window=0, poly_order=0),
    dict(half_window=33, poly_order=2),
    dict(half_window=-1, poly_order=0),
    dict(half_window=2, poly_order=5),
    dict(half_window=2, poly_order=-1),
    dict(half_window=12, poly_order=11),
    dict(half_window=4, poly_order=3, derivative=5),
    dict(half_window=4, poly_order=3, derivative=-1),
    dict(half_window=4, poly_order=2, derivative=3),
    dict(half_window=4, poly_order=2, time_step=0.0),
    dict(half_window=4, poly_order=2, time_step=-1.0),
    dict(half_window=4, poly_order=2, boundary="mirror"),
]

INVALID_2D = [
    dict(half_window_x=0, half_window_y=2, poly_order=1),
    dict(half_window_x=2, half_window_y=17, poly_order=1),
    dict(half_window_x=2, half_window_y=2, poly_order=7),
    dict(half_window_x=2, half_window_y=2, poly_order=2, deriv_x=-1),
    dict(half_window_x=2, half_window_y=2, poly_order=2, deriv_x=2,
         deriv_y=1),
    dict(half_window_x=2, half_window_y=2, poly_order=2, delta_y=0.0),
    dict(half_window_x=1, half_window_y=1, poly_order=3),
]


def _error_of(cls, kw):
    with pytest.raises(Exception) as info:
        cls(**kw)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("kw", INVALID_1D, ids=repr)
def test_invalid_1d_config_same_error(kw):
    assert (_error_of(tcfg.SavgolConfig, kw)
            == _error_of(jcfg.SavgolConfig, kw))


@pytest.mark.parametrize("kw", INVALID_2D, ids=repr)
def test_invalid_2d_config_same_error(kw):
    assert (_error_of(tcfg.Savgol2DConfig, kw)
            == _error_of(jcfg.Savgol2DConfig, kw))


def test_valid_configs_and_helpers_agree():
    for make in ("smooth", "deriv1", "deriv2"):
        args = (7, 3) if make == "smooth" else (7, 3, 0.25)
        t, j = getattr(tcfg, make)(*args), getattr(jcfg, make)(*args)
        assert dataclass_fields(t) == dataclass_fields(j)
        assert t.window_size == j.window_size and t.dt_scale == j.dt_scale
    t = tcfg.SavgolConfig(5, 2, boundary="periodic")
    assert t.boundary is tcfg.BoundaryMode.PERIODIC
    assert {m.value for m in tcfg.BoundaryMode} == {
        m.value for m in jcfg.BoundaryMode}
    assert {k.value: v for k, v in tcfg.PAD_MODE.items()} == {
        k.value: v for k, v in jcfg.PAD_MODE.items()}
    c2t = tcfg.Savgol2DConfig(3, 2, 2, deriv_x=1, delta_x=0.5)
    c2j = jcfg.Savgol2DConfig(3, 2, 2, deriv_x=1, delta_x=0.5)
    assert (c2t.num_terms, c2t.window_area, c2t.scale) == (
        c2j.num_terms, c2j.window_area, c2j.scale)
    for name in ("MAX_HALF_WINDOW", "MAX_WINDOW", "MAX_POLY_ORDER",
                 "MAX_DERIVATIVE", "MAX_HALF_WINDOW_2D", "MAX_POLY_ORDER_2D",
                 "MAX_TERMS_2D"):
        assert getattr(tcfg, name) == getattr(jcfg, name)


def dataclass_fields(cfg):
    return (cfg.half_window, cfg.poly_order, cfg.derivative, cfg.time_step,
            cfg.boundary.value)


@pytest.mark.parametrize("n", range(1, 33))
def test_weights_bit_identical(n):
    """Every n <= 32, m <= min(10, 2n), d <= min(m, 4): the f64 tables of
    both packages are equal bit for bit (and after the f32 cast)."""
    for m in range(0, min(10, 2 * n) + 1):
        for d in range(0, min(m, 4) + 1):
            kw = dict(half_window=n, poly_order=m, derivative=d)
            ct, et = tw.savgol_weights_np(tcfg.SavgolConfig(**kw), np.float64)
            cj, ej = jw.savgol_weights_np(jcfg.SavgolConfig(**kw), np.float64)
            assert ct.dtype == np.float64 and et.shape == (n, 2 * n + 1)
            assert np.array_equal(ct, cj) and np.array_equal(et, ej), kw
            assert np.array_equal(
                tw.savgol_all_weights_np(tcfg.SavgolConfig(**kw), np.float64),
                jw.savgol_all_weights_np(jcfg.SavgolConfig(**kw), np.float64))
            assert np.array_equal(
                tw.savgol_all_weights_np(tcfg.SavgolConfig(**kw)),
                jw.savgol_all_weights_np(jcfg.SavgolConfig(**kw)))
    m = min(10, 2 * n)
    assert np.array_equal(tw.gram_poly_table(n, m, min(m, 4)),
                          jw.gram_poly_table(n, m, min(m, 4)))


def test_genfact_identical():
    for a in range(0, 80):
        for b in range(0, 12):
            assert tw.genfact(a, b) == jw.genfact(a, b)


def test_import_does_not_import_jax():
    code = ("import sys, savgol_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'savgol_tpu' not in sys.modules, 'savgol_tpu imported'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
