"""The port's package namespace against ``savgol_tpu``'s: the scipy
drop-in's ``savgol_filter`` and ``savgol_coeffs`` are exported from the
package as ``savgol_tpu/__init__.py`` exports them, give the JAX package's
values on the same numpy-seeded input, and importing the package still
imports no JAX.

Tolerance: 1e-12 abs for float64 (both sides use the same exact host
weights and differ only in summation order), 2e-6 * max(1, max|ref|) for
float32.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import savgol_tpu as sg
import savgol_tpu_torch as sgt
from savgol_tpu_torch import scipy_compat

F32_TOL = 2e-6
F64_TOL = 1e-12


@pytest.mark.parametrize("name", ["savgol_filter", "savgol_coeffs"])
def test_scipy_names_are_exported(name):
    assert getattr(sgt, name) is getattr(scipy_compat, name)
    assert name in sgt.__all__
    assert hasattr(sg, name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["interp", "mirror", "nearest", "wrap",
                                  "constant"])
def test_savgol_filter_matches_jax(mode, dtype):
    x = np.random.default_rng(91).standard_normal((3, 200)).astype(dtype)
    want = np.asarray(sg.savgol_filter(jnp.asarray(x), 11, 3, deriv=1,
                                       delta=0.5, mode=mode, cval=0.25))
    got = sgt.savgol_filter(x, 11, 3, deriv=1, delta=0.5, mode=mode,
                            cval=0.25, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    tol = F32_TOL if dtype == "float32" else F64_TOL
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("pos", [None, 0, 3, 2.5])
@pytest.mark.parametrize("use", ["conv", "dot"])
def test_savgol_coeffs_matches_jax(pos, use):
    want = np.asarray(sg.savgol_coeffs(9, 4, deriv=2, delta=0.1, pos=pos,
                                       use=use))
    got = sgt.savgol_coeffs(9, 4, deriv=2, delta=0.1, pos=pos, use=use)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * max(
        1.0, float(np.abs(want).max())))


def test_package_import_leaves_jax_out():
    code = ("import sys, savgol_tpu_torch as s; "
            "assert s.savgol_filter and s.savgol_coeffs; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "False"


def test_tensor_input_stays_a_tensor():
    x = torch.from_numpy(np.random.default_rng(92).standard_normal(64))
    y = sgt.savgol_filter(x, 7, 2)
    assert isinstance(y, torch.Tensor) and y.device == x.device
    assert np.abs(y.numpy() - np.asarray(sg.savgol_filter(
        jnp.asarray(x.numpy()), 7, 2))).max() <= F64_TOL
