"""Drop-in scipy.signal compatibility layer on tensors (counterpart of
``savgol_tpu.scipy_compat``).

``savgol_filter`` / ``savgol_coeffs`` with scipy's signatures and mode
names, computed by the port (CUDA kernels on the card, weights exact where
scipy's lstsq loses precision). Lets scipy users switch with an import
swap::

    from savgol_tpu_torch.scipy_compat import savgol_filter   # was scipy.signal

Mode mapping (scipy name -> implementation, kernel on a CUDA tensor):

  * ``interp``   -> POLYNOMIAL edge fit (the reference's default), K1
  * ``wrap``     -> PERIODIC, K2
  * ``nearest``  -> CONSTANT (edge replication), K2
  * ``mirror``   -> reflect WITHOUT edge duplication (np.pad 'reflect') —
                    an EXTENSION beyond the reference, whose REFLECT
                    duplicates the edge sample: padded on the host, then K3
  * ``constant`` -> pad with ``cval`` — also an extension: host pad, K3

The kernels take windows up to 129 samples, the JAX package's Pallas cap
(past the reference's 65): past that, a CUDA tensor raises under
``method="auto"`` and ``method="xla"`` takes the plain version.
``method="bf16"`` runs every mode in the kernels' bf16 mode, as
``Savgol1D.apply`` does (the extension modes pad in the compute dtype,
then K3 in bf16, then ``* 1/delta**deriv``). As in scipy, input that is
not a tensor comes back as a numpy array; it is computed on ``device``,
the card by default, which raises where there is none (pass
``device="cpu"`` to compute on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from savgol_tpu_torch.config import BoundaryMode, SavgolConfig
from savgol_tpu_torch.ops.apply import (_complex_split, _compute_dtype,
                                        _correlate, _ensure_float,
                                        _move_axis_last, _restore_axis,
                                        _scale_of, _use_kernel,
                                        savgol_apply_core)
from savgol_tpu_torch.ops.cuda_conv import pad_last
from savgol_tpu_torch.ops.weights import (_gram_table, _norm_factors,
                                          _weights_from_table,
                                          savgol_weights_np)

__all__ = ["savgol_coeffs", "savgol_filter"]


def _compat_weights_np(n: int, polyorder: int, deriv: int):
    """(center, edge) f64 weights for ANY 0 <= deriv <= polyorder.

    The reference caps half_window at 32, poly_order at 10 and derivatives
    at 4 (src/savgolFilter.c:639-677) and ``SavgolConfig`` keeps those caps
    for reference parity, but scipy allows any ``polyorder <
    window_length`` and ``deriv <= polyorder``, and the Gram recurrence
    (ops/weights.py::_gram_table) holds for arbitrary (n, m, d). So the
    weights are computed directly outside the reference envelope and by the
    validated config path inside it.
    """
    if polyorder >= 2 * n + 1:
        # scipy's own constraint (raised before any branch so the direct
        # path can't dodge it into a 0/0 in the recurrence)
        raise ValueError("polyorder must be less than window_length")
    if deriv <= 4 and n <= 32 and polyorder <= 10:
        return savgol_weights_np(SavgolConfig(n, polyorder, deriv),
                                 dtype=np.float64)
    pts = np.arange(-n, n + 1, dtype=np.float64)
    G = _gram_table(pts, n, polyorder, deriv)
    return _weights_from_table(G, _norm_factors(n, polyorder), n, deriv)


_NATIVE_MODES = {
    "interp": BoundaryMode.POLYNOMIAL,
    "wrap": BoundaryMode.PERIODIC,
    "nearest": BoundaryMode.CONSTANT,
}


def savgol_coeffs(window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, pos=None, use: str = "conv"):
    """scipy.signal.savgol_coeffs equivalent (numpy f64, Gram recurrence).

    More accurate than scipy's lstsq construction at extreme configs (exact
    rational arithmetic is the oracle, ``tests/test_weights.py``).
    """
    if window_length % 2 != 1:
        raise ValueError("window_length must be odd")
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    n = window_length // 2
    if deriv > polyorder:
        # scipy semantics: the fitted polynomial's higher derivatives vanish
        return np.zeros(window_length, dtype=np.float64)
    center, edge = _compat_weights_np(n, polyorder, deriv)
    if pos is None or pos == n:
        w = center
    elif float(pos) == int(pos) and 0 <= int(pos) < window_length:
        # integer positions map to the reference's precomputed edge rows
        # (pos > n directly; pos < n by mirror symmetry)
        pos = int(pos)
        if pos > n:
            w = edge[2 * n - pos]
        else:
            w = edge[pos][::-1] * ((-1.0) ** deriv)
    else:
        # fractional pos: the Gram fit evaluated at the target t = pos - n
        # (the three-term recurrence holds at non-integer points), scipy's
        # float-pos semantics
        if not 0 <= float(pos) < window_length:
            raise ValueError("pos must be within the window")
        t = np.asarray([float(pos) - n], dtype=np.float64)
        pts = np.arange(-n, n + 1, dtype=np.float64)
        G = _gram_table(pts, n, polyorder, deriv)
        Gt = _gram_table(t, n, polyorder, deriv)
        factors = _norm_factors(n, polyorder)
        w = np.einsum("k,ki->i", factors * Gt[:, deriv, 0], G[:, 0, :])
    w = w / (delta ** deriv)
    if use == "conv":
        return w[::-1]
    if use == "dot":
        return w
    raise ValueError("use must be 'conv' or 'dot'")


def savgol_filter(x, window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, axis: int = -1, mode: str = "interp",
                  cval: float = 0.0, *, method: str = "auto", device=None):
    """scipy.signal.savgol_filter equivalent on the port. A tensor is
    filtered on its own device and comes back as a tensor there; anything
    else (a numpy array, a list) is computed on ``device``, by default
    ``"cuda"``, so the import swap reaches the kernels, and comes back as a
    numpy array, as scipy returns. With no card the default raises: pass
    ``device="cpu"`` to compute on the CPU. ``method`` as for
    ``Savgol1D.apply``."""
    if isinstance(x, torch.Tensor):
        return _filter(x, window_length, polyorder, deriv, delta, axis, mode,
                       cval, method)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "savgol_filter computes input that is not a tensor on the "
                "card by default, and torch.cuda.is_available() is False: "
                "pass device=\"cpu\" to compute on the CPU")
        device = "cuda"
    y = _filter(torch.as_tensor(x, device=device), window_length, polyorder,
                deriv, delta, axis, mode, cval, method)
    return y.cpu().numpy()


def _filter(x: torch.Tensor, window_length: int, polyorder: int, deriv: int,
            delta: float, axis: int, mode: str, cval: float,
            method: str) -> torch.Tensor:
    if window_length % 2 != 1:
        raise ValueError("window_length must be odd")
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    n = window_length // 2
    if deriv > polyorder:
        # scipy semantics: output is identically zero
        return torch.zeros(x.shape, dtype=x.dtype if x.is_floating_point()
                           or x.is_complex() else torch.float32,
                           device=x.device)
    center, edge = _compat_weights_np(n, polyorder, deriv)
    # the weights in x's real dtype (complex input filters its parts)
    dtype = (x.real.dtype if x.is_complex() else
             x.dtype if x.is_floating_point() else torch.float32)
    cw = torch.as_tensor(center, dtype=dtype, device=x.device)
    dt_inv = 1.0 / (float(delta) ** deriv)

    if mode in _NATIVE_MODES:
        ew = torch.as_tensor(edge, dtype=dtype, device=x.device)
        xl, moved = _move_axis_last(x, axis)
        y = savgol_apply_core(xl, cw, ew, n, _NATIVE_MODES[mode], dt_inv,
                              derivative=deriv, method=method)
        return _restore_axis(y, moved)

    if mode not in ("mirror", "constant"):
        raise ValueError(
            f"mode must be one of interp/mirror/nearest/wrap/constant, "
            f"got {mode!r}")

    # Extension modes: pad on the host side of the kernel, then K3.
    xl, moved = _move_axis_last(x, axis)
    xl = _ensure_float(xl, cw)
    if xl.shape[-1] < window_length:
        raise ValueError(
            f"data length ({xl.shape[-1]}) must be >= window_length")
    kernel = _use_kernel(method, xl)
    bf16 = method == "bf16"

    def ext_apply(xv):
        if mode == "mirror":
            xp = pad_last(xv, n, "reflect")
        else:
            xp = F.pad(xv, (n, n), value=float(cval))
        return _correlate(xp, cw, kernel, bf16) * _scale_of(dt_inv, xv)

    if xl.is_complex():
        # real-linear split, as on the native-mode branch
        return _restore_axis(_complex_split(ext_apply, xl), moved)
    xl, restore = _compute_dtype(xl, bf16)
    y = ext_apply(xl)
    if restore is not None:
        y = y.to(restore)
    return _restore_axis(y, moved)
