"""Speed-of-light model of the port's kernels on one NVIDIA H100: the one
home of the bounds that ``chip_smoke.py``, the probes and ``PERF.md`` give
beside each kernel's time (counterpart of ``savgol_tpu.utils.roofline``,
which models a TPU v5e).

The least time the card could take for a function is the larger of two
times: the bytes it must move (each input read once, each output written
once) over the memory rate, and the operations it must do (an FMA counted
as two) over the dense peak rate of their type. The rates are the H100 SXM
data sheet's at its 700 W limit (derived, not measured): 3.35 TB/s; 67
TFLOP/s in f32 and 34 in f64 on the CUDA cores; 989 for bf16 products
summed in f32 on the tensor cores. A card set below 700 W runs slower, so
a share of this bound is stated beside the card's power limit.

Every bound is a :class:`Roofline`, made by :func:`bound` from its bytes
and its operations; ``Roofline.fields`` gives the ``bound_ms`` /
``bound_by`` pair that the kernels line prints. Each ``speed_of_light_*``
function counts one kernel's function at the shapes it is given.

The TPU model charges every output a fixed banded MXU product and counts
exact f32 as six bf16 passes. Neither has a counterpart here: f32 and f64
run on the CUDA cores at their own peaks, and a tap is an FMA, so the
Hopper kernels' work grows with the window. That is why
:func:`speed_of_light_1d` and :func:`speed_of_light_masked_1d` take
``half_window`` and :func:`speed_of_light_2d` takes ``window_w``. Only one
card is modelled, so no function takes a chip (the TPU model's ``chip=``).

The flop counts of the solves and fits (:func:`chol_flops`,
:func:`nonuniform_flops`, :func:`k10_flops`, ...) count what each kernel's
contract needs, as the comments on each say.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ChipSpec", "H100", "HBM_BPS", "PEAK_FLOPS", "Roofline", "bound",
           "speed_of_light_1d", "speed_of_light_valid_1d",
           "speed_of_light_bank_1d", "speed_of_light_2d",
           "speed_of_light_bank_2d", "speed_of_light_separable_2d",
           "speed_of_light_masked_1d", "speed_of_light_masked_2d",
           "speed_of_light_plane_solve", "speed_of_light_plane_solve_dd",
           "speed_of_light_nonuniform", "speed_of_light_nonuniform_planes",
           "speed_of_light_nonuniform_dd", "speed_of_light_resample",
           "speed_of_light_halo", "plain_chol_flops", "chol_flops",
           "dd_chol_flops", "masked1d_flops", "nonuniform_flops",
           "nonuniform_dd_flops", "resample_flops", "k10_flops"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A card's dense peak rates (TFLOP/s, by operand type) and memory
    rate (GB/s)."""
    name: str
    f32_tflops: float
    f64_tflops: float
    bf16_tflops: float
    hbm_gbps: float

    def peak_flops(self, kind: str) -> float:
        """Operations a second for ``kind``: "f32", "f64" or "bf16"."""
        return {"f32": self.f32_tflops, "f64": self.f64_tflops,
                "bf16": self.bf16_tflops}[kind] * 1e12


# NVIDIA's data sheet for the H100 SXM part, dense rates
H100 = ChipSpec("H100 SXM (data sheet)", f32_tflops=67.0, f64_tflops=34.0,
                bf16_tflops=989.0, hbm_gbps=3350.0)
HBM_BPS = H100.hbm_gbps * 1e9
PEAK_FLOPS = {k: H100.peak_flops(k) for k in ("f32", "f64", "bf16")}

_DTYPE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}


def _dtype_name(dtype) -> str:
    name = getattr(dtype, "name", None) or str(dtype)
    name = name.replace("torch.", "")
    if name not in _DTYPE_BYTES:
        raise ValueError(f"unsupported dtype for the roofline model: "
                         f"{dtype!r}")
    return name


def _kind(method: str, dtype: str) -> str:
    """The operations' type: ``method="bf16"`` runs bf16 products on the
    tensor cores; every other method computes f64 input in f64 and the
    rest in f32 (half-precision input is promoted)."""
    if method not in ("auto", "xla", "pallas", "bf16"):
        raise ValueError(f"method must be auto/xla/pallas/bf16, got "
                         f"{method!r}")
    if method == "bf16":
        return "bf16"
    return "f64" if dtype == "float64" else "f32"


@dataclasses.dataclass(frozen=True)
class Roofline:
    """A call's cost on the H100 and the resulting ceiling."""
    elements: int          # outputs (samples or pixels) a call
    flops: dict            # {kind: operations a call}, an FMA counted as two
    hbm_bytes: float       # each input read once, each output written once

    @property
    def ops_bound_s(self) -> float:
        """The operations at the peak of their types (their times add)."""
        return sum(f / PEAK_FLOPS[k] for k, f in self.flops.items())

    @property
    def hbm_bound_s(self) -> float:
        """``hbm_bytes`` at the memory rate."""
        return self.hbm_bytes / HBM_BPS

    @property
    def bound(self) -> str:
        """Which ceiling binds: "bytes" or "operations"."""
        return "bytes" if self.hbm_bound_s >= self.ops_bound_s \
            else "operations"

    @property
    def ceiling_s(self) -> float:
        """The least seconds a call could take on this card."""
        return max(self.ops_bound_s, self.hbm_bound_s)

    @property
    def ceiling_per_s(self) -> float:
        """Speed-of-light throughput (samples/s or pixels/s)."""
        return self.elements / self.ceiling_s

    @property
    def fields(self) -> dict:
        """{"bound_ms", "bound_by"}, as a kernel's record prints them."""
        return {"bound_ms": self.ceiling_s * 1e3, "bound_by": self.bound}

    def utilization(self, measured_s: float) -> float:
        """Fraction of the binding ceiling a measured time a call achieves
        (1.0 = speed of light). Use device time (``utils.timing.
        device_ms``); a time that holds host work understates it."""
        if measured_s <= 0:
            raise ValueError("measured_s must be positive")
        return self.ceiling_s / measured_s

    def describe(self, measured_s: float | None = None) -> str:
        ops = sum(self.flops.values())
        ai = ops / self.hbm_bytes if self.hbm_bytes else 0.0
        c = H100
        lines = [
            f"card {c.name}: {c.f32_tflops:.0f} / {c.f64_tflops:.0f} / "
            f"{c.bf16_tflops:.0f} TFLOP/s f32 / f64 / bf16, "
            f"{c.hbm_gbps:.0f} GB/s",
            f"per call: {self.elements:.3g} outputs, "
            + ", ".join(f"{v:.3g} {k}" for k, v in self.flops.items())
            + f" operations, {self.hbm_bytes:.3g} bytes (AI {ai:.1f} op/B)",
            f"bounds: operations {self.ops_bound_s * 1e3:.3f} ms, bytes "
            f"{self.hbm_bound_s * 1e3:.3f} ms -> bound by {self.bound}, "
            f"ceiling {self.ceiling_per_s / 1e9:.1f} G/s",
        ]
        if measured_s is not None:
            lines.append(f"measured {measured_s * 1e3:.3f} ms = "
                         f"{100 * self.utilization(measured_s):.0f}% of "
                         f"speed of light")
        return "\n".join(lines)


def bound(nbytes: float, flops, kind: str = "f32", *,
          elements: int = 0) -> Roofline:
    """The roofline of a function that moves ``nbytes`` (each input read
    once, each output written once) and does ``flops`` operations of type
    ``kind`` (an FMA counted as two), or a {kind: flops} mapping, whose
    times add; ``elements`` outputs a call."""
    ops = dict(flops) if isinstance(flops, dict) else {kind: flops}
    return Roofline(elements=int(elements), flops=ops,
                    hbm_bytes=float(nbytes))


def _count(shape) -> int:
    return int(np.prod([int(s) for s in shape], dtype=np.int64))


def speed_of_light_1d(shape, *, dtype="float32", method: str = "auto",
                      half_window: int = 12) -> Roofline:
    """A same-length 1D apply of ``shape`` (..., N) with 2 half_window + 1
    taps (K1, K2; the default is the headline's n = 12): one input and one
    output in ``dtype``'s storage, an FMA a tap an output. ``half_window``
    is a keyword the TPU model lacks: there a window cost one MXU column
    whatever its taps; on the CUDA cores a tap costs an FMA."""
    elements = _count(shape)
    name = _dtype_name(dtype)
    b = _DTYPE_BYTES[name]
    return bound(2 * b * elements,
                 2 * (2 * half_window + 1) * elements, _kind(method, name),
                 elements=elements)


def speed_of_light_valid_1d(shape, *, dtype="float32", method: str = "auto",
                            half_window: int = 12) -> Roofline:
    """A VALID 1D correlation (K3, P1, P3) of the input ``shape`` (..., N)
    with 2 half_window + 1 taps: the input read once, its N - 2
    half_window outputs written in ``dtype``'s storage, an FMA a tap an
    output."""
    name = _dtype_name(dtype)
    b = _DTYPE_BYTES[name]
    n_in = _count(shape)
    elements = n_in // int(shape[-1]) * (int(shape[-1]) - 2 * half_window)
    return bound(b * n_in + b * elements,
                 2 * (2 * half_window + 1) * elements, _kind(method, name),
                 elements=elements)


def speed_of_light_bank_1d(half_windows, *, shape, dtype="float32"
                           ) -> Roofline:
    """A bank of same-length 1D applies sharing one input of ``shape`` (...,
    N) (K4: the derivative bank, the sweep), one window a half width in
    ``half_windows``: the input read once, an output a window written, an
    FMA a tap an output."""
    elements = _count(shape)
    name = _dtype_name(dtype)
    b = _DTYPE_BYTES[name]
    taps = sum(2 * n + 1 for n in half_windows)
    return bound(b * (1 + len(half_windows)) * elements,
                 2 * taps * elements, _kind("auto", name),
                 elements=len(half_windows) * elements)


def speed_of_light_2d(window_h: int, *, shape, dtype="float32",
                      method: str = "auto",
                      window_w: int | None = None) -> Roofline:
    """A dense 2D apply of a ``window_h`` x ``window_w`` stencil (None:
    square) on ``shape`` (..., rows, cols) output pixels (K2D-dense): one
    input and one output in ``dtype``'s storage, an FMA a tap a pixel.
    ``window_w`` is a keyword the TPU model lacks, whose row-banded MXU
    product cost a fixed 128 columns a stencil row; here every tap costs.
    The separable route's work depends on the stencil's rank:
    :func:`speed_of_light_separable_2d`."""
    return speed_of_light_bank_2d(window_h, 1, shape=shape, dtype=dtype,
                                  method=method, window_w=window_w)


def speed_of_light_bank_2d(window_h: int, stack: int, *, shape,
                           dtype="float32", method: str = "auto",
                           window_w: int | None = None) -> Roofline:
    """``stack`` dense 2D applies of ``window_h`` x ``window_w`` stencils
    sharing one input (K6b, the Hessian stack; one is
    :func:`speed_of_light_2d`): the input read once, ``stack`` outputs of
    ``shape`` written, an FMA a tap a pixel a stencil."""
    ww = window_h if window_w is None else window_w
    pix = _count(shape)
    name = _dtype_name(dtype)
    b = _DTYPE_BYTES[name]
    return bound(b * (1 + stack) * pix, stack * 2 * window_h * ww * pix,
                 _kind(method, name), elements=stack * pix)


def speed_of_light_separable_2d(window_h: int, rank: int, *, shape,
                                dtype="float32",
                                window_w: int | None = None) -> Roofline:
    """The separable 2D apply (K7) of a rank-``rank`` stencil on ``shape``
    (..., rows, cols): one input and one output, a column pass and a row
    pass a rank term, 2 rank (H + W) operations a pixel."""
    ww = window_h if window_w is None else window_w
    pix = _count(shape)
    name = _dtype_name(dtype)
    b = _DTYPE_BYTES[name]
    return bound(2 * b * pix, 2 * rank * (window_h + ww) * pix,
                 _kind("auto", name), elements=pix)


def plain_chol_flops(k: int) -> int:
    """The least k x k SPD solve: the Cholesky factor (square roots and
    reciprocals of the diagonal counted as one operation each) and two
    triangular substitutions."""
    factor = sum(2 * j + 2 + (k - 1 - j) * (2 * j + 1) for j in range(k))
    return factor + 2 * k * k


def chol_flops(k: int) -> int:
    """plane_chol.cuh chol_solve: the factor, two solves (the second for
    the refinement) and the compensated residual."""
    return plain_chol_flops(k) + 2 * k * k + 11 * k * k + k


# double-word operations in FP64 flops (an fma two), as plane_chol.cuh
# writes them
DD_TWO_SUM, DD_ADD, DD_MUL, DD_SQRT, DD_DIV = 6, 11, 10, 13, 51


def dd_chol_flops(k: int) -> int:
    """plane_chol.cuh dd_chol_solve: the factor and two substitutions."""
    factor = sum(j * (DD_MUL + DD_ADD) + DD_SQRT + DD_DIV
                 + (k - 1 - j) * (j * (DD_MUL + DD_ADD) + DD_MUL)
                 for j in range(k))
    return factor + 2 * sum(i * (DD_MUL + DD_ADD) + DD_MUL for i in range(k))


def speed_of_light_plane_solve(k: int, *, positions: int,
                               dtype="float32") -> Roofline:
    """K8a: one k x k SPD solve a position from plane stacks in ``dtype``
    (the k (k + 1) / 2 Gram entries and the k rhs in, the k coefficients
    out), its quorum and ok flags a byte each; :func:`chol_flops` at the
    peak of ``dtype`` (the refinement is in the kernel's contract)."""
    name = _dtype_name(dtype)
    b = _DTYPE_BYTES[name]
    per = b * (k * (k + 1) // 2 + k + k) + 2
    return bound(positions * per, positions * chol_flops(k),
                 _kind("auto", name), elements=positions)


def speed_of_light_plane_solve_dd(k: int, *, positions: int) -> Roofline:
    """K8b on float32 (hi, lo) pairs: the Gram entries and rhs as pairs in,
    the k float32 coefficients out, the two flags a byte each; a plain
    FP64 solve of hi + lo (:func:`plain_chol_flops`) meets its contract."""
    per = 8 * (k * (k + 1) // 2 + k) + 4 * k + 2
    return bound(positions * per, positions * plain_chol_flops(k), "f64",
                 elements=positions)


def masked1d_flops(n: int, m: int) -> int:
    """f32 operations of one K9 output (masked1d.cu): a tap's k (k + 1) / 2
    Gram and k rhs multiply-adds and its count, k = m + 1, over the 2n + 1
    taps, the solve (:func:`chol_flops`) and the k-term extraction."""
    k, ws = m + 1, 2 * n + 1
    return 2 * (k * (k + 1) // 2 + k) * ws + ws + chol_flops(k) + 2 * k


def speed_of_light_masked_1d(poly_order: int, *, shape, dtype="float32",
                             half_window: int = 12) -> Roofline:
    """The fused masked 1D fit (K9) of ``shape`` (..., N) outputs: its
    inputs, the masked values and the weights, each (..., N + 2n) in
    ``dtype``, and the output; :func:`masked1d_flops` a sample at the peak
    of ``dtype``. ``half_window`` as in :func:`speed_of_light_1d` (the TPU
    model's moment bank cost one MXU column whatever the window)."""
    elements = _count(shape)
    name = _dtype_name(dtype)
    b = _DTYPE_BYTES[name]
    rows = elements // int(shape[-1])
    padded = rows * (int(shape[-1]) + 2 * half_window)
    return bound(2 * b * padded + b * elements,
                 elements * masked1d_flops(half_window, poly_order),
                 _kind("auto", name), elements=elements)


def k10_flops(nx: int, ny: int, m: int) -> float:
    """FP64 flops of one K10 pixel (masked2d.cu): vertical profiles shared
    by a 32-wide tile row, moment and rhs correlations, the Gram assembly
    from the comb entries past rounding noise (the kernel's tables), the
    solve and the extraction."""
    from savgol_tpu_torch.ops.cuda_masked2d import _COMB_ZERO, tensor_tables_2d
    tab = tensor_tables_2d(nx, ny, m)
    wx, wy = 2 * nx + 1, 2 * ny + 1
    sy = tab["PhiY"].shape[1]
    P, M = len(tab["basis"]), len(tab["moments"])
    share = (32 + 2 * nx) / 32
    fmas = ((sy + m + 1) * wy * share + (M + P) * wx
            + int((np.abs(tab["comb"]) > _COMB_ZERO).sum()) + P)
    return 2 * fmas + wy * share + wx + chol_flops(P)


def speed_of_light_masked_2d(window_h: int, window_w: int, poly_order: int,
                             *, shape, dtype="float32") -> Roofline:
    """The fused masked 2D fit (K10) of ``shape`` (..., rows, cols)
    outputs: its inputs, the masked image and the weights, each padded by
    the half windows on every side in ``dtype``, and the output; the
    FP64 operations of :func:`k10_flops` a pixel (K10 solves in FP64 for
    both dtypes)."""
    elements = _count(shape)
    b = _DTYPE_BYTES[_dtype_name(dtype)]
    lead = elements // (int(shape[-2]) * int(shape[-1]))
    padded = lead * (int(shape[-2]) + window_h - 1) * (
        int(shape[-1]) + window_w - 1)
    return bound(2 * b * padded + b * elements,
                 elements * k10_flops((window_w - 1) // 2,
                                      (window_h - 1) // 2, poly_order),
                 "f64", elements=elements)


def nonuniform_flops(n: int, m: int) -> dict:
    """The operations one float32 K11 output needs, by type: the design in
    float32 (pass 1's offset and max, then the offset, u/s and w*x a tap),
    and in FP64 a tap's 2m powers and its 2m+1 moment and m+1 rhs
    multiply-adds, then the plain k = m+1 solve. FP64 sums (eps 2^-53) meet
    the float32 contract, which the plain version's double-word float32
    (eps ~2^-48) sets."""
    ws = 2 * n + 1
    tap = 2 * m + 2 * (2 * m + 1) + 2 * (m + 1)
    return {"f32": 5 * ws, "f64": ws * tap + plain_chol_flops(m + 1)}


def nonuniform_dd_flops(n: int, m: int) -> int:
    """FP64 flops K11 spends on one output (nonuniform.cu, double-word for
    both dtypes): a tap's 3m+2 terms gathered (a TwoSum and two adds, the
    first term of each chain one add) and its 3m chain steps (a product and
    two fmas, the first step of each chain one fma), the 3m+2 sums
    renormalized once (a TwoSum each), then the double-word solve. Not a
    bound: the work K11 chose."""
    terms, steps = 3 * m + 2, 3 * m
    tap = terms * (DD_TWO_SUM + 2) - 2 + steps * 5 - (4 if m else 0)
    return (2 * n + 1) * tap + terms * DD_TWO_SUM + dd_chol_flops(m + 1)


def _per_sample(flops: dict, elements: int) -> dict:
    return {k: v * elements for k, v in flops.items()}


def speed_of_light_nonuniform(half_window: int, poly_order: int, *, shape,
                              dtype="float32") -> Roofline:
    """The fused nonuniform fit (K11) of ``shape`` (..., N): x, the
    weights and t in and y out, each in ``dtype``; the operations of
    :func:`nonuniform_flops` a sample."""
    elements = _count(shape)
    b = _DTYPE_BYTES[_dtype_name(dtype)]
    return bound(4 * b * elements, _per_sample(
        nonuniform_flops(half_window, poly_order), elements),
        elements=elements)


def speed_of_light_nonuniform_planes(half_window: int, poly_order: int, *,
                                     shape, dtype="float32") -> Roofline:
    """K11's planes mode (K11p) on ``shape`` (..., N) with one abscissa
    row t (N,) for all rows: x and the weights in, the m + 3 planes out,
    each in ``dtype``, and t read once; the operations of
    :func:`nonuniform_flops` a sample."""
    elements = _count(shape)
    b = _DTYPE_BYTES[_dtype_name(dtype)]
    return bound((2 + poly_order + 3) * b * elements + b * int(shape[-1]),
                 _per_sample(nonuniform_flops(half_window, poly_order),
                             elements), elements=elements)


def speed_of_light_nonuniform_dd(half_window: int, poly_order: int, *,
                                 shape) -> Roofline:
    """Not a bound of the function: the least time of the double-word work
    K11 chose (:func:`nonuniform_dd_flops` a sample of ``shape``), its
    operations alone at the FP64 peak."""
    elements = _count(shape)
    return bound(0, elements * nonuniform_dd_flops(half_window, poly_order),
                 "f64", elements=elements)


def resample_flops(m: int) -> int:
    """Operations of one K12 output: the offset and u/s, m Horner steps (a
    product by u and an add of the scaled coefficient) and the fill
    select, about 2m + 2, each counted as an FMA (two)."""
    return 2 * (2 * m + 2)


def speed_of_light_resample(poly_order: int, *, rows: int, queries: int,
                            centres: int, dtype="float32") -> Roofline:
    """K12 over ``rows`` rows and ``queries`` queries that fall in
    ``centres`` distinct windows (count them in the run's data): the m + 3
    planes of each row read at each distinct centre and t there, each
    query's int64 centre and abscissa, one output a row a query, in
    ``dtype``; :func:`resample_flops` an output."""
    b = _DTYPE_BYTES[_dtype_name(dtype)]
    outputs = rows * queries
    return bound((poly_order + 3) * b * rows * centres + b * centres
                 + (8 + b) * queries + b * outputs,
                 outputs * resample_flops(poly_order),
                 _kind("auto", _dtype_name(dtype)), elements=outputs)


def speed_of_light_halo(ranks: int, halo_shape, *, dtype="float32"
                        ) -> Roofline:
    """One ring halo exchange (K13) over ``ranks`` ranks, each side's halo
    of ``halo_shape`` on each rank: a rank's two outgoing halos read and
    its two incoming ones written; no operations."""
    b = _DTYPE_BYTES[_dtype_name(dtype)]
    return bound(ranks * 4 * b * _count(halo_shape), 0)
