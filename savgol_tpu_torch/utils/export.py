"""Coefficient export: emit precomputed Savitzky-Golay weights as a
self-contained C header for embedded targets / FPGAs (counterpart of
``savgol_tpu.utils.export``, the same text but for its "Generated by"
line).

Functional equivalent of the reference export tool
(reference src/savgol_export.c:145-282): same header layout — config
macros, ``<PREFIX>_CENTER_WEIGHTS[window]``, ``<PREFIX>_EDGE_WEIGHTS[n][window]``
(%+.10e formatting), and a generated inline ``<prefix>_apply()`` that runs
the leading-reverse / center / trailing-forward convolution. Weights come
from the f64 host generator, so the emitted tables are *more* accurate than
the reference's f32-recurrence tables while agreeing to f32 resolution.

The generated header is valid C99; tests compile and execute it against the
port's own apply.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np

from savgol_tpu_torch.config import SavgolConfig
from savgol_tpu_torch.ops.weights import savgol_weights_np

__all__ = ["generate_header"]


def _fmt_table(vals: np.ndarray, indent: str) -> str:
    """Rows of 4 ``%+.10e`` floats, matching the reference's table style."""
    parts = []
    for i, v in enumerate(vals):
        if i % 4 == 0:
            parts.append(indent)
        parts.append(f"{v:+.10e}f")
        if i < len(vals) - 1:
            parts.append(",")
        parts.append("\n" if (i % 4 == 3 or i == len(vals) - 1) else " ")
    return "".join(parts)


def generate_header(config: SavgolConfig, prefix: str = "SAVGOL",
                    timestamp: Optional[str] = None) -> str:
    """Render the coefficient header for ``config`` as a string."""
    n = config.half_window
    m = config.poly_order
    d = config.derivative
    ws = config.window_size
    center, edge = savgol_weights_np(config, dtype=np.float64)
    # Fold the derivative's 1/time_step**d scaling into the emitted tables
    # so the generated apply() agrees with Savgol1D.apply for ANY config.
    # (The reference tool cannot receive a time_step — it hardcodes 1.0,
    # src/savgol_export.c:303-316 — so dt != 1 has no parity contract; the
    # fold is guarded to keep the dt == 1 tables bit-identical to it.)
    dt_scale = float(config.dt_scale)
    if dt_scale != 1.0:
        center = center / dt_scale
        edge = edge / dt_scale
    center = center.astype(np.float32)
    edge = edge.astype(np.float32)

    up = prefix.upper()
    guard = f"{up}_COEFFS_N{n}_M{m}_D{d}_H"
    if timestamp is None:
        timestamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")

    L = []
    L.append("/**")
    L.append(f" * @file {prefix}_coeffs_n{n}_m{m}_d{d}.h")
    L.append(" * @brief Precomputed Savitzky-Golay filter coefficients.")
    L.append(" * ")
    L.append(" * AUTO-GENERATED FILE - DO NOT EDIT")
    L.append(f" * Generated by savgol_tpu_torch export on {timestamp}")
    L.append(" * ")
    L.append(" * Configuration:")
    L.append(f" *   half_window  = {n}")
    L.append(f" *   poly_order   = {m}")
    L.append(f" *   derivative   = {d}")
    L.append(f" *   window_size  = {ws}")
    L.append(" * ")
    L.append(" * Usage:")
    L.append(f" *   #include \"{prefix}_coeffs_n{n}_m{m}_d{d}.h\"")
    L.append(" *   ")
    L.append(" *   // Apply to center samples (index n to length-n-1)")
    L.append(f" *   for (int i = {n}; i < length - {n}; i++) {{")
    L.append(" *       float sum = 0;")
    L.append(f" *       for (int k = 0; k < {ws}; k++) {{")
    L.append(f" *           sum += {up}_CENTER_WEIGHTS[k] * data[i - {n} + k];")
    L.append(" *       }")
    L.append(" *       output[i] = sum;")
    L.append(" *   }")
    L.append(" */")
    L.append("")
    L.append(f"#ifndef {guard}")
    L.append(f"#define {guard}")
    L.append("")
    L.append("/* Filter Configuration */")
    L.append(f"#define {up}_HALF_WINDOW   {n}")
    L.append(f"#define {up}_POLY_ORDER    {m}")
    L.append(f"#define {up}_DERIVATIVE    {d}")
    L.append(f"#define {up}_WINDOW_SIZE   {ws}")
    if dt_scale != 1.0:
        L.append(f"#define {up}_TIME_STEP     {config.time_step!r}f  "
                 "/* 1/dt^d already folded into the tables */")
    L.append("")
    L.append("/* Center Weights (for interior samples) */")
    L.append(f"static const float {up}_CENTER_WEIGHTS[{ws}] = {{")
    L.append(_fmt_table(center, "    ") + "};")
    L.append("")
    L.append("/* Edge Weights [edge_index][window_index] */")
    L.append("/*")
    L.append(" * edge_index 0: for first and last sample")
    L.append(f" * edge_index {n - 1}: for sample at index {n - 1} "
             f"and length-{n}-1")
    L.append(" * ")
    L.append(f" * Leading edge (i < {n}):  convolve with data[0..{ws - 1}] "
             "in REVERSE")
    L.append(f" * Trailing edge (i >= length-{n}): convolve with "
             f"data[length-{ws}..length-1] FORWARD")
    L.append(" */")
    L.append(f"static const float {up}_EDGE_WEIGHTS[{n}][{ws}] = {{")
    for e in range(n):
        L.append(f"    {{ /* edge {e} */")
        L.append(_fmt_table(edge[e], "        ") + "    }"
                 + ("," if e < n - 1 else ""))
    L.append("};")
    L.append("")
    L.append("/* Inline apply function for convenience */")
    L.append(f"static inline void {up}_apply(const float *input, "
             "float *output, int length)")
    L.append("{")
    L.append(f"    const int n = {up}_HALF_WINDOW;")
    L.append(f"    const int ws = {up}_WINDOW_SIZE;")
    L.append("    int i, k;")
    L.append("    float sum;")
    L.append("    ")
    L.append("    /* Leading edge */")
    L.append("    for (i = 0; i < n; i++) {")
    L.append("        sum = 0.0f;")
    L.append("        for (k = 0; k < ws; k++) {")
    L.append(f"            sum += {up}_EDGE_WEIGHTS[i][k] * "
             "input[ws - 1 - k];")
    L.append("        }")
    L.append("        output[i] = sum;")
    L.append("    }")
    L.append("    ")
    L.append("    /* Center region */")
    L.append("    for (i = n; i < length - n; i++) {")
    L.append("        sum = 0.0f;")
    L.append("        for (k = 0; k < ws; k++) {")
    L.append(f"            sum += {up}_CENTER_WEIGHTS[k] * "
             "input[i - n + k];")
    L.append("        }")
    L.append("        output[i] = sum;")
    L.append("    }")
    L.append("    ")
    L.append("    /* Trailing edge */")
    L.append("    for (i = 0; i < n; i++) {")
    L.append("        sum = 0.0f;")
    L.append("        for (k = 0; k < ws; k++) {")
    L.append(f"            sum += {up}_EDGE_WEIGHTS[i][k] * "
             "input[length - ws + k];")
    L.append("        }")
    L.append("        output[length - 1 - i] = sum;")
    L.append("    }")
    L.append("}")
    L.append("")
    L.append(f"#endif /* {guard} */")
    return "\n".join(L) + "\n"
