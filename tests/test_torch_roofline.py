"""The port's cost model of the H100 (``savgol_tpu_torch.utils.roofline``):
its bounds pinned to the bound column of ``PERF.md``'s kernel table, to
the digits written there (the data sheet's rates, derived), at the shapes
``chip_smoke.py`` gives each function; its errors as
``savgol_tpu.utils.roofline``'s (``tests/test_profiling.py``); and the one
home of the bounds: ``chip_smoke.py``, ``utils/timing.py`` and the probes
reach a bound only through a ``speed_of_light_*`` function.
"""

import ast
import importlib.util
import pathlib
import subprocess
import sys

import pytest

from savgol_tpu_torch.utils import roofline as rl

ROOT = pathlib.Path(__file__).resolve().parents[1]
HEAD_1D = (128, 1 << 20)
HEAD_2D = (16, 2048, 2048)
SWEEP_NS = (4, 8, 12, 16, 24, 32)
# the distinct window centres of chip_smoke.py's resample queries (its
# phase 20 data, counted on the card)
K12_CENTRES = 114_730

# (what, roofline, PERF.md's bound as written, its "by")
PINS = [
    ("K1 headline", lambda: rl.speed_of_light_1d(HEAD_1D), "0.321",
     "bytes"),
    ("K1 ws = 101", lambda: rl.speed_of_light_1d(HEAD_1D, half_window=50),
     "0.405", "operations"),
    ("K1 f64", lambda: rl.speed_of_light_1d(HEAD_1D, dtype="float64"),
     "0.641", "bytes"),
    ("K1 f64 ws = 101", lambda: rl.speed_of_light_1d(
        HEAD_1D, dtype="float64", half_window=50), "0.797", "operations"),
    ("K3 headline", lambda: rl.speed_of_light_valid_1d(HEAD_1D), "0.321",
     "bytes"),
    ("K3 f64", lambda: rl.speed_of_light_valid_1d(HEAD_1D, dtype="float64"),
     "0.641", "bytes"),
    ("P1", lambda: rl.speed_of_light_valid_1d((128, (1 << 20) + 24)),
     "0.3205", "bytes"),
    ("K4 bank", lambda: rl.speed_of_light_bank_1d((12,) * 3, shape=HEAD_1D),
     "0.641", "bytes"),
    ("K4 bank f64", lambda: rl.speed_of_light_bank_1d(
        (12,) * 3, shape=HEAD_1D, dtype="float64"), "1.282", "bytes"),
    ("K4 sweep 4M", lambda: rl.speed_of_light_bank_1d(
        SWEEP_NS, shape=(4_194_304,)), "0.0351", "bytes"),
    ("K4 sweep headline", lambda: rl.speed_of_light_bank_1d(
        SWEEP_NS, shape=HEAD_1D), "1.122", "bytes"),
    ("K5/K6a 11x11", lambda: rl.speed_of_light_2d(11, shape=HEAD_2D),
     "0.242", "operations"),
    ("K6b Hessian stack", lambda: rl.speed_of_light_bank_2d(
        11, 3, shape=HEAD_2D), "0.727", "operations"),
    ("K7 11x11 rank 1", lambda: rl.speed_of_light_separable_2d(
        11, 1, shape=HEAD_2D), "0.160", "bytes"),
    ("K7 21x21 rank 3", lambda: rl.speed_of_light_separable_2d(
        21, 3, shape=HEAD_2D), "0.252", "operations"),
    ("K8a", lambda: rl.speed_of_light_plane_solve(10, positions=1 << 20),
     "0.0945", "bytes"),
    ("K8b", lambda: rl.speed_of_light_plane_solve_dd(
        5, positions=8 * 131_072), "0.057", "bytes"),
    ("K9", lambda: rl.speed_of_light_masked_1d(4, shape=(64, 131_072)),
     "0.1847", "operations"),
    ("K10", lambda: rl.speed_of_light_masked_2d(11, 11, 3,
                                                 shape=(1024, 1024)),
     "0.1031", "operations"),
    ("K11", lambda: rl.speed_of_light_nonuniform(12, 4, shape=(8, 131_072)),
     "0.0331", "operations"),
    ("K11p", lambda: rl.speed_of_light_nonuniform_planes(
        12, 4, shape=(8, 131_072)), "0.0331", "operations"),
    ("K12", lambda: rl.speed_of_light_resample(
        4, rows=8, queries=131_072, centres=K12_CENTRES), "0.0095", "bytes"),
    ("K13", lambda: rl.speed_of_light_halo(4, (128, 12)), "2.9e-5",
     "bytes"),
    ("K13 rows", lambda: rl.speed_of_light_halo(4, (16, 5, 2048)), "3.1e-3",
     "bytes"),
    ("K1-bf16", lambda: rl.speed_of_light_1d(
        HEAD_1D, dtype="bfloat16", method="bf16"), "0.160", "bytes"),
    ("K1-bf16 f32 storage", lambda: rl.speed_of_light_1d(
        HEAD_1D, method="bf16"), "0.321", "bytes"),
    ("K3-bf16", lambda: rl.speed_of_light_valid_1d(
        HEAD_1D, dtype="bfloat16", method="bf16"), "0.160", "bytes"),
    ("K6a-bf16", lambda: rl.speed_of_light_2d(
        11, shape=HEAD_2D, dtype="bfloat16", method="bf16"), "0.080",
     "bytes"),
    ("K6a-bf16 f32 storage", lambda: rl.speed_of_light_2d(
        11, shape=HEAD_2D, method="bf16"), "0.160", "bytes"),
    ("K6b-bf16", lambda: rl.speed_of_light_bank_2d(
        11, 3, shape=HEAD_2D, dtype="bfloat16", method="bf16"), "0.160",
     "bytes"),
]


def _as_written(value: float, text: str) -> str:
    """``value`` to the digits of ``text`` (fixed or exponent form)."""
    if "e" in text:
        mant, exp = text.split("e")
        digits = len(mant.split(".")[1])
        return f"{value / 10 ** int(exp):.{digits}f}e{exp}"
    return f"{value:.{len(text.split('.')[1])}f}"


@pytest.mark.parametrize("what,make,ms,by", PINS, ids=[p[0] for p in PINS])
def test_speed_of_light_pinned_to_perf(what, make, ms, by):
    r = make()
    assert _as_written(r.ceiling_s * 1e3, ms) == ms
    assert r.bound == by
    assert r.fields == {"bound_ms": r.ceiling_s * 1e3, "bound_by": by}


def test_bound_adds_the_times_of_each_type():
    r = rl.bound(3.35e9, {"f32": 67e9, "f64": 34e9})
    assert r.hbm_bound_s == pytest.approx(1e-3)
    assert r.ops_bound_s == pytest.approx(2e-3)
    assert r.fields == {"bound_ms": r.ops_bound_s * 1e3,
                        "bound_by": "operations"}
    assert rl.bound(8, 0).bound == "bytes"


def test_double_word_floor_counts_operations_only():
    r = rl.speed_of_light_nonuniform_dd(12, 4, shape=(8, 131_072))
    assert r.hbm_bytes == 0 and r.bound == "operations"
    assert r.flops == {"f64": 8 * 131_072 * rl.nonuniform_dd_flops(12, 4)}


def test_rates_are_the_data_sheet():
    assert rl.HBM_BPS == 3.35e12
    assert rl.PEAK_FLOPS == {"f32": 67e12, "f64": 34e12, "bf16": 989e12}


def test_describe_and_errors():
    r = rl.speed_of_light_1d((2, 1024))
    s = r.describe(measured_s=r.ceiling_s * 2)
    assert "50% of" in s and "H100" in s and "bound by bytes" in s
    with pytest.raises(ValueError, match="method"):
        rl.speed_of_light_1d((2, 1024), method="warp")
    with pytest.raises(ValueError, match="method"):
        rl.speed_of_light_2d(5, shape=(8, 8), method="sep")
    with pytest.raises(ValueError, match="dtype"):
        rl.speed_of_light_1d((2, 1024), dtype="int8")
    with pytest.raises(ValueError, match="positive"):
        r.utilization(0.0)


def test_window_keywords_scale_the_operations():
    a = rl.speed_of_light_1d((8, 8192), half_window=12)
    b = rl.speed_of_light_1d((8, 8192), half_window=50)
    assert b.flops["f32"] / a.flops["f32"] == 101 / 25
    assert b.hbm_bytes == a.hbm_bytes
    sq = rl.speed_of_light_2d(7, shape=(64, 64))
    rect = rl.speed_of_light_2d(7, shape=(64, 64), window_w=13)
    assert sq.flops["f32"] == 2 * 49 * 64 * 64
    assert rect.flops["f32"] == 2 * 7 * 13 * 64 * 64


# what only utils/roofline.py may name: the rates, the card, the general
# constructor and the double-word constants
_ROOFLINE_ONLY = {"bound", "HBM_BPS", "PEAK_FLOPS", "H100", "ChipSpec",
                  "DD_TWO_SUM", "DD_ADD", "DD_MUL", "DD_SQRT", "DD_DIV"}
_USERS = ["chip_smoke.py", "savgol_tpu_torch/utils/timing.py"] + sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "savgol_tpu_torch/probes").glob("*.py"))


@pytest.mark.parametrize("path", _USERS)
def test_no_bound_formula_outside_the_roofline(path):
    """A bound printed beside a time comes from a ``speed_of_light_*``
    function: the file defines no flop count, names neither the rates nor
    ``bound``, holds no rate as a number, and imports from the roofline
    only its ``speed_of_light_*`` functions and flop counts (to print a
    rate of work done)."""
    tree = ast.parse((ROOT / path).read_text())
    defined = {n.name for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert not {d for d in defined if d.endswith("_flops") or d == "bound"}
    named = ({n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
             | {n.attr for n in ast.walk(tree)
                if isinstance(n, ast.Attribute)}
             | {a.asname or a.name for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) for a in n.names})
    assert not named & _ROOFLINE_ONLY
    assert not [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
                and isinstance(n.value, float) and n.value >= 1e11]
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.module and \
                n.module.endswith("utils.roofline"):
            assert all(a.name.startswith("speed_of_light_")
                       or a.name.endswith("_flops") for a in n.names)


def test_timing_by_path_imports_no_package():
    """The A/B probes load utils/timing.py by its path to time another
    checkout: that must not import this checkout's package."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('t', "
            f"{str(ROOT / 'savgol_tpu_torch/utils/timing.py')!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "print('savgol_tpu_torch' in sys.modules, "
            "callable(m.device_ms))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.split() == ["False", "True"]
    assert importlib.util.find_spec("savgol_tpu_torch.utils.roofline")
