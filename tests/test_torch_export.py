"""The port's coefficient exporter and its command line against the JAX
package's: ``savgol_tpu_torch.utils.export.generate_header`` must give
``savgol_tpu.utils.export.generate_header``'s text line by line at a fixed
timestamp, but for the "Generated by" line, which names the port;
``savgol_tpu_torch.cli.main`` the same exit codes, standard output,
standard error and files as ``savgol_tpu.cli.main``; and a generated
header, compiled with gcc, the port's ``Savgol1D.apply`` on the CPU within
2e-6 scaled (the header's f32 tables and f32 sums against f64).
"""

import ctypes
import subprocess
import sys

import numpy as np
import pytest
import torch

import savgol_tpu as sg
from savgol_tpu.cli import main as jax_main
from savgol_tpu.utils.export import generate_header as jax_header
import savgol_tpu_torch as sgt
from savgol_tpu_torch.cli import build_parser, main
from savgol_tpu_torch.utils.export import generate_header

STAMP = "2026-01-02 03:04:05"
GENERATED = " * Generated by savgol_tpu export on "
CONFIGS = [
    (dict(half_window=5, poly_order=2, derivative=1), "SAVGOL"),
    (dict(half_window=3, poly_order=2), "myfilt"),
    (dict(half_window=2, poly_order=2), "SAVGOL"),
    (dict(half_window=8, poly_order=3, derivative=1, time_step=0.25), "DV"),
    (dict(half_window=12, poly_order=4, derivative=2, time_step=0.01),
     "Accel"),
    (dict(half_window=32, poly_order=10, derivative=2, time_step=3.0), "W"),
]


def _same_but_generated_line(ours: str, theirs: str) -> None:
    a, b = ours.splitlines(), theirs.splitlines()
    assert len(a) == len(b)
    differ = [i for i, (u, v) in enumerate(zip(a, b)) if u != v]
    assert len(differ) == 1
    i = differ[0]
    assert b[i].startswith(GENERATED)
    assert a[i] == b[i].replace("savgol_tpu export",
                                "savgol_tpu_torch export")
    assert ours.endswith("\n") and theirs.endswith("\n")


@pytest.mark.parametrize("cfg,prefix", CONFIGS, ids=str)
def test_header_matches_jax_but_generated_line(cfg, prefix):
    ours = generate_header(sgt.SavgolConfig(**cfg), prefix=prefix,
                           timestamp=STAMP)
    theirs = jax_header(sg.SavgolConfig(**cfg), prefix=prefix,
                        timestamp=STAMP)
    _same_but_generated_line(ours, theirs)
    assert f"savgol_tpu_torch export on {STAMP}" in ours
    assert ("_TIME_STEP" in ours) == (cfg.get("time_step", 1.0) != 1.0
                                      and cfg.get("derivative", 0) > 0)


def _run(fn, argv, capsys):
    code = fn(argv)
    out = capsys.readouterr()
    return code, out.out, out.err


def _normalised(text: str) -> str:
    """The header's timestamp (the two runs' clocks differ) and the
    "Generated by" line's package name taken out."""
    return "\n".join(" * Generated by" if line.startswith(" * Generated by")
                     else line for line in text.splitlines())


@pytest.mark.parametrize("argv", [
    ["-n", "5", "-m", "2"],
    ["--half-window", "3", "--poly-order", "2", "--derivative", "0",
     "--prefix", "LF"],
    ["-n", "0", "-m", "2"],
    ["-n", "4", "-m", "5"],
    ["-n", "4", "-m", "2", "-d", "3"],
    ["-n", "32", "-m", "10", "-d", "4", "-p", "Big"],
], ids=" ".join)
def test_cli_stdout_matches_jax(argv, capsys):
    code, out, err = _run(main, argv, capsys)
    jcode, jout, jerr = _run(jax_main, argv, capsys)
    assert code == jcode and err == jerr
    assert _normalised(out) == _normalised(jout)
    assert (code == 0) == bool(out)


def test_cli_output_file_matches_jax(tmp_path, capsys):
    argv = ["-n", "4", "-m", "3", "-d", "1", "-p", "DV", "-o"]
    code, out, err = _run(main, argv + [str(tmp_path / "a.h")], capsys)
    jcode, jout, jerr = _run(jax_main, argv + [str(tmp_path / "b.h")],
                             capsys)
    assert code == jcode == 0 and out == jout == ""
    assert err.replace("a.h", "b.h") == jerr and "Generated:" in err
    assert _normalised((tmp_path / "a.h").read_text()) == _normalised(
        (tmp_path / "b.h").read_text())


@pytest.mark.parametrize("argv", [[], ["-n", "3"], ["-n", "x", "-m", "2"],
                                  ["--help"]], ids=" ".join)
def test_cli_argument_errors_match_jax(argv, capsys):
    with pytest.raises(SystemExit) as ours:
        main(argv)
    out = capsys.readouterr()
    with pytest.raises(SystemExit) as theirs:
        jax_main(argv)
    jout = capsys.readouterr()
    assert ours.value.code == theirs.value.code
    assert (out.out, out.err) == (jout.out, jout.err)
    assert build_parser().prog == "savgol-export"


def test_cli_runs_as_a_module():
    run = subprocess.run([sys.executable, "-m", "savgol_tpu_torch.cli",
                          "-n", "2", "-m", "2", "-p", "M"],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and "M_EDGE_WEIGHTS[2][5]" in run.stdout
    bad = subprocess.run([sys.executable, "-m", "savgol_tpu_torch.cli",
                          "-n", "40", "-m", "2"], capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode == 1 and bad.stderr.startswith("Error: ")


@pytest.mark.parametrize("cfg", [
    dict(half_window=5, poly_order=2),
    dict(half_window=8, poly_order=3, derivative=1),
    dict(half_window=5, poly_order=3, derivative=1, time_step=0.01),
    dict(half_window=12, poly_order=4, derivative=2, time_step=0.5),
], ids=str)
def test_generated_header_executes_like_the_port(tmp_path, cfg):
    """The header's inline apply, compiled with gcc, against the port's
    ``Savgol1D.apply`` in f64 on the CPU (reference edge sign: the
    generated C applies the leading edge over reversed data like the
    reference)."""
    config = sgt.SavgolConfig(**cfg)
    (tmp_path / "coeffs.h").write_text(generate_header(config, prefix="GEN"))
    caller = tmp_path / "caller.c"
    caller.write_text('#include "coeffs.h"\n'
                      "void run(const float *in, float *out, int length) "
                      "{ GEN_apply(in, out, length); }\n")
    so = tmp_path / "gen.so"
    subprocess.run(["gcc", "-O2", "-std=c99", "-shared", "-fPIC",
                    str(caller), "-o", str(so)], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.run.argtypes = [f32p, f32p, ctypes.c_int]
    lib.run.restype = None
    x = np.random.default_rng(5).standard_normal(300).astype(np.float32)
    out = np.empty_like(x)
    lib.run(x.ctypes.data_as(f32p), out.ctypes.data_as(f32p), x.size)
    f = sgt.Savgol1D.create(config, dtype=torch.float64, device="cpu")
    ours = f.apply(torch.from_numpy(x).double(),
                   reference_edge_sign=True).numpy()
    scale = max(1.0, float(np.abs(ours).max()))
    assert np.abs(out - ours).max() <= 2e-6 * scale
