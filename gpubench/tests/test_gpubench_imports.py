"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the port (checked in fresh processes, by each
loaded module's top-level name compared whole: ``savgol_tpu_torch`` begins
with ``savgol_tpu``)."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_every_file_found_by_name_load_no_jax():
    loaded = _loaded(
        "from gpubench import harness, layout, run, control\n"
        "for w in layout.ROOT.joinpath('workloads').glob('*.json'):\n"
        "    harness.Cell.load(w.stem)\n"
        "layout.layer_metrics()")
    assert "savgol_tpu_torch" in loaded          # the entries did load
    assert not loaded & {"jax", "jaxlib", "flax", "savgol_tpu"}


def test_references_load_nothing_of_the_port():
    loaded = _loaded(
        "from gpubench import layout\n"
        "for c in layout.ROOT.joinpath('configs').glob('*.json'):\n"
        "    layout.reference(layout.config(c.stem)['function'])")
    assert not loaded & {"savgol_tpu_torch", "savgol_tpu", "jax", "jaxlib"}
    assert "torch" in loaded


def test_forbidden_modules_compares_whole_names():
    from gpubench import harness
    assert harness.forbidden_modules(
        ["savgol_tpu_torch", "savgol_tpu_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden_modules(
        ["savgol_tpu.config", "jax.numpy", "flax"]) == [
            "flax", "jax", "savgol_tpu"]
