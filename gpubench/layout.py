"""Where the benchmark finds each piece, by the name ``BENCHMARK.json``
gives it: a cell's traffic in ``workloads/<cell>.json``, a configuration
in ``configs/<config>.json`` with its entry into the program in
``entries/<config>.py``, the plain reference of the function a
configuration names in ``references/<function>.py``, and every per-layer
metric's reader in ``layer_metrics/<metric>.py``. Adding one is adding a
file."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from types import ModuleType

ROOT = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def _module(kind: str, name: str) -> ModuleType:
    path = ROOT / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"gpubench.{kind}.{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def entry(config_name: str) -> ModuleType:
    """The adapter that builds and calls the program (imports it)."""
    return _module("entries", config_name)


def reference(function: str) -> ModuleType:
    """The plain reference and input maker of ``function`` (imports
    nothing of the program)."""
    return _module("references", function)


def metric_names() -> list[str]:
    return sorted(p.stem for p in (ROOT / "layer_metrics").glob("*.py")
                  if not p.name.startswith("_"))


def layer_metrics() -> dict[str, ModuleType]:
    """Every per-layer metric's reader, by metric name."""
    return {n: _module("layer_metrics", n) for n in metric_names()}
