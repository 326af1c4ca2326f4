"""``BENCHMARK.json`` and the files the harness finds by name: every
name, unit and line within the contract's limits, each cell's file naming
its configuration and traffic, and each metric's ``workloads`` list the
cells that report it."""

import json
import pathlib
import re

import pytest

from gpubench import harness, layout

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [c["name"] for c in BENCH["workloads"]]


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_paths_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert all(line(w) for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51


def test_every_name_and_unit_keeps_to_the_alphabet():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [c["traffic"] for c in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.fullmatch(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len(set(CELLS)) == len(CELLS)


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line(m["layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_file_names_its_configuration(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = layout.workload(cell)
    assert wl["name"] == cell
    assert (wl["config"], wl["traffic"], wl["why"]) == (
        entry["config"], entry["traffic"], entry["why"])
    cfg = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert cfg["file"] == f"gpubench/configs/{wl['config']}.json"
    on_file = layout.config(wl["config"])
    assert on_file["name"] == cfg["name"] and on_file["source"] == \
        cfg["source"] and on_file["reduced"] == cfg["reduced"]
    assert wl["resident"][0] % wl["per_call"] == 0


def test_each_metric_lists_the_cells_that_report_it():
    assert sorted(m["name"] for m in BENCH["per_layer"]) == \
        layout.metric_names()
    functions = {c: harness.Cell.load(c, with_entry=False).config["function"]
                 for c in CELLS}
    for m in BENCH["per_layer"]:
        want = [c for c in CELLS if not m["name"].startswith("roofline.")
                or functions[c] == m["name"].split(".", 1)[1]]
        assert m["workloads"] == want, m["name"]
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"]:
        assert "workloads" not in m       # every cell reports every one
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "throughput", "latency_p95_ms", "peak_mem_gib", "setup_s"}


def test_the_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
