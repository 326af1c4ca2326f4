"""The port's profiling utilities (``savgol_tpu_torch.utils.profiling``) on
CPU tensors, as ``tests/test_profiling.py`` runs ``savgol_tpu``'s:
``benchmark``, the chained k-difference (same-shape bodies and a VALID
body with a re-padding feedback), ``trace``, ``trace_events`` and
``device_events``. On the card, ``chip_smoke.py`` phase 39 runs them at
the 1D headline.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from savgol_tpu.utils import profiling as jax_profiling
from savgol_tpu_torch.utils import profiling
from savgol_tpu_torch.utils.profiling import (RATIO_BAND, benchmark,
                                              benchmark_chained,
                                              device_events, trace,
                                              trace_events)


def test_benchmark_helper():
    secs, out = benchmark(lambda v: v * 2.0, torch.ones(128), iters=3,
                          warmup=1)
    assert secs > 0
    np.testing.assert_allclose(out.numpy(), 2.0)


def test_benchmark_chained_same_shape():
    """The protocol runs and reports its ratio and the k-step chain, which
    is k calls of the body, each fed the last one's output scaled."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (32, 32)).astype(np.float32))
    x = torch.ones((32, 256))

    def fn(v):
        return torch.tanh(w @ v)

    per, ratio, chain = benchmark_chained(fn, x, iters=2, k=4,
                                          return_info=True)
    assert isinstance(per, float) and isinstance(ratio, float)
    want = x
    for _ in range(4):
        want = fn(want) * 1e-3
    assert torch.equal(chain(x), want)


def test_benchmark_chained_geometry_feedback():
    """A VALID-style body (shrinking output) works with an explicit
    re-padding feedback."""
    def fn(v):
        return v[:, 2:-2] * 0.5

    def fb(y, template):
        return torch.nn.functional.pad(y, (2, 2)).to(template.dtype)

    per = benchmark_chained(fn, torch.ones((8, 128)), iters=2, k=4,
                            feedback=fb)
    assert isinstance(per, float)


def test_benchmark_chained_passes_the_rest():
    seen = []

    def fn(v, scale):
        seen.append(scale)
        return v * scale

    benchmark_chained(fn, torch.ones(16), 0.5, iters=1, k=2,
                      feedback=lambda y, t: y)
    # chains of 2 and 4 steps, each run once untimed and once timed
    assert seen == [0.5] * 12


def test_ratio_band_is_the_jax_packages():
    assert RATIO_BAND == jax_profiling.RATIO_BAND


def test_trace_context(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        with torch.profiler.record_function("traced call"):
            torch.ones(8).sum()
    path = tmp_path / "tr" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "traced call" for e in events)
    assert any(e.key == "aten::sum" for e in prof.key_averages())


def test_device_events_keeps_the_cards_operations_in_order():
    events = [
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 30, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "ts": 1, "dur": 9},
        {"ph": "X", "cat": "gpu_memset", "name": "fill", "ts": 20, "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 2},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 10, "dur": 4},
        {"ph": "X", "cat": "user_annotation", "name": "traced call",
         "ts": 0, "dur": 50},
        {"ph": "f", "name": "flow", "ts": 3},
    ]
    got = device_events(events)
    assert [e["name"] for e in got] == ["copy", "fill", "k2"]
    assert [e["cat"] for e in got] == ["gpu_memcpy", "gpu_memset", "kernel"]


def test_device_events_of_a_cpu_trace_is_empty(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert device_events(events["traceEvents"]) == []


def test_device_events_in_a_window_match_by_launch():
    # the card's clock may place an operation outside the host span it was
    # launched in: the window keeps what was launched in it, by correlation
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "traced call",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 90, "dur": 2, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 110, "dur": 2, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx",
         "ts": 120, "dur": 2, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemsetAsync",
         "ts": 130, "dur": 2, "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "before", "ts": 105, "dur": 5,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "early", "ts": 95, "dur": 5,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 160, "dur": 5,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memset", "name": "fill", "ts": 140,
         "dur": 1, "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "unmatched", "ts": 120,
         "dur": 5},
    ]
    got = device_events(events, (100, 150))
    assert [e["name"] for e in got] == ["early", "fill", "late"]
    assert [e["name"] for e in device_events(events)] == [
        "early", "before", "unmatched", "fill", "late"]
    assert device_events(events, (0, 50)) == []


def _fake_trace(takes_with_device):
    """A stand-in for ``profiling.trace`` whose n-th take holds a kernel
    when n is in ``takes_with_device``."""
    count = [0]

    @contextlib.contextmanager
    def fake(log_dir):
        count[0] += 1
        yield None
        ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::sum", "ts": 0,
               "dur": 1}]
        if count[0] in takes_with_device:
            ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": 2,
                       "dur": 1})
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "trace.json"), "w") as fh:
            json.dump({"traceEvents": ev}, fh)
    return fake


@pytest.mark.parametrize("with_device,attempts,want_takes,want_kernels", [
    ((1,), 3, 1, 1),        # the first take saw the card
    ((2,), 3, 2, 1),        # the first lost its device activity
    ((), 3, 3, 0),          # nothing on the card: every take is empty
    ((3,), 2, 2, 0),        # no more than ``attempts`` takes
])
def test_trace_events_retakes_a_trace_that_lost_the_card(
        tmp_path, monkeypatch, with_device, attempts, want_takes,
        want_kernels):
    monkeypatch.setattr(profiling, "trace", _fake_trace(with_device))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    runs = []
    events, takes = trace_events(lambda: runs.append(1),
                                 str(tmp_path / "tr"), attempts=attempts)
    assert takes == want_takes and len(runs) == want_takes
    assert len(device_events(events)) == want_kernels


def test_trace_events_on_the_cpu_takes_once(tmp_path):
    def run():
        with torch.profiler.record_function("traced call"):
            torch.ones(8).sum()

    events, takes = trace_events(run, str(tmp_path / "tr"))
    assert takes == 1
    assert any(e.get("name") == "traced call" for e in events)
    assert device_events(events) == []


def test_trace_loss_reads_a_session():
    from savgol_tpu_torch.probes.trace_loss import read
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "traced call",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 110, "dur": 2, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 120, "dur": 2, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 95, "dur": 5,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 130, "dur": 5,
         "args": {"correlation": 2}},
    ]
    r = read(events)
    assert r == {"any": True, "kernels": 2, "differs": True,
                 "lags": [-15, 10]}
    lost = read(events[:3])
    assert lost == {"any": False, "kernels": 0, "differs": False, "lags": []}
