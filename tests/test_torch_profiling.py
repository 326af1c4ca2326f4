"""The port's profiling utilities (``savgol_tpu_torch.utils.profiling``) on
CPU tensors, as ``tests/test_profiling.py`` runs ``savgol_tpu``'s:
``benchmark``, the chained k-difference (same-shape bodies and a VALID
body with a re-padding feedback) and ``trace``. On the card,
``chip_smoke.py`` phase 39 runs them at the 1D headline.
"""

import json

import numpy as np
import torch

from savgol_tpu.utils import profiling as jax_profiling
from savgol_tpu_torch.utils.profiling import (RATIO_BAND, benchmark,
                                              benchmark_chained, trace)


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
