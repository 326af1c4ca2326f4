"""The scipy ``mode="mirror"`` cell's own pieces: its plain reference
(``references/sg1d_mirror.py``) against a numpy statement of the filter
and against scipy itself, its refusals, and its two per-layer readers
(``pad_device_share``, ``roofline.sg1d_mirror``) on stand-in traces of
the port's spans."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import scipy.signal
import torch

from gpubench import layout, trace
from gpubench.tests.conftest import ROOT

CFG = layout.config("scipy_w25o4_mirror_f32")
REF = layout.reference("sg1d_mirror")
READERS = layout.layer_metrics()


def test_the_reference_loads_nothing_of_the_port():
    code = ("from gpubench import layout\n"
            "layout.reference('sg1d_mirror')\n"
            "import sys, json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"savgol_tpu_torch", "savgol_tpu", "jax", "jaxlib"}
    assert "torch" in loaded


def lsq_mirror(x: np.ndarray, n: int, m: int) -> np.ndarray:
    """Each output the constant term of the degree-m least-squares fit over
    the window centred on it of the row padded by ``np.pad``'s reflect."""
    p = np.pad(x, n, mode="reflect")
    t = np.arange(-n, n + 1, dtype=np.float64)
    A = np.vander(t, m + 1, increasing=True)
    return np.array([np.linalg.lstsq(A, p[j:j + 2 * n + 1], rcond=None)[0][0]
                     for j in range(len(x))])


@pytest.mark.parametrize("N, n", [(25, 12), (61, 12), (5, 12), (2, 3),
                                  (1, 4)])
def test_reflect_index_is_numpys_reflect(N, n):
    row = np.arange(N, dtype=np.float64)
    np.testing.assert_array_equal(REF.reflect_index(N, n),
                                  np.pad(row, n, mode="reflect"))


def test_the_reference_is_the_least_squares_filter_of_the_reflected_row():
    x = np.random.default_rng(3).standard_normal((3, 40))
    c = torch.from_numpy(REF.projection(CFG)[12])
    got = REF._apply(torch.from_numpy(x), c, 12).numpy()
    want = np.stack([lsq_mirror(row, 12, 4) for row in x])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("N", [25, 26, 37, 4096])
def test_the_reference_is_scipys_mirror_mode(N):
    x = REF.make_data((3, N), CFG, 2 ** 31 + 11 + N,
                      torch.device("cpu")).double()
    want = scipy.signal.savgol_filter(x.numpy(), 25, 4, mode="mirror")
    got = REF._apply(x, torch.as_tensor(REF.projection(CFG)[12]), 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("fault", ["altered", "nan"])
def test_an_altered_answer_and_a_nan_are_refused(fault):
    x = REF.make_data((4, 300), CFG, 2 ** 31 + 3, torch.device("cpu"))
    y = REF._apply(x, torch.as_tensor(REF.projection(CFG)[12]), 12).float()
    assert all(v <= 1e-6 for k, v in REF.compare([(x, y)], CFG).items()
               if k in CFG["limits"])
    if fault == "altered":
        y[1, 150] += 1e-4
    else:
        y[2, 3] = float("nan")
    got = REF.compare([(x, y)], CFG)
    bad = [k for k, lim in CFG["limits"].items() if not got[k] <= lim]
    assert bad == (["interior_abs_err"] if fault == "altered"
                   else ["edge_abs_err"])
    assert math.isinf(got[bad[0]]) is (fault == "nan")


def _x(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def mirror_trace(calls=3, pad_ops=(2.0, 3.0, 150.0), kernel_us=400.0,
                 mul_us=300.0, names=("index", "gather", "corr1d_valid",
                                      "mul"), pad_span=True, apply=True):
    """``calls`` enqueue spans, each a ``savgol.apply`` holding a
    ``savgol.pad`` that launches the pad's operations, a ``savgol.launch``
    that launches the kernel, then the multiply in neither."""
    ev, corr, dev_t, t = [], 0, 0.0, 1000.0

    def launch(ts, name, dur):
        nonlocal corr, dev_t
        corr += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 2.0,
                     correlation=corr))
        start = max(dev_t, ts + 1.0)
        ev.append(_x("kernel", name, start, dur, correlation=corr))
        dev_t = start + dur

    for _ in range(calls):
        ev.append(_x("user_annotation", "enqueue", t, 200.0))
        if apply:
            ev.append(_x("user_annotation", "savgol.apply", t + 5, 190.0))
        if pad_span:
            ev.append(_x("user_annotation", "savgol.pad", t + 20, 60.0))
        for k, dur in enumerate(pad_ops):
            launch(t + 25 + 10 * k, names[min(k, 1)], dur)
        ev.append(_x("user_annotation", "savgol.launch", t + 100, 20.0))
        launch(t + 105, names[2], kernel_us)
        launch(t + 150, names[3], mul_us)
        ev.append(_x("user_annotation", "wait", t + 200, 50.0))
        t += 260.0
    ev.append(_x("user_annotation", "traced window", 990.0,
                 max(t, dev_t) - 990.0 + 10.0))
    # a pad launched outside every call counts for no call
    ev += [_x("user_annotation", "savgol.pad", 10.0, 20.0),
           _x("cuda_runtime", "cudaLaunchKernel", 12.0, 2.0,
              correlation=10 ** 6),
           _x("kernel", "stray_pad", 20.0, 500.0, correlation=10 ** 6)]
    return ev


def ctx(events, function="sg1d_mirror"):
    win = trace.spans(events, "traced window")
    return {"function": function, "bound_s": 321e-6, "events": events,
            "calls": trace.spans(events, "enqueue"),
            "window": win[0] if win else None, "entry_host_s": [1e-4]}


def test_pad_share_is_the_pads_part_of_the_calls_device_time():
    got = READERS["pad_device_share"].read(ctx(mirror_trace()))
    assert got == pytest.approx(100 * 155 / (155 + 400 + 300))


def test_pad_share_reads_zero_without_a_pad_and_nothing_without_apply():
    no_pad = mirror_trace(pad_span=False)
    assert READERS["pad_device_share"].read(ctx(no_pad)) == 0.0
    no_apply = mirror_trace(apply=False)
    assert READERS["pad_device_share"].read(ctx(no_apply)) is None


@pytest.mark.parametrize("renamed", [("a", "b", "c", "d"),
                                     ("arange", "index_select_kernel",
                                      "sg1d_mirror_fused", "nothing")])
def test_the_mirror_roofline_reads_the_same_whatever_the_ops_are_named(
        renamed):
    base = READERS["roofline.sg1d_mirror"].read(ctx(mirror_trace()))
    other = READERS["roofline.sg1d_mirror"].read(
        ctx(mirror_trace(names=renamed)))
    assert base == pytest.approx(100 * 321 / 855)
    assert other == pytest.approx(base)
    assert READERS["roofline.sg1d_mirror"].read(
        ctx(mirror_trace(), function="sg1d")) is None
