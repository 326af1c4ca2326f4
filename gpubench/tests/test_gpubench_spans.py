"""The readers of the program's spans (``gpubench/spans.py``) on stand-in
traces: the port's ``savgol.apply`` / ``savgol.taps`` / ``savgol.launch``
spans nested in the benchmark's ``enqueue`` spans, as a traced window of
the port records them."""

import json
import pathlib

import pytest

from gpubench import layout, spans, trace

READERS = layout.layer_metrics()
NEW = ("apply_self_ms", "taps_host_ms", "launch_host_ms",
       "glue_ops_per_call", "idle_in_apply_share")


BENCH = json.loads((pathlib.Path(__file__).resolve().parents[2]
                    / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", NEW)
def test_each_span_reader_is_a_metric_benchmark_json_names(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert READERS[name].UNIT == entry["unit"]
    assert entry["layer"] == "entry and dispatch"
    assert entry["moves"] == "throughput"
    assert entry["source"] == "device_trace"
    assert entry["workloads"] == ["sg1d-bulk", "sg2d-frames"]


def _x(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def program_trace(calls=4, glue=2, nested=False, kernel_us=400.0,
                  ahead_us=3.0, host_gap_us=0.0):
    """``calls`` enqueue spans of 100 us, 60 us apart, each holding a
    ``savgol.apply`` at +5..+90 (with ``nested`` a second inside it, as
    the complex route makes), a ``savgol.taps`` at +10..+30 launching
    ``glue`` 2-us operations, and a ``savgol.launch`` at +40..+60
    launching the kernel; then a ``wait``. The card runs the operations
    back to back, each placed ``ahead_us`` before its launch where the
    card is free (as the profiler now and then places them), and
    ``host_gap_us`` after the previous operation otherwise."""
    ev, corr, dev_t, t = [], 0, 0.0, 1000.0

    def launch(ts, name, dur):
        nonlocal corr, dev_t
        corr += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 4.0,
                     correlation=corr))
        start = max(dev_t + host_gap_us, ts - ahead_us)
        ev.append(_x("kernel", name, start, dur, correlation=corr))
        dev_t = start + dur

    for _ in range(calls):
        ev.append(_x("user_annotation", "enqueue", t, 100.0))
        ev.append(_x("user_annotation", "savgol.apply", t + 5, 85.0))
        if nested:
            ev.append(_x("user_annotation", "savgol.apply", t + 8, 80.0))
        ev.append(_x("user_annotation", "savgol.taps", t + 10, 20.0))
        for k in range(glue):
            launch(t + 12 + 8 * k, "elementwise_kernel", 2.0)
        ev.append(_x("user_annotation", "savgol.launch", t + 40, 20.0))
        launch(t + 45, "sg1d_poly_kernel", kernel_us)
        ev.append(_x("user_annotation", "wait", t + 100, 50.0))
        t += 160.0
    ev.append(_x("user_annotation", "traced window", 990.0,
                 max(t, dev_t) - 990.0 + 10.0))
    return ev


def ctx(events):
    win = trace.spans(events, "traced window")
    return {"function": "sg1d", "bound_s": 300e-6, "events": events,
            "calls": trace.spans(events, "enqueue"),
            "window": win[0] if win else None, "entry_host_s": [1e-4]}


def read(name, events):
    return READERS[name].read(ctx(events))


@pytest.mark.parametrize("nested", [False, True])
def test_self_time_excludes_the_children(nested):
    ev = program_trace(nested=nested)
    # apply 85 us, taps 20, launch 20: self 45, whatever nests inside
    assert read("apply_self_ms", ev) == pytest.approx(0.045)
    assert read("taps_host_ms", ev) == pytest.approx(0.020)
    assert read("launch_host_ms", ev) == pytest.approx(0.020)
    split = spans.host_split(ctx(ev))
    assert len(split) == 4
    assert all(c["apply"] == pytest.approx(85.0) for c in split)


def test_overlapping_children_count_once_in_self_time():
    ev = program_trace(glue=0)
    # a taps span reaching into the launch span: the union is 10..60
    for e in ev:
        if e["name"] == "savgol.taps":
            e["dur"] = 40.0
    assert read("apply_self_ms", ev) == pytest.approx(0.085 - 0.050)
    assert read("taps_host_ms", ev) == pytest.approx(0.040)


@pytest.mark.parametrize("glue", [0, 2, 3])
def test_glue_is_what_a_call_launches_outside_its_launch_spans(glue):
    ev = program_trace(glue=glue)
    assert read("glue_ops_per_call", ev) == glue
    # every operation is the call's: the kernels are in launch spans
    assert READERS["launches_per_call"].read(ctx(ev)) == glue + 1


def test_no_glue_reads_zero_not_nothing():
    got = read("glue_ops_per_call", program_trace(glue=0))
    assert got is not None and got == 0.0


def test_an_operation_launched_outside_apply_is_no_glue():
    ev = program_trace(glue=0)
    # a copy the benchmark itself launches inside enqueue, after apply
    ev += [_x("cuda_runtime", "cudaMemcpyAsync", 1095.0, 2.0,
              correlation=999),
           _x("gpu_memcpy", "Memcpy DtoD", 1500.0, 1.0, correlation=999)]
    assert read("glue_ops_per_call", ev) == 0.0
    assert READERS["launches_per_call"].read(ctx(ev)) == pytest.approx(1.25)


def test_a_trace_with_no_apply_span_reads_nothing():
    ev = [e for e in program_trace()
          if not e["name"].startswith("savgol.")]
    for name in NEW:
        assert read(name, ev) is None, name
    # the benchmark's own readers still read it
    assert READERS["launches_per_call"].read(ctx(ev)) == 3.0


def test_a_call_without_apply_is_left_out():
    ev = program_trace(calls=3, glue=1)
    first_apply = next(e for e in ev if e["name"] == "savgol.apply")
    ev.remove(first_apply)
    assert len(spans.host_split(ctx(ev))) == 2
    # the first call's operations now lie in no apply span
    assert read("glue_ops_per_call", ev) == 1.0


def test_idle_is_counted_only_for_gaps_that_begin_inside_apply():
    ops = [{"ts": 10.0, "dur": 10.0}, {"ts": 40.0, "dur": 10.0},
           {"ts": 70.0, "dur": 10.0}]
    events = ([_x("user_annotation", "traced window", 0.0, 100.0),
               _x("user_annotation", "enqueue", 0.0, 35.0),
               # apply open at 20 (gap 20..40) but not at 50 or 80
               _x("user_annotation", "savgol.apply", 15.0, 10.0),
               _x("user_annotation", "wait", 45.0, 50.0)]
              + [_x("cuda_runtime", "cudaLaunchKernel", 1.0 + i, 1.0,
                    correlation=i) for i in range(3)]
              + [_x("kernel", "k", o["ts"], o["dur"], correlation=i)
                 for i, o in enumerate(ops)])
    c = ctx(events)
    # gaps: 0..10 (enqueue), 20..40 (apply), 50..70 (wait), 80..100 (wait)
    assert READERS["device_idle_share"].read(c) == pytest.approx(70.0)
    assert read("idle_in_apply_share", events) == pytest.approx(20.0)


def test_idle_in_apply_is_part_of_the_device_idle_share():
    ev = program_trace(kernel_us=20.0, host_gap_us=30.0)
    c = ctx(ev)
    inside = READERS["idle_in_apply_share"].read(c)
    assert 0.0 < inside <= READERS["device_idle_share"].read(c)
    # the card kept busy from the first kernel on: no gap begins in apply
    assert read("idle_in_apply_share", program_trace(glue=0)) == 0.0


def test_union_keeps_the_outermost_of_nested_spans():
    assert spans.union([(5.0, 9.0), (0.0, 10.0), (12.0, 13.0),
                        (12.5, 14.0)]) == [(0.0, 10.0), (12.0, 14.0)]
