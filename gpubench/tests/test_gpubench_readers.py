"""The per-layer readers on stand-in traces: the roofline shares read the
same whatever the kernels are named, operations are matched to calls by
their launch's correlation id, and a reader that finds nothing returns
nothing (never 0)."""

import pytest

from gpubench import layout, trace

READERS = layout.layer_metrics()


def stand_in(names=("sg1d_poly_kernel", "mul", "mul"), calls=4,
             call_us=100.0, op_us=(400.0, 2.0, 2.0), ahead_us=5.0):
    """A trace of ``calls`` enqueue spans in a traced window, each
    launching one operation a name with the given durations, one after
    another on the card; each operation's event placed ``ahead_us`` before
    its launch, as the profiler now and then places them."""
    ev, corr, dev_t = [], 0, 0.0
    t = 1000.0
    for c in range(calls):
        ev.append({"ph": "X", "cat": "user_annotation", "name": "enqueue",
                   "ts": t, "dur": call_us})
        for k, (name, dur) in enumerate(zip(names, op_us)):
            corr += 1
            launch = t + 10.0 + 20.0 * k
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": launch, "dur": 5.0,
                       "args": {"correlation": corr}})
            start = max(dev_t, launch - ahead_us)
            ev.append({"ph": "X", "cat": "kernel", "name": name,
                       "ts": start, "dur": dur,
                       "args": {"correlation": corr}})
            dev_t = start + dur
        ev.append({"ph": "X", "cat": "user_annotation", "name": "wait",
                   "ts": t + call_us, "dur": 50.0})
        t += call_us + 60.0
    ev.append({"ph": "X", "cat": "user_annotation", "name": "traced window",
               "ts": 990.0, "dur": max(t, dev_t) - 990.0 + 10.0})
    # an operation launched outside every span counts for no call
    ev.append({"ph": "X", "cat": "kernel", "name": "stray", "ts": 0.0,
               "dur": 50.0, "args": {"correlation": 10 ** 6}})
    return ev


def ctx(events, function="sg1d", bound_s=300e-6, host=(1e-4, 2e-4, 3e-4)):
    win = trace.spans(events, "traced window")
    return {"function": function, "bound_s": bound_s, "events": events,
            "calls": trace.spans(events, "enqueue"),
            "window": win[0] if win else None,
            "entry_host_s": list(host)}


def test_readers_are_the_metrics_benchmark_json_names():
    assert set(READERS) == {"entry_host_ms", "launches_per_call",
                            "roofline.sg1d", "roofline.sg2d",
                            "device_idle_share"}
    assert {r.UNIT for r in READERS.values()} == {"ms", "ops", "%"}


@pytest.mark.parametrize("renamed", [("k", "a", "b"),
                                     ("corr2d_valid_kernel<float, 11>",
                                      "elementwise", "x")])
def test_roofline_reads_the_same_whatever_the_kernels_are_named(renamed):
    base = READERS["roofline.sg1d"].read(ctx(stand_in()))
    other = READERS["roofline.sg1d"].read(ctx(stand_in(names=renamed)))
    # bound 300 us over 404 us of device time a call
    assert base == pytest.approx(100 * 300 / 404)
    assert other == pytest.approx(base)
    c2 = ctx(stand_in(names=renamed), function="sg2d")
    assert READERS["roofline.sg2d"].read(c2) == pytest.approx(base)
    assert READERS["roofline.sg1d"].read(c2) is None


def test_launches_idle_and_host_time():
    c = ctx(stand_in())
    assert READERS["launches_per_call"].read(c) == 3.0
    assert READERS["entry_host_ms"].read(c) == pytest.approx(0.2)
    idle = READERS["device_idle_share"].read(c)
    t0, t1 = c["window"]
    busy = 4 * 404.0
    assert idle == pytest.approx(100 * (1 - busy / (t1 - t0)))


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = [e for e in stand_in() if e["cat"] not in ("kernel",)]
    c = ctx(empty, host=())
    for name, reader in READERS.items():
        assert reader.read(c) is None, name


def test_idle_gaps_are_labelled_by_the_open_host_span():
    ops = [{"ts": 10.0, "dur": 10.0}, {"ts": 40.0, "dur": 10.0}]
    host = {"enqueue": [(0.0, 25.0)], "wait": [(28.0, 60.0)]}
    gaps = trace.idle_gaps(ops, 0.0, 60.0, host)
    assert gaps == [("enqueue", 10.0), ("enqueue", 20.0), ("wait", 10.0)]
