"""``correct`` on the CPU at small sizes: a run of the program comes out
correct; the control (the reference computed one precision down, in the
program's place) and every fault a cell can have (an answer altered where
it is produced, half of a call's batch left out, a NaN written) come out
not correct, with a result line that is still strict JSON.
The rest of a run as the card runs it: the closed loop, the reservoir of
kept calls, the check and the result line."""

import json
import subprocess
import sys

import pytest
import torch

from gpubench import harness
from gpubench.tests.conftest import CELLS, ROOT, small

CPU = torch.device("cpu")


def broken(cell, fault):
    """The cell's call with ``fault`` planted under it (None: sound)."""
    if fault == "control":
        state = cell.reference.control_state(cell.config, CPU)
        return lambda x: cell.reference.control(state, x, cell.config)
    program = cell.entry.make(cell.config, CPU)

    def call(x):
        y = cell.entry.call(program, x)
        if fault == "answer_altered":
            y.view(-1)[y.numel() // 3] += 1e-4
        elif fault == "half_batch_left_out":
            y[y.shape[0] // 2:] = 0.0
        elif fault == "nan_out":
            y.view(-1)[-1] = float("nan")
        return y
    return call


@pytest.mark.parametrize("fault", [None, "control", "answer_altered",
                                   "half_batch_left_out", "nan_out"])
@pytest.mark.parametrize("name", CELLS)
def test_correct_only_for_the_sound_program(name, fault, capsys):
    cell = small(name)
    r = harness.run(cell, 2 ** 31 + 17, 0.05, False, CPU,
                    call=broken(cell, fault), emit=lambda obj: None)
    assert r["correct"] is (fault is None), r["check"]
    json.loads(json.dumps(r, allow_nan=False))
    assert r["attempted"] > 0 and list(r)[-1] == "check"
    assert set(r["check"]) == set(cell.config["limits"])
    assert (r["failed"] == 0) is (fault is None)
    err = capsys.readouterr().err.strip().splitlines()
    assert [ln.split()[1] for ln in err[-len(r["check"]):]] == list(r["check"])


def test_the_same_seed_makes_the_same_inputs():
    cell = small("sg1d-bulk")
    a, b, c = (cell.reference.make_data((4, 512), cell.config, s, CPU)
               for s in (2 ** 31 + 5, 2 ** 31 + 5, 2 ** 31 + 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_closed_loop_keeps_inflight_and_a_reservoir():
    calls = []
    views = [torch.full((2, 3), float(b)) for b in range(5)]
    loop = harness.Loop(lambda x: calls.append(x) or x * 2, views, 3, CPU,
                        first_block=7)
    w = loop.run(calls=11, keep=2, rng=__import__("random").Random(1))
    assert w.calls == 11 == len(w.latency_s) == len(w.host_s)
    assert [int(x[0, 0]) for x in calls[:4]] == [2, 3, 4, 0]
    assert len(w.kept) == 2 and all(torch.equal(y, x * 2) for x, y in w.kept)


def test_run_exits_without_a_result_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                        "sg1d-bulk", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 2 and p.stdout == ""


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                        "sg2d-frames", "--seed", str(2 ** 31 + 99),
                        "--seconds", "1", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
    assert 0 < r["metrics"]["roofline.sg2d"]["value"] <= 100
