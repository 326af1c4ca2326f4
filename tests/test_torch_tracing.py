"""The port's spans (``savgol_tpu_torch/tracing.py``): on exactly while a
``torch.profiler`` session records, nothing made while none does, one
outermost ``savgol.apply`` a public call in the caller's own trace, every
span name in ``tracing.SPANS``, and every kernel launch both counted and
spanned (``ops.cuda_conv._enqueue``).

The CPU cases run the kernel route's Python with a stand-in library (a
CUDA tensor's route taken by a CPU tensor, the foreign call faked), so the
spans' nesting is checked here; the ``cuda`` cases check the real launches
on the card (the exact K1 and K7, and a ``method="bf16"`` call's tap casts
and K1-bf16). The scipy entry's spans (``savgol.apply``, the weights'
``savgol.taps`` and the host pad's ``savgol.pad``) are checked on its CPU
route."""

import contextlib
import json
import pathlib
import re
import types

import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch import tracing
from savgol_tpu_torch.ops import cuda_conv, cuda_conv2d
from savgol_tpu_torch.scipy_compat import savgol_filter
from savgol_tpu_torch.utils import profiling

PACKAGE = pathlib.Path(sgt.__file__).resolve().parent
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def filters():
    return (sgt.Savgol1D.create(sgt.SavgolConfig(12, 4), device="cpu"),
            sgt.Savgol2D.create(sgt.Savgol2DConfig(5, 5, 3), device="cpu"))


def _entries(filters, complex_input):
    """The four public entry points, each a call on small CPU inputs."""
    f1, f2 = filters
    g = torch.Generator().manual_seed(7)
    dt = torch.complex64 if complex_input else torch.float32

    def rand(*shape):
        return torch.randn(*shape, generator=g, dtype=dt)

    x, img = rand(3, 64), rand(2, 24, 20)
    cw, ew, w = f1.center_weights, f1.edge_weights, f2.weights
    return {
        "savgol_apply": lambda: sgt.savgol_apply(x, cw, ew, half_window=12),
        "savgol_apply_valid": lambda: sgt.savgol_apply_valid(
            x, cw, half_window=12),
        "savgol2d_apply": lambda: sgt.savgol2d_apply(img, w),
        "savgol2d_apply_stack": lambda: sgt.savgol2d_apply_stack(
            img, torch.stack([w, 2 * w])),
    }


def _annotations(prof, tmp_path) -> list[dict]:
    """The exported Chrome trace's ``record_function`` ranges, in order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"),
                  key=lambda e: (e["ts"], -e["dur"]))


def _inside(inner: dict, outer: dict, eps: float = 1e-2) -> bool:
    """``inner`` within ``outer``, to ``eps`` us (the sums of the trace's
    microsecond floats round)."""
    return (outer["ts"] - eps <= inner["ts"] and inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"] + eps)


def _outermost(spans: list[dict]) -> list[dict]:
    return [s for s in spans
            if not any(o is not s and _inside(s, o) for o in spans)]


class _Counting(torch.profiler.record_function):
    made = 0

    def __init__(self, *args, **kwargs):
        type(self).made += 1
        super().__init__(*args, **kwargs)


@pytest.fixture
def counting(monkeypatch):
    """``torch.profiler.record_function`` replaced by a subclass that
    counts its constructions."""
    _Counting.made = 0
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    return _Counting


class _Library:
    """A stand-in for the kernel library: every entry returns ``code`` and
    records its name, inside a ``foreign call`` range while a profiler
    records."""

    def __init__(self, code=0):
        self.code, self.called = code, []

    def __getattr__(self, symbol):
        def entry(*args):
            self.called.append(symbol)
            if tracing.on():
                with torch.profiler.record_function("foreign call"):
                    return self.code
            return self.code
        return entry


@pytest.fixture
def kernel_route(monkeypatch):
    """CPU tensors take the kernel route of K1 / K2 / K3 and K2D-dense to
    a stand-in library; returns the library."""
    lib = _Library()
    monkeypatch.setattr(cuda_conv, "library", lambda: lib)
    for mod in (cuda_conv, cuda_conv2d):
        monkeypatch.setattr(mod, "_plain_or_cuda", lambda x, name: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib


def test_the_gate_follows_the_profiler():
    assert not tracing.on()
    with torch.profiler.profile(activities=CPU):
        assert tracing.on()
    assert not tracing.on()


@pytest.mark.parametrize("module", ["Savgol1D", "Savgol2D"])
def test_no_record_function_is_made_without_a_profiler(filters, counting,
                                                       module):
    f = filters[module == "Savgol2D"]
    x = torch.randn(3, 64) if module == "Savgol1D" else torch.randn(2, 24, 20)
    for _ in range(3):
        f.apply(x)
    assert counting.made == 0
    # the same calls under a profiler make the spans through the counter
    with torch.profiler.profile(activities=CPU):
        f.apply(x)
    assert counting.made >= 1


@pytest.mark.parametrize("module", ["Savgol1D", "Savgol2D"])
def test_the_kernel_route_makes_no_record_function_without_a_profiler(
        filters, counting, kernel_route, module):
    f = filters[module == "Savgol2D"]
    x = torch.randn(3, 64) if module == "Savgol1D" else torch.randn(2, 24, 20)
    f.apply(x)
    assert kernel_route.called and counting.made == 0


@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("entry", ["savgol_apply", "savgol_apply_valid",
                                   "savgol2d_apply", "savgol2d_apply_stack"])
def test_each_entry_gives_one_outermost_apply_in_the_callers_span(
        filters, tmp_path, entry, complex_input):
    call = _entries(filters, complex_input)[entry]
    with torch.profiler.profile(activities=CPU) as prof:
        with torch.profiler.record_function("caller"):
            call()
    spans = _annotations(prof, tmp_path)
    caller, = [s for s in spans if s["name"] == "caller"]
    applies = [s for s in spans if s["name"] == "savgol.apply"]
    # the complex route of the entries that recurse through themselves
    # nests a second savgol.apply in the first (savgol_apply recurses
    # through savgol_apply_core)
    nests = complex_input and entry != "savgol_apply"
    assert len(applies) == (2 if nests else 1)
    assert len(_outermost(applies)) == 1
    ours = [s for s in spans if s["name"].startswith("savgol.")]
    assert all(_inside(s, caller) for s in ours)
    assert all(_inside(s, _outermost(applies)[0]) for s in ours)


@pytest.mark.parametrize("module, taps", [("Savgol1D", 1), ("Savgol2D", 2)])
def test_the_kernel_route_spans_taps_then_launch_inside_apply(
        filters, tmp_path, kernel_route, module, taps):
    f = filters[module == "Savgol2D"]
    x = torch.randn(3, 64) if module == "Savgol1D" else torch.randn(2, 24, 20)
    key = "sg1d_poly" if module == "Savgol1D" else "corr2d_valid"
    counts = cuda_conv.LAUNCHES if module == "Savgol1D" else \
        cuda_conv2d.LAUNCHES
    before = counts[key]
    with torch.profiler.profile(activities=CPU) as prof:
        f.apply(x)
    assert counts[key] == before + 1
    spans = _annotations(prof, tmp_path)
    apply_, = [s for s in spans if s["name"] == "savgol.apply"]
    tap_spans = [s for s in spans if s["name"] == "savgol.taps"]
    launch, = [s for s in spans if s["name"] == "savgol.launch"]
    foreign, = [s for s in spans if s["name"] == "foreign call"]
    assert len(tap_spans) == taps
    assert all(_inside(s, apply_) for s in tap_spans + [launch])
    assert _inside(foreign, launch)
    assert all(s["ts"] + s["dur"] <= launch["ts"] for s in tap_spans)


def test_a_bf16_call_casts_its_taps_in_taps_and_launches_in_launch(
        filters, tmp_path, kernel_route):
    # method="bf16" on bf16 storage: the two tap tensors rounded to bf16
    # and back (four copies, cuda_conv.bf16_taps) inside savgol.taps, K1's
    # bf16 entry inside savgol.launch, both in one outermost savgol.apply,
    # and no copy of the call outside savgol.taps
    f = filters[0]
    x = torch.randn(3, 64).to(torch.bfloat16)
    before = cuda_conv.LAUNCHES["sg1d_poly"], dict(cuda_conv.ROUNDED)
    with torch.profiler.profile(activities=CPU) as prof:
        y = f.apply(x, method="bf16")
    assert y.dtype == torch.bfloat16
    assert cuda_conv.LAUNCHES["sg1d_poly"] == before[0] + 1
    assert kernel_route.called == ["sg1d_poly_bf16"]
    assert {k: cuda_conv.ROUNDED[k] - before[1][k] for k in before[1]} == {
        "taps": 2, "storage": 0}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    applies = [s for s in spans if s["name"] == "savgol.apply"]
    apply_, = _outermost(applies)
    taps, = [s for s in spans if s["name"] == "savgol.taps"]
    launch, = [s for s in spans if s["name"] == "savgol.launch"]
    foreign, = [s for s in spans if s["name"] == "foreign call"]
    copies = [e for e in events if e.get("cat") == "cpu_op"
              and e["name"] == "aten::copy_" and _inside(e, apply_)]
    assert len(applies) == 1
    assert _inside(taps, apply_) and _inside(launch, apply_)
    assert _inside(foreign, launch)
    assert len(copies) == 4 and all(_inside(c, taps) for c in copies)


@pytest.mark.parametrize("mode, pads", [("mirror", 1), ("constant", 1),
                                        ("interp", 0)])
def test_the_scipy_entry_spans_its_weights_and_its_pad(tmp_path, mode, pads):
    with torch.profiler.profile(activities=CPU) as prof:
        savgol_filter(torch.randn(3, 100), 25, 4, mode=mode)
    spans = [s for s in _annotations(prof, tmp_path)
             if s["name"].startswith("savgol.")]
    apply_, = [s for s in spans if s["name"] == "savgol.apply"]
    names = sorted(s["name"] for s in spans if s is not apply_)
    assert names == ["savgol.pad"] * pads + ["savgol.taps"]
    assert all(_inside(s, apply_) for s in spans)


def test_a_failed_launch_raises_counts_nothing_and_closes_its_span(
        tmp_path, kernel_route):
    kernel_route.code = 1
    counts = {"k": 0}
    with torch.profiler.profile(activities=CPU) as prof:
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            cuda_conv._enqueue("k_cuda", counts, "k", torch.device("cpu"),
                               "k_f32", 1, 2)
    assert counts == {"k": 0} and kernel_route.called == ["k_f32"]
    launch, = [s for s in _annotations(prof, tmp_path)
               if s["name"] == "savgol.launch"]
    assert launch["dur"] >= 0


def _package_sources():
    return {p.relative_to(PACKAGE).as_posix(): p.read_text()
            for p in PACKAGE.rglob("*.py")}


def test_every_span_the_package_opens_is_named_in_spans():
    opened = {name for text in _package_sources().values()
              for name in re.findall(r'tracing\.begin\(\s*"([^"]+)"', text)}
    assert opened == set(tracing.SPANS)
    # record_function is made only by tracing.py, and by the trace_loss
    # probe around the calls it measures (its own annotation, no span)
    direct = sorted(path for path, text in _package_sources().items()
                    if "record_function(" in text)
    assert direct == ["probes/trace_loss.py", "tracing.py"]


def test_every_launch_count_is_made_where_the_launch_is_spanned():
    bump = re.compile(r"(?:LAUNCHES\[[^\]]*\]|counts\[key\])\s*\+=")
    bumps = {path: bump.findall(text)
             for path, text in _package_sources().items()}
    assert {p: b for p, b in bumps.items() if b} == {
        "ops/cuda_conv.py": ["counts[key] +="]}
    body = re.search(r"def _enqueue\(.*?\n\n\n", _package_sources()
                     ["ops/cuda_conv.py"], re.S).group(0)
    assert 'tracing.begin("savgol.launch")' in body
    assert "counts[key] += 1" in body


@pytest.mark.cuda
def test_cuda_every_kernel_launch_of_a_traced_call_is_in_a_launch_span(
        cuda, tmp_path):
    f1 = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4), device=cuda)
    f2 = sgt.Savgol2D.create(sgt.Savgol2DConfig(5, 5, 3), device=cuda)
    x = torch.randn(8, 1 << 16, device=cuda)
    # a batch whose K2D-sep launch fills the card: f2's rank-2 stencil
    # takes K2D-sep (ops/apply2d.py _sep_cheaper)
    img = torch.randn(8, 2048, 2048, device=cuda)
    f1.apply(x)                          # build and load the library
    f2.apply(img)
    torch.cuda.synchronize()
    before = (cuda_conv.LAUNCHES["sg1d_poly"],
              cuda_conv2d.LAUNCHES["corr2d_sep"])

    def run():
        for _ in range(3):
            f1.apply(x)
            f2.apply(img)
        torch.cuda.synchronize()

    events, takes = profiling.trace_events(run, str(tmp_path))
    deltas = (cuda_conv.LAUNCHES["sg1d_poly"] - before[0],
              cuda_conv2d.LAUNCHES["corr2d_sep"] - before[1])
    launches = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("ph") == "X"
                      and e.get("cat") == "user_annotation"
                      and e.get("name") == "savgol.launch")
    ops = profiling.device_events(events)
    k1 = [e for e in ops if "sg1d_poly" in e["name"]]
    k2d = [e for e in ops if "corr2d_sep" in e["name"]]
    # the last take's kernels; a retaken session ran run() again
    assert (len(k1), len(k2d)) == (3, 3) and deltas == (3 * takes,) * 2
    assert not [e for e in ops if "corr2d_valid" in e["name"]]
    spanned = {id(e) for w in launches
               for e in profiling.device_events(events, w)}
    assert all(id(e) in spanned for e in k1 + k2d)
    assert len(launches) == 6


@pytest.mark.cuda
def test_cuda_every_operation_of_a_traced_bf16_call_lies_in_a_span(
        cuda, tmp_path):
    # method="bf16" on bf16 storage: the tap casts launched inside
    # savgol.taps, K1-bf16 inside savgol.launch, nothing of the call
    # outside savgol.apply; one sg1d_poly launch a call
    f1 = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4), device=cuda)
    x = torch.randn(64, 1 << 16, device=cuda).to(torch.bfloat16)
    f1.apply(x, method="bf16")           # build and load the library
    torch.cuda.synchronize()
    before = cuda_conv.LAUNCHES["sg1d_poly"]

    def run():
        f1.apply(x, method="bf16")
        torch.cuda.synchronize()

    events, takes = profiling.trace_events(run, str(tmp_path))
    assert cuda_conv.LAUNCHES["sg1d_poly"] - before == takes

    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("ph") == "X"
                      and e.get("cat") == "user_annotation"
                      and e.get("name") == name)

    def launched(name):
        return [e for w in spans(name)
                for e in profiling.device_events(events, w)]

    ops = profiling.device_events(events)
    in_apply, in_launch = launched("savgol.apply"), launched("savgol.launch")
    casts = launched("savgol.taps")
    assert len(spans("savgol.apply")) == 1
    assert sorted(map(id, in_apply)) == sorted(map(id, ops))
    assert len(in_launch) == 1 and "sg1d_bf16" in in_launch[0]["name"]
    assert len(casts) == 4 and len(ops) == 5
