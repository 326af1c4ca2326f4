"""The derivative scale's one rule (``ops.cuda_conv.scale_of``): what
``dt_inv`` (1D) or ``scale`` (2D) reaches a result as, when a tensor is read
on the host, that every route takes "no scale" at an exact 1 and gives the
bits of a multiply by 1, and, on the card, that a call at a scale of 1
launches only its kernel.

No JAX here: the routes are held to themselves with the multiply forced (a
scale of 1 that needs a gradient is never skipped). The test marked
``cuda`` skips without a card (on-card lane: ``python -m pytest
--noconftest -m cuda tests/test_torch_scale.py``).
"""

import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch import stream as fs
from savgol_tpu_torch.ops import cuda_conv as cc
from savgol_tpu_torch.ops.sweep import savgol_apply_sweep
from savgol_tpu_torch.scipy_compat import savgol_filter


def _fill(v):
    """A buffer of 1, read once, then filled with ``v``."""
    b = torch.ones(())
    assert cc.scale_of(b, b) is None
    return b.fill_(v)


def _moved(dtype):
    """A buffer of 1, read once, then moved by ``.to(dtype)``."""
    b = torch.ones(())
    assert cc.scale_of(b, b) is None
    return b.to(dtype)


def _inference():
    with torch.inference_mode():
        return torch.ones(())


# case -> (the scale, the values it must reach a result as; None: none)
CASES = {
    "python 1.0": (lambda: 1.0, None),
    "python 2.0": (lambda: 2.0, 2.0),
    "buffer of 1": (lambda: torch.ones(()), None),
    "buffer of 1 filled with 2": (lambda: _fill(2.0), 2.0),
    "buffer of 1 moved to f64": (lambda: _moved(torch.float64), None),
    "buffer of 1 that requires grad": (
        lambda: torch.ones(()).requires_grad_(), 1.0),
    "inference tensor of 1": (_inference, 1.0),
    "bank vector of ones": (lambda: torch.ones(3), None),
    "bank vector with a 2": (lambda: torch.tensor([1.0, 2.0, 1.0]),
                             [1.0, 2.0, 1.0]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_scale_of_keeps_its_contract(case, dtype):
    make, want = CASES[case]
    v = make()
    x = torch.zeros(4, dtype=dtype)
    got = cc.scale_of(v, x)
    if want is None:
        assert got is None
        return
    # bf16 storage computes in f32; the 2D routes ask for x's own dtype
    compute = torch.float32 if dtype == torch.bfloat16 else dtype
    assert got.dtype == compute and got.device == x.device
    assert got.tolist() == want
    if isinstance(v, torch.Tensor) and (v.requires_grad or v.is_inference()):
        assert id(v) not in cc._SCALES        # never read on the host
    assert cc.scale_of(v, x, dtype).dtype == dtype


def test_a_scale_tensor_is_read_once_per_version(monkeypatch):
    """A buffer is read on the host on its first call and after each
    in-place change, a view as its base, and a tensor that ``scale_of``
    returned not at all."""
    reads = []
    real = torch.Tensor.all

    def counted(self, *a, **kw):
        reads.append(self.shape)
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "all", counted)
    x = torch.zeros(4)
    b = torch.ones(3)
    for _ in range(3):
        assert cc.scale_of(b, x) is None
        assert cc.scale_of(b[1], x) is None           # a new view a call
    assert len(reads) == 1
    b[1] = 2.0
    s = cc.scale_of(b, x)
    assert s is b and len(reads) == 2
    assert cc.scale_of(b[0], x) is not None           # its base holds a 2
    assert len(reads) == 2
    d = cc.scale_of(0.5, x)
    assert cc.scale_of(d, x) is d and cc.scale_of(None, x) is None
    assert len(reads) == 2


@pytest.mark.parametrize("scale", [None, 1.0, "buffer"])
def test_operands_pass_the_callers_taps_through_with_no_scale(scale):
    f = sgt.Savgol1D.create(sgt.SavgolConfig(4, 2), device="cpu")
    if scale == "buffer":
        scale = f.dt_inv
    x = torch.zeros(2, 32)
    cw, ew = f.center_weights, f.edge_weights
    xs, (w, e), restore = cc._operands(x, (cw, ew), scale, False, "test")
    assert xs is x and restore is None
    assert w is cw and e is ew
    _, (w2, e2), _ = cc._operands(x, (cw, ew), 2.0, False, "test")
    assert torch.equal(w2, cw * 2) and torch.equal(e2, ew * 2)


def _one():
    """A scale of 1 that every route multiplies by (it needs a
    gradient)."""
    return torch.ones((), dtype=torch.float64, requires_grad=True)


def _routes():
    """route -> a call at a given scale of 1 (1.0 or :func:`_one`)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 80, generator=g)
    x64 = x.double()
    img = torch.randn(2, 20, 24, generator=g)
    f = sgt.Savgol1D.create(sgt.SavgolConfig(6, 3, derivative=1),
                            device="cpu")
    cw, ew = f.center_weights, f.edge_weights
    f2 = sgt.Savgol2D.create(sgt.Savgol2DConfig(3, 3, 3), device="cpu")
    bank = sgt.SavgolBank.smooth_and_derivatives(6, 3, device="cpu")

    def apply(xv, boundary, method="auto"):
        return lambda s: sgt.savgol_apply(
            xv, cw.to(xv.dtype), ew.to(xv.dtype), half_window=6,
            boundary=boundary, dt_inv=s, derivative=1, method=method)

    def chunked(s):
        st = fs.chunk_init(6, device="cpu")
        st, a, _ = fs.stream_process_chunk(st, x[0, :40], cw, ew, s)
        st, b, _ = fs.stream_process_chunk(st, x[0, 40:], cw, ew, s)
        return torch.cat([a, b, fs.stream_flush_chunked(st, ew, s)[1]])

    def pushed(s):
        st, outs = fs.stream_init(6, device="cpu"), []
        for v in x[0, :20]:
            st, o, c = fs.stream_push_full(st, v, cw, ew, s)
            outs.append(o[:c])
        outs.append(fs.stream_flush(st, cw, ew, s)[1])
        return torch.cat(outs)

    def banked(s):
        bank.dt_inv.requires_grad_(not isinstance(s, float))
        try:
            return bank.apply(x)
        finally:
            bank.dt_inv.requires_grad_(False)

    return {
        "apply polynomial f32": apply(x, "polynomial"),
        "apply polynomial f64": apply(x64, "polynomial"),
        "apply reflect": apply(x, "reflect"),
        "apply periodic f64": apply(x64, "periodic"),
        "apply polynomial bf16": apply(x, "polynomial", "bf16"),
        "apply constant bf16": apply(x.bfloat16(), "constant", "bf16"),
        "apply xla": apply(x, "polynomial", "xla"),
        "apply_valid": lambda s: sgt.savgol_apply_valid(
            x, cw, half_window=6, dt_inv=s),
        "apply_valid bf16": lambda s: sgt.savgol_apply_valid(
            x.bfloat16(), cw, half_window=6, dt_inv=s, method="bf16"),
        "stream_apply": lambda s: fs.stream_apply(
            x[0], cw, ew, half_window=6, dt_inv=s, derivative=1),
        "stream chunks": chunked,
        "stream pushes": pushed,
        "bank": banked,
        "sweep": lambda s: savgol_apply_sweep(
            x, [4, 6], [2, 3], derivative=1, dt_inv=s, dtype=torch.float32),
        "2D": lambda s: sgt.savgol2d_apply(img, f2.weights, scale=s),
        "2D bf16": lambda s: sgt.savgol2d_apply(img.bfloat16(), f2.weights,
                                                scale=s, method="bf16"),
        "2D stack": lambda s: sgt.savgol2d_apply_stack(
            img, torch.stack([f2.weights, f2.weights]),
            scales=torch.stack([torch.ones(()), torch.ones(())]) * s),
    }


@pytest.mark.parametrize("route", list(_routes()))
def test_no_scale_gives_the_bits_of_a_multiply_by_one(route):
    call = _routes()[route]
    with torch.no_grad():
        skipped, multiplied = call(1.0), call(_one())
    assert skipped.dtype == multiplied.dtype
    assert torch.equal(skipped, multiplied)


def test_scipy_routes_resolve_their_scale():
    """scipy's extension modes at ``1/delta**deriv`` = 1 and != 1 against
    the same route with the multiply written out."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 90, generator=g, dtype=torch.float64)
    for mode in ("mirror", "constant"):
        one = savgol_filter(x, 11, 3, mode=mode, device="cpu")
        two = savgol_filter(x, 11, 3, deriv=1, delta=0.5, mode=mode,
                            device="cpu")
        half = savgol_filter(x, 11, 3, deriv=1, delta=1.0, mode=mode,
                             device="cpu")
        assert torch.equal(two, half * 2)
        assert one.shape == x.shape


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_a_call_at_a_scale_of_one_launches_only_its_kernel(
        cuda, tmp_path):
    """The card's operations of one traced call: at ``dt_inv`` = 1,
    ``Savgol1D.apply`` runs K1 alone, scipy's ``mirror`` K2 alone (its
    weights held since the warm-up call, so no copy), ``apply_valid`` K3
    alone; at 2 each keeps the operations of the scale (K1: a multiply of
    each of its two taps; scipy: a fill and a multiply of the taps;
    ``apply_valid``: a multiply of the output)."""
    from savgol_tpu_torch.utils import profiling
    x = torch.randn(8, 1 << 16, device=cuda)
    f1 = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4), device=cuda)
    f2 = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4, derivative=1,
                                              time_step=0.5), device=cuda)
    assert float(f2.dt_inv) == 2.0
    # (call, its kernel, operations in all, copies among them)
    calls = {
        ("apply", 1): (lambda: f1.apply(x), "sg1d_poly", 1, 0),
        ("apply", 2): (lambda: f2.apply(x), "sg1d_poly", 3, 0),
        ("mirror", 1): (lambda: savgol_filter(x, 25, 4, mode="mirror"),
                        "sg1d_poly", 1, 0),
        ("mirror", 2): (lambda: savgol_filter(x, 25, 4, deriv=1, delta=0.5,
                                              mode="mirror"),
                        "sg1d_poly", 3, 0),
        ("apply_valid", 1): (lambda: f1.apply_valid(x), "corr1d_valid", 1,
                             0),
        ("apply_valid", 2): (lambda: f2.apply_valid(x), "corr1d_valid", 2,
                             0),
    }
    for call, *_ in calls.values():      # build, load, read the buffers
        call()
    torch.cuda.synchronize()
    for key, (call, kernel, ops, copies) in calls.items():
        def run(call=call):
            call()
            torch.cuda.synchronize()
        events, _ = profiling.trace_events(run, str(tmp_path / "_".join(
            map(str, key))))
        names = [e["name"] for e in profiling.device_events(events)]
        assert len(names) == ops, (key, names)
        assert sum(kernel in n for n in names) == 1, (key, names)
        assert sum("memcpy" in n.lower() for n in names) == copies, (
            key, names)
