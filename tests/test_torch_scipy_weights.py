"""The device weights of the scipy drop-in (``savgol_tpu_torch.scipy_compat``),
held across calls: a repeated call finds them (one ``hit`` in
``scipy_compat.WEIGHTS``) without building the host table again, and gives
the same bits as a call that builds them; calls that differ in window,
polyorder, deriv, compute dtype or need of the edge rows do not share
them; ``delta`` reaches only the scale; weights first built inside
``torch.inference_mode`` still serve a later autograd call.

The CPU cases run the plain route of every mode. The case marked ``cuda``
traces a warm ``mode="mirror"`` call on the card: K2 alone, no copy from
the host (on-card lane: ``python -m pytest --noconftest -m cuda
tests/test_torch_scipy_weights.py``). No JAX here.
"""

import numpy as np
import pytest
import torch
from scipy.signal import savgol_filter as sp_filter

from savgol_tpu_torch import scipy_compat as tsc
from savgol_tpu_torch.ops import cuda_conv as cc

MODES = ["interp", "mirror", "nearest", "wrap", "constant"]
DTYPES = [torch.float32, torch.float64, torch.complex64, torch.int32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.fixture
def cleared():
    """An empty cache of device weights."""
    tsc._device_weights.cache_clear()


def _x(dtype, seed=0, shape=(3, 64)):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-50, 50, shape, generator=g, dtype=dtype)
    if dtype.is_complex:
        return torch.complex(torch.randn(shape, generator=g),
                             torch.randn(shape, generator=g)).to(dtype)
    return torch.randn(shape, generator=g, dtype=dtype)


def _counted(call):
    """call()'s result and the counts of WEIGHTS it added."""
    before = dict(tsc.WEIGHTS)
    y = call()
    return y, {k: tsc.WEIGHTS[k] - before[k] for k in before}


def _no_host_table(*_):
    raise AssertionError("the host table was built on a repeated call")


@pytest.mark.parametrize("deriv", [0, 2])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_a_repeated_call_finds_its_weights_held(cleared, monkeypatch, mode,
                                                dtype, deriv):
    """The second identical call counts one hit and builds nothing, its
    output is bit-equal to a call with the cache cleared."""
    x = _x(dtype)

    def call():
        return tsc.savgol_filter(x, 11, 4, deriv=deriv, delta=0.5,
                                 mode=mode, cval=0.5)

    _, first = _counted(call)
    assert first == {"hit": 0, "built": 1}
    with monkeypatch.context() as m:
        m.setattr(tsc, "_compat_weights_np", _no_host_table)
        y, second = _counted(call)
    assert second == {"hit": 1, "built": 0}
    tsc._device_weights.cache_clear()
    fresh, third = _counted(call)
    assert third == {"hit": 0, "built": 1}
    assert y.dtype == fresh.dtype and torch.equal(y, fresh)


# (what differs, keyword arguments of the second call)
KEYS = {
    "window": {"window_length": 13},
    "polyorder": {"polyorder": 3},
    "deriv": {"deriv": 1},
    "dtype": {"x": _x(torch.float64)},
    "native_against_extension": {"mode": "mirror"},
}


@pytest.mark.parametrize("what", KEYS)
def test_calls_that_differ_in_a_key_do_not_share_weights(cleared, what):
    base = {"x": _x(torch.float32), "window_length": 11, "polyorder": 4,
            "deriv": 0, "mode": "interp"}
    _, first = _counted(lambda: tsc.savgol_filter(**base))
    assert first == {"hit": 0, "built": 1}
    _, second = _counted(lambda: tsc.savgol_filter(**{**base,
                                                      **KEYS[what]}))
    assert second == {"hit": 0, "built": 1}


@pytest.mark.parametrize("mode", MODES)
def test_a_change_of_delta_alone_finds_the_weights_and_scales(cleared,
                                                              mode):
    """``delta`` reaches only ``1/delta**deriv``: a hit, whose output is
    scipy's at the new ``delta``."""
    x = _x(torch.float64, seed=1, shape=(2, 80))
    tsc.savgol_filter(x, 11, 4, deriv=2, delta=1.0, mode=mode, cval=0.5)
    y, counts = _counted(lambda: tsc.savgol_filter(
        x, 11, 4, deriv=2, delta=0.25, mode=mode, cval=0.5))
    assert counts == {"hit": 1, "built": 0}
    want = sp_filter(x.numpy(), 11, 4, deriv=2, delta=0.25, mode=mode,
                     cval=0.5)
    np.testing.assert_allclose(y.numpy(), want,
                               atol=1e-9 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("mode", MODES)
def test_weights_first_built_in_inference_mode_serve_autograd(cleared,
                                                              mode):
    """A first call inside ``torch.inference_mode`` must not leave an
    inference tensor in the cache: a later call with a gradient finds the
    weights held, and its ``backward()`` gives the gradient of a call that
    built them outside inference mode."""
    x = _x(torch.float32, seed=2)
    with torch.inference_mode():
        tsc.savgol_filter(x, 11, 4, mode=mode, cval=0.5)
    g = torch.linspace(-1.0, 1.0, x.numel()).reshape(x.shape)

    def grad():
        xg = x.clone().requires_grad_()
        tsc.savgol_filter(xg, 11, 4, mode=mode, cval=0.5).backward(g)
        return xg.grad

    got, counts = _counted(grad)
    assert counts == {"hit": 1, "built": 0}
    tsc._device_weights.cache_clear()
    assert torch.equal(got, grad())


def test_compat_weights_np_returns_fresh_arrays():
    """Its callers may write into what it returns: no call shares it."""
    a, b = tsc._compat_weights_np(12, 4, 0), tsc._compat_weights_np(12, 4, 0)
    assert all(not np.shares_memory(p, q) for p, q in zip(a, b))


@pytest.mark.cuda
def test_cuda_a_warm_mirror_call_is_k2_alone(cuda, tmp_path):
    """A warm ``savgol_filter(x, 25, 4, mode="mirror")`` on the card: one
    K2 launch, the one operation of the traced call, no copy from the host;
    one hit in ``WEIGHTS`` (a take of the trace each, where the profiler
    lost a take's device activity and ``trace_events`` traced it again)."""
    from savgol_tpu_torch.utils import profiling
    x = torch.randn(8, 1 << 16, device=cuda)
    tsc.savgol_filter(x, 25, 4, mode="mirror")        # build, load, cache
    torch.cuda.synchronize()
    launches = dict(cc.LAUNCHES)

    def run():
        tsc.savgol_filter(x, 25, 4, mode="mirror")
        torch.cuda.synchronize()

    (events, takes), counts = _counted(lambda: profiling.trace_events(
        run, str(tmp_path)))
    assert counts == {"hit": takes, "built": 0}
    assert {k: cc.LAUNCHES[k] - launches[k] for k in launches} == {
        k: takes * (k == "sg1d_pad") for k in launches}
    names = [e["name"] for e in profiling.device_events(events)]
    assert len(names) == 1 and "sg1d_poly" in names[0], names
    assert not any("memcpy" in n.lower() for n in names), names
