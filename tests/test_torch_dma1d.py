"""P1 (``savgol_tpu_torch.probes.dma1d``): the double-buffered VALID 1D
correlation against the JAX probe ``benchmarks/probe_dma1d.py::
corr1d_dma_call`` in interpret mode at HIGHEST precision, on the same
numpy-seeded inputs, within the probe's own gate of 1e-5
(``probe_dma1d.py:231``); the plain version against a float64 numpy
statement of the function; the JAX call's shape checks.

``benchmarks/`` is not a package: the JAX probe is loaded by file path with
``benchmarks/`` on ``sys.path`` for its ``chainlib`` import. Each
interpret-mode call compiles anew a shape, so the JAX cases are few.

The ``cuda`` tests hold the kernel against its plain version (2e-6 of
max(1, max|y|), the K1-K4 gate) and bit for bit against K3, over N of each
residue mod 4, windows 3 to 129, short ``n_out`` and a misaligned base
pointer; on-card lane (no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_dma1d.py -q
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from savgol_tpu_torch.ops.cuda_conv import correlate_valid_cuda
from savgol_tpu_torch.probes import dma1d

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_probe():
    """(benchmarks/probe_dma1d.py as a module, jax); skips without JAX."""
    jax = pytest.importorskip("jax")
    bench = str(REPO / "benchmarks")
    sys.path.insert(0, bench)
    try:
        spec = importlib.util.spec_from_file_location(
            "probe_dma1d_under_test", REPO / "benchmarks" / "probe_dma1d.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(bench)
    return mod, jax


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _data(B, N, ws, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N)).astype(np.float32),
            rng.standard_normal(ws).astype(np.float32))


def _definition(x, w, n_out):
    """out[b, j] = sum_k w[k] x[b, j + k], j < n_out, in float64."""
    x, w = x.astype(np.float64), w.astype(np.float64)
    return sum(w[k] * x[:, k:k + n_out] for k in range(w.size))


def _within(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


# two of the JAX probe's correctness geometries (probe_dma1d.py:214-215), N
# of residue 0 and 1 mod 4; and its bench's shorter n_out (:249-255) at a
# small size, N = n_out + 128 (the only short n_out its overlapped tail
# takes: the tail's in-slab offset must lie in [0, 128])
@pytest.mark.parametrize("B,N,ws,cols,short", [(16, 4096, 25, 2048, 0),
                                               (16, 4333, 13, 1024, 0),
                                               (8, 2176, 25, 1024, 104)])
def test_plain_matches_jax_probe(jax_probe, B, N, ws, cols, short):
    mod, jax = jax_probe
    x, w = _data(B, N, ws, N)
    n_out = N - ws + 1 - short
    want = np.asarray(mod.corr1d_dma_call(
        jax.numpy.asarray(x), jax.numpy.asarray(w), rows=8, cols=cols,
        n_out=n_out, interpret=True,
        mxu_precision=jax.lax.Precision.HIGHEST), dtype=np.float64)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = dma1d.corr1d_dma_plain(xt, wt, rows=8, cols=cols, n_out=n_out)
    assert got.shape == (B, n_out) and got.dtype == torch.float32
    _within(got, want, 1e-5)
    # a CPU tensor takes the plain version through the kernel's wrapper too
    assert torch.equal(dma1d.corr1d_dma_cuda(xt, wt, rows=8, cols=cols,
                                             n_out=n_out), got)


@pytest.mark.parametrize("N", [600, 601, 602, 603])
@pytest.mark.parametrize("ws,short", [(3, 0), (25, 7), (129, 0)])
def test_plain_matches_definition(N, ws, short):
    x, w = _data(4, N, ws, N + ws)
    n_out = N - ws + 1 - short
    got = dma1d.corr1d_dma_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 rows=2, cols=256, n_out=n_out)
    _within(got, _definition(x, w, n_out), 2e-6)


@pytest.mark.parametrize("fn", [dma1d.corr1d_dma_plain,
                                dma1d.corr1d_dma_cuda])
def test_shape_checks_raise(fn):
    x, w = torch.zeros(16, 500), torch.ones(25)
    ok = dict(rows=8, cols=256, n_out=476)
    assert fn(x, w, **ok).shape == (16, 476)
    for bad, match in ((dict(rows=3), "multiple of rows"),
                       (dict(rows=32), "multiple of rows"),
                       (dict(rows=0), "multiple of rows"),
                       (dict(n_out=477), "too short"),
                       (dict(n_out=0), "too short"),
                       (dict(cols=200), "cols"),
                       (dict(cols=16384), "cols")):
        with pytest.raises(ValueError, match=match):
            fn(x, w, **{**ok, **bad})
    with pytest.raises(ValueError, match="taps"):
        fn(x, torch.ones(131), **ok)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        fn(torch.zeros(2, 8, 500), w, **ok)
    assert dma1d.LAUNCHES == {"corr1d_dma": 0}


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4096, 4097, 4098, 4099])
@pytest.mark.parametrize("ws", [3, 25, 65, 101, 129])
@pytest.mark.parametrize("cols,short", [(2048, 0), (1024, 333), (128, 5)])
def test_cuda_matches_plain_and_k3(cuda, N, ws, cols, short):
    x, w = _data(16, N, ws, N * ws)
    x, w = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    n_out = N - ws + 1 - short
    before = dma1d.LAUNCHES["corr1d_dma"]
    got = dma1d.corr1d_dma_cuda(x, w, rows=8, cols=cols, n_out=n_out)
    torch.cuda.synchronize()
    assert dma1d.LAUNCHES["corr1d_dma"] == before + 1
    want = dma1d.corr1d_dma_plain(x, w, rows=8, cols=cols, n_out=n_out)
    _within(got.cpu(), want.cpu().double().numpy(), 2e-6)
    assert torch.equal(got, correlate_valid_cuda(x, w)[:, :n_out])


@pytest.mark.cuda
@pytest.mark.parametrize("ws", [25, 101, 7])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_misaligned_base(cuda, offset, ws):
    """A contiguous view whose first sample is not 16-byte aligned; K3's
    compile-time windows (25, 101) and a runtime one."""
    B, N = 8, 3001
    flat = torch.from_numpy(_data(1, B * N + 4, 1, offset)[0][0]).to(cuda)
    x = flat[offset:offset + B * N].view(B, N)
    w = torch.from_numpy(_data(1, 1, ws, 7)[1]).to(cuda)
    got = dma1d.corr1d_dma_cuda(x, w, rows=4, cols=1024, n_out=N - ws + 1)
    assert torch.equal(got, correlate_valid_cuda(x, w))
