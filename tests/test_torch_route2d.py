"""Which 2D kernel an exact correlation runs (``ops/apply2d.py``:
``_route``, ``_sep_cheaper``, ``_sep_fill``) and the factor cache the
route reads a stencil's rank from (``_FACTORS``, ``_prime_factors``).

On the CPU: the route decision over window, rank, K2D-sep's fill of the
card, dtype, stack, gradient, method and device type; the stencils placed
from the host (``Savgol2D.create``, ``from_jax``, the fused Laplacian)
cache factors equal to ``_svd_stencil_np`` of their host values, and the
entry goes with the tensor; the crossover probe's cases. The tests marked
``cuda`` run the route on the card (this file imports no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_route2d.py -q
"""

import gc

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch.ops import apply2d
from savgol_tpu_torch.ops import cuda_conv2d as c2
from savgol_tpu_torch.ops.weights import savgol2d_weights_np
from savgol_tpu_torch.probes import route2d

F32, F64 = torch.float32, torch.float64
# K2D-sep's fill of the card at the 2D headline, (16, 2048, 2048) on an
# H100 (2,048 blocks over 132 SMs x 4 resident blocks), and at (4, 256, 256)
HEADLINE, SMALL = 2048 / 528, 16 / 528


@pytest.mark.parametrize(
    "H, W, rank, fill, dtype, stack, grad, method, device, want", [
        # 11 x 11 order 3 (rank 2) on the card: K2D-sep, 44 taps for 121
        (11, 11, 2, HEADLINE, F32, False, False, "pallas", "cuda", "sep"),
        (11, 11, 2, HEADLINE, F64, False, False, "pallas", "cuda", "sep"),
        (17, 17, 4, HEADLINE, F32, False, False, "pallas", "cuda", "sep"),
        (5, 11, 1, HEADLINE, F32, False, False, "pallas", "cuda", "sep"),
        # 3 x 3 order 2 (rank 2): 12 separable taps against 9 dense
        (3, 3, 2, HEADLINE, F32, False, False, "pallas", "cuda", "dense"),
        (3, 3, 2, HEADLINE, F64, False, False, "pallas", "cuda", "dense"),
        # 7 x 7 rank 2 ties in f32 and wins in f64; rank 3 loses in both
        (7, 7, 2, HEADLINE, F32, False, False, "pallas", "cuda", "dense"),
        (7, 7, 2, HEADLINE, F64, False, False, "pallas", "cuda", "sep"),
        (7, 7, 3, HEADLINE, F64, False, False, "pallas", "cuda", "dense"),
        # a launch that leaves most of the card idle keeps K2D-dense
        (11, 11, 2, SMALL, F32, False, False, "pallas", "cuda", "dense"),
        (11, 11, 2, 0.5, F32, False, False, "pallas", "cuda", "dense"),
        # wider than 17 taps: K2D-sep, as before, on every device
        (23, 23, 2, HEADLINE, F32, False, False, "pallas", "cuda", "sep"),
        (23, 23, None, None, F32, False, False, "pallas", "cuda", "sep"),
        (23, 23, None, None, F32, False, False, "pallas", "cpu", "sep"),
        (17, 25, None, None, F64, True, False, "pallas", "cuda", "sep"),
        # today's routes: a stack, a stencil that needs a gradient, bf16,
        # xla, a CPU tensor, an uncached stencil
        (11, 11, 2, HEADLINE, F32, True, False, "pallas", "cuda", "dense"),
        (11, 11, 2, HEADLINE, F32, False, True, "pallas", "cuda", "dense"),
        (23, 23, 2, HEADLINE, F32, False, True, "pallas", "cuda", "dense"),
        (11, 11, 2, HEADLINE, F32, False, True, "sep", "cuda", "dense"),
        (11, 11, 2, HEADLINE, F32, False, False, "bf16", "cuda", "bf16"),
        (23, 23, 2, HEADLINE, F32, False, False, "bf16", "cuda", "bf16"),
        (11, 11, 2, HEADLINE, F32, False, False, "xla", "cuda", "xla"),
        (23, 23, 2, HEADLINE, F32, False, False, "xla", "cpu", "xla"),
        (11, 11, 2, HEADLINE, F32, False, False, "pallas", "cpu", "dense"),
        (11, 11, None, None, F32, False, False, "pallas", "cuda", "dense"),
        (17, 17, None, None, F64, False, False, "pallas", "cuda", "dense"),
        # "sep" asks for K2D-sep at any width
        (3, 3, 2, SMALL, F32, False, False, "sep", "cpu", "sep"),
        (11, 11, None, None, F32, True, False, "sep", "cuda", "sep"),
    ])
def test_route(H, W, rank, fill, dtype, stack, grad, method, device, want):
    assert apply2d._route(H, W, rank, fill, dtype, stack, grad, method,
                          device) == want


@pytest.mark.parametrize("pad_mode, shape, dtype, want", [
    ("edge", (16, 2048, 2048), F32, 16 * 32 * 4 / (132 * 4)),
    ("edge", (16, 2048, 2048), F64, 16 * 32 * 4 / (132 * 2)),
    ("wrap", (4, 256, 256), F32, 4 * 4 * 1 / (132 * 4)),
    # VALID: 2038 x 2038 outputs, still 32 strips and 4 bands a frame
    (None, (2, 3, 2048, 2048), F32, 6 * 32 * 4 / (132 * 4)),
    (None, (1, 513, 65), F32, 1 * 1 * 1 / (132 * 4)),
    (None, (1, 5, 5), F32, 0.0),
])
def test_sep_fill_counts_the_sweeps_blocks(monkeypatch, pad_mode, shape,
                                           dtype, want):
    """K2D-sep's blocks (strips of 64 output columns, bands of 512 rows)
    over the card's resident slots, on an image of no storage and a card
    of 132 SMs."""
    x = torch.empty(shape, dtype=dtype, device="meta")
    monkeypatch.setitem(apply2d._SMS, x.device.index, 132)
    assert apply2d._sep_fill(x, 11, 11, pad_mode) == pytest.approx(want)


def _host(cfg, dtype):
    """The stencil's values in ``dtype`` as f64 on the host."""
    w = savgol2d_weights_np(cfg, dtype=np.float64)
    return torch.as_tensor(w, dtype=dtype).double().numpy()


def _placed(kind, dtype):
    """(stencil tensor, its host values as f64, the compute dtypes primed)
    of each way a stencil is placed from the host."""
    cfg = sgt.Savgol2DConfig(5, 5, 3)
    if kind == "create":
        f = sgt.Savgol2D.create(cfg, dtype=dtype, device="cpu")
        return f.weights, _host(cfg, dtype), (dtype,)
    if kind == "from_jax":
        leaves = (savgol2d_weights_np(cfg, dtype=np.float64).astype(
            torch.empty((), dtype=dtype).numpy().dtype),
            np.asarray(cfg.scale, dtype=np.float64))
        f = sgt.Savgol2D.from_jax(cfg, leaves, device="cpu")
        return f.weights, _host(cfg, dtype), (dtype,)
    apply2d._device_stencils.cache_clear()
    w, _ = apply2d._device_stencils(5, 5, 3, ((2, 0), (0, 2)), 0.5, 0.25,
                                    torch.device("cpu"), True)
    ws, s = apply2d._stencil_stack(5, 5, 3, ((2, 0), (0, 2)), 0.5, 0.25)
    return w, (ws * s[:, None, None]).sum(0), (F32, F64)


@pytest.mark.parametrize("kind, dtype", [
    ("create", F32), ("create", F64), ("from_jax", F32), ("from_jax", F64),
    ("laplacian", F64)])
def test_placed_stencils_prime_their_factors(kind, dtype):
    """A stencil placed from the host caches, for each compute dtype it
    serves, the factors ``_factors`` would find from it: ``_svd_stencil_np``
    of its values at ``_rank_rtol``, cast; the route then reads its rank
    without copying it from the card. The entry goes with the tensor."""
    w, host, dtypes = _placed(kind, dtype)
    assert w.dtype == dtype
    for ct in dtypes:
        got = apply2d._cached_factors(w, ct, w.device)
        assert got is not None
        want = c2._svd_stencil_np(host, apply2d._rank_rtol(w.dtype, ct))
        (u, v), = got
        assert u.dtype == v.dtype == ct and u.shape[0] == 2
        assert torch.equal(u, torch.as_tensor(want[0], dtype=ct))
        assert torch.equal(v, torch.as_tensor(want[1], dtype=ct))
        assert apply2d._factors(w, ct, w.device) is got
    keys = [(id(w), ct, w.device) for ct in dtypes]
    assert all(k in apply2d._FACTORS for k in keys)
    apply2d._device_stencils.cache_clear()
    del w
    gc.collect()
    assert not any(k in apply2d._FACTORS for k in keys)


def test_a_changed_stencil_is_factored_again():
    """An in-place change to a primed stencil voids its entry: the next
    K2D-sep call factors the new values."""
    f = sgt.Savgol2D.create(sgt.Savgol2DConfig(5, 5, 3), dtype=F64,
                            device="cpu")
    (u0, _), = apply2d._factors(f.weights, F64, f.weights.device)
    f.weights.mul_(2.0)
    assert apply2d._cached_factors(f.weights, F64, f.weights.device) is None
    (u1, _), = apply2d._factors(f.weights, F64, f.weights.device)
    np.testing.assert_allclose(u1.abs().numpy(),
                               np.sqrt(2) * u0.abs().numpy(), rtol=1e-12,
                               atol=1e-15)


def test_the_probe_covers_ranks_one_to_four():
    """probes/route2d.py times every window at ranks 1-4 where the window
    poses them, in f32 and f64, at the headline and a small image; its
    sweep runs from far below to above the fill the route asks for."""
    cases = route2d.cases()
    assert {(H, W) for _, _, H, W, _ in cases} == set(route2d.WINDOWS)
    assert {c[0] for c in cases} == {(16, 2048, 2048), (4, 256, 256)}
    for dtype in route2d.DTYPES:
        ranks = {r for _, d, _, _, by in cases if d == dtype for r in by}
        assert ranks == {1, 2, 3, 4}
    blocks = [B * -(-C // 64) * -(-R // 512)
              for B, R, C in route2d.SWEEP_IMAGES]
    assert min(blocks) < 0.1 * 528 and max(blocks) > 3 * 528


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_headline_apply_takes_k2d_sep(cuda):
    """``Savgol2D(5, 5, 3).apply`` at (16, 2048, 2048): one K2D-sep launch
    and no K2D-dense, within 1e-5 scaled of the f64 filter in every
    boundary (frames 0 and 15)."""
    cfg = sgt.Savgol2DConfig(5, 5, 3)
    f = sgt.Savgol2D.create(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(22)
    img = torch.randn(16, 2048, 2048, generator=gen, device=cuda)
    w64 = torch.from_numpy(savgol2d_weights_np(cfg, np.float64)).to(cuda)
    for boundary, mode in (("constant", "edge"), ("reflect", "symmetric"),
                           ("periodic", "wrap"), ("valid", None)):
        torch.cuda.synchronize()
        c2.reset_launches()
        y = (f.apply_valid(img) if mode is None
             else f.apply(img, boundary=boundary))
        torch.cuda.synchronize()
        assert c2.LAUNCHES == {"corr2d_valid": 0, "corr2d_sep": 1}
        want = c2.correlate2d_valid_plain(img[[0, 15]].double(), w64, mode)
        got = y[[0, 15]].double()
        assert got.shape == want.shape
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
def test_cuda_uncached_and_small_calls_keep_k2d_dense(cuda):
    """An ad hoc stencil tensor of 11 x 11 taps is never factored (no copy
    to the host, no cache entry) and takes K2D-dense; so does the primed
    stencil on an image whose K2D-sep launch would leave the card idle."""
    f = sgt.Savgol2D.create(sgt.Savgol2DConfig(5, 5, 3), device=cuda)
    big = torch.randn(16, 2048, 2048, device=cuda)
    w = f.weights.clone()
    before = len(apply2d._FACTORS)
    for x, weights in ((big, w), (big[:, :256, :256].contiguous(),
                                  f.weights)):
        torch.cuda.synchronize()
        c2.reset_launches()
        sgt.savgol2d_apply(x, weights)
        torch.cuda.synchronize()
        assert c2.LAUNCHES == {"corr2d_valid": 1, "corr2d_sep": 0}
    assert len(apply2d._FACTORS) == before
