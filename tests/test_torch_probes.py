"""The attribution probes P2 (``savgol_tpu_torch.probes.rowband2d``) and P3
(``savgol_tpu_torch.probes.bf16_1d``): each variant's plain version against
a numpy statement of the variant's definition, ``A_lib``'s plain version
against the JAX package's row-banded kernel on bf16 operands in interpret
mode, and, on the card (``cuda``), each probe kernel against its plain
version.

Tolerance: the plain versions sum exact bf16 products in f32 and round
bf16 outputs once, the numpy statements sum in f64: one bf16 ulp
(``ops.cuda_conv.bf16_ulp_gate``) for bf16 outputs, 2e-6 * max(1, max|y|)
for f32 ones.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from savgol_tpu_torch.ops.cuda_conv import bf16_ulp_gate
from savgol_tpu_torch.probes import bf16_1d as p3
from savgol_tpu_torch.probes import rowband2d as p2
from savgol_tpu_torch.probes import variants


def _bf16(a):
    """numpy values rounded to bf16, in f64."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).double().numpy()


def _within_ulp(got, want):
    got = got.double()
    want = torch.as_tensor(np.asarray(want, dtype=np.float64))
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= bf16_ulp_gate(want)).all())


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- P3 ---------------------------------------------------------------------


@pytest.mark.parametrize("N,ws,tile", [(3000, 25, 1024), (100, 7, 16),
                                       (65, 65, 32), (2048, 1, 1024)])
def test_p3_plain_matches_definitions(N, ws, tile):
    x, w = _x((3, N), N + ws), _x(ws, ws)
    xt = torch.from_numpy(x)
    xb, wb = _bf16(x), _bf16(w)
    n_out = N - ws + 1
    copy = p3.probe_plain(xt, torch.from_numpy(w), "copy", tile)
    assert copy.dtype == torch.bfloat16
    np.testing.assert_array_equal(copy.double().numpy(), xb)
    shift = p3.probe_plain(xt, torch.from_numpy(w), "shift_only", tile)
    np.testing.assert_array_equal(shift.double().numpy(),
                                  xb[:, ws // 2:ws // 2 + n_out])
    want = np.zeros((3, n_out))
    for j in range(n_out):
        t0 = j // tile * tile
        for k in range(ws):
            s = t0 + (j - t0 + k) % tile
            if s < N:
                want[:, j] += wb[k] * xb[:, s]
    _within_ulp(p3.probe_plain(xt, torch.from_numpy(w), "taps_only", tile),
                want)


def test_p3_taps_only_is_k3_inside_a_tile():
    """Away from a tile's last ws - 1 outputs the halo is not read, so
    taps_only gives K3-bf16's values there."""
    from savgol_tpu_torch.ops.cuda_conv import correlate_valid_bf16_plain
    x, w = torch.from_numpy(_x((2, 300), 1)), torch.from_numpy(_x(9, 2))
    got = p3.probe_plain(x, w, "taps_only", tile=64)
    want = correlate_valid_bf16_plain(x.to(torch.bfloat16), w)
    j = torch.arange(got.shape[-1])
    inside = (j % 64) <= 64 - 9
    assert torch.equal(got[:, inside], want[:, inside])
    assert not torch.equal(got, want)


def test_p3_tile_is_the_bf16_tile():
    """TILE is K3-bf16's tile, kTile = 256 kMT kWarps of
    csrc/sg1d_bf16.cuh, read from its text."""
    text = (pathlib.Path(p3.__file__).resolve().parents[1] / "csrc"
            / "sg1d_bf16.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    assert re.search(r"constexpr int kTile = 256 \* kMT \* kWarps;", text)
    assert p3.TILE == const("kMT") * 256 * const("kWarps")


def test_p3_taps_only_is_k3_away_from_tile_ends():
    """At the kernel's tile, over rows of more than two tiles, taps_only's
    plain version is K3-bf16's away from each tile's last ws - 1 outputs
    (the only ones whose windows reach the halo)."""
    from savgol_tpu_torch.ops.cuda_conv import correlate_valid_bf16_plain
    ws, N = 9, 2 * p3.TILE + 3000
    x, w = torch.from_numpy(_x((2, N), 11)), torch.from_numpy(_x(ws, 12))
    got = p3.probe_plain(x, w, "taps_only")
    want = correlate_valid_bf16_plain(x.to(torch.bfloat16), w)
    j = torch.arange(got.shape[-1])
    inside = j % p3.TILE < p3.TILE - (ws - 1)
    assert torch.equal(got[:, inside], want[:, inside])
    assert not torch.equal(got[:, ~inside], want[:, ~inside])


@pytest.mark.parametrize("offset,N", [(0, 100), (1, 104), (4, 1000)])
def test_p3_needs_aligned_rows(offset, N):
    """Rows must start on 16-byte boundaries; the wrapper says so before it
    looks for a card."""
    flat = torch.zeros(2 * N + offset, dtype=torch.bfloat16)
    x = flat[offset:].view(2, N)
    with pytest.raises(ValueError, match="16-byte"):
        p3.probe_cuda(x, torch.ones(5), "copy")


def test_p3_needs_the_card():
    x = torch.zeros(2, 104, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        p3.probe_cuda(x, torch.ones(5), "copy")
    with pytest.raises(ValueError, match="variant"):
        p3.probe_plain(x, torch.ones(5), "mm_only")


# -- P2 ---------------------------------------------------------------------


@pytest.mark.parametrize("pad_mode", [None, "edge", "wrap"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_p2_alignctl_plain_matches_definition(pad_mode, dtype):
    """out[r, c] = sum_y sum_x w[y, x] * X[r, c + x], X the bf16 image as
    K2D-dense extends it."""
    x, w = _x((2, 20, 30), 3), _x((5, 7), 4)
    xp = _bf16(x)
    if pad_mode is not None:
        mode = {"edge": "edge", "wrap": "wrap"}[pad_mode]
        xp = np.pad(xp, ((0, 0), (2, 2), (3, 3)), mode=mode)
    Ro, Co = xp.shape[1] - 4, xp.shape[2] - 6
    wsum = _bf16(w).sum(0)
    want = np.zeros((2, Ro, Co))
    for c in range(7):
        want += wsum[c] * xp[:, :Ro, c:c + Co]
    got = p2.alignctl_plain(torch.from_numpy(x).to(dtype),
                            torch.from_numpy(w), pad_mode)
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.double().numpy(), want,
                                   atol=2e-6 * max(1, np.abs(want).max()))
    else:
        _within_ulp(got, want)


def test_p2_variants_plain():
    """A_lib and C_inshift are K2D-dense-bf16's plain version; C_wh1 its
    first stencil row alone."""
    from savgol_tpu_torch.ops.cuda_conv2d import correlate2d_valid_bf16_plain
    x, w = torch.from_numpy(_x((1, 30, 40), 5)), torch.from_numpy(_x((5, 5),
                                                                    6))
    a = p2.variant_plain("A_lib", x, w, "edge")
    assert torch.equal(a, correlate2d_valid_bf16_plain(x, w, "edge"))
    assert torch.equal(p2.variant_plain("C_inshift", x, w, "edge"), a)
    assert torch.equal(p2.variant_plain("C_wh1", x, w),
                       correlate2d_valid_bf16_plain(x, w[:1]))
    with pytest.raises(ValueError, match="variant"):
        p2.variant_plain("D", x, w)
    with pytest.raises(ValueError, match="card"):
        p2.variant_cuda("B_alignctl", x, w)


@pytest.mark.parametrize("pad_mode", [None, "edge", "wrap"])
def test_p2_alignctl_one_row_is_a_lib(pad_mode):
    """With a one-row stencil there is no shift to remove: B_alignctl,
    C_wh1 and A_lib give the same values."""
    x = torch.from_numpy(_x((2, 20, 36), 13)).to(torch.bfloat16)
    w = torch.from_numpy(_x((1, 7), 14))
    a = p2.variant_plain("A_lib", x, w, pad_mode)
    assert torch.equal(p2.variant_plain("B_alignctl", x, w, pad_mode), a)
    assert torch.equal(p2.variant_plain("C_wh1", x, w, pad_mode), a)


def test_p2_a_lib_plain_matches_rowmxu_pallas():
    """A_lib's plain version against ``correlate2d_valid_pallas_rowmxu`` on
    bf16 operands at DEFAULT precision with its f32 accumulator out
    (interpret mode)."""
    pc = pytest.importorskip("savgol_tpu.ops.pallas_conv")
    import jax
    import jax.numpy as jnp
    x, w = _x((2, 44, 60), 7), _x((11, 11), 8)
    want = np.asarray(pc.correlate2d_valid_pallas_rowmxu(
        jnp.asarray(x).astype(jnp.bfloat16), w,
        mxu_precision=jax.lax.Precision.DEFAULT, out_dtype=jnp.float32))
    got = p2.variant_plain("A_lib", torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-6 * max(1, np.abs(want).max()))


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", p3.VARIANTS)
@pytest.mark.parametrize("N,ws", [(3000, 25), (72, 65), (8192 * 2 + 40, 3),
                                  (8192 * 3, 129), (8192 + 16, 1)])
def test_cuda_p3_matches_plain(cuda, variant, N, ws):
    """copy and shift_only bit for bit, taps_only within one bf16 ulp."""
    x = torch.from_numpy(_x((3, N), N)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(_x(ws, ws)).to(cuda)
    before = p3.LAUNCHES["probe_bf16_1d"]
    got = p3.probe_cuda(x, w, variant)
    assert p3.LAUNCHES["probe_bf16_1d"] == before + 1
    want = p3.probe_plain(x, w, variant)
    if variant == "taps_only":
        _within_ulp(got.cpu(), want.double().cpu())
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_p2_alignctl_one_row_is_a_lib(cuda, dtype):
    """B_alignctl's instance with a one-row stencil is A_lib bit for
    bit."""
    x = torch.from_numpy(_x((2, 150, 170), 15)).to(cuda, dtype)
    w = torch.from_numpy(_x((1, 11), 16)).to(cuda)
    assert torch.equal(p2.variant_cuda("B_alignctl", x, w, "edge"),
                       p2.variant_cuda("A_lib", x, w, "edge"))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", p2.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", [None, "edge"])
def test_cuda_p2_matches_plain(cuda, variant, dtype, pad_mode):
    x = torch.from_numpy(_x((2, 150, 170), 9)).to(cuda, dtype)
    w = torch.from_numpy(_x((11, 11), 10)).to(cuda)
    got = p2.variant_cuda(variant, x, w, pad_mode).cpu()
    want = p2.variant_plain(variant, x, w, pad_mode).cpu()
    assert got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=2e-6 * max(1, want.abs().max()))
    else:
        _within_ulp(got, want.double())


@pytest.mark.parametrize("kernel", sorted(variants.VARIANTS))
def test_variants_apply_to_this_checkout(kernel, tmp_path):
    """probes/variants.py writes the as-is source of this checkout's kernel
    and each design alternative whose lines it still finds as an edited
    copy beside the headers (an alternative may edit a header); the rest it
    reports as stale, not built."""
    fname, by_name = variants.VARIANTS[kernel]
    paths, stale = variants.sources(kernel, tmp_path)
    assert sorted([*paths, *stale]) == sorted(by_name)
    assert "as_is" in paths
    assert paths["as_is"].read_text() == (variants._CSRC / fname).read_text()

    def texts(d):
        return {f.name: f.read_text() for f in sorted(d.iterdir())}
    as_is = texts(paths["as_is"].parent)
    assert all(text == (variants._CSRC / f).read_text()
               for f, text in as_is.items())
    for name, path in paths.items():
        assert (texts(path.parent) == as_is) == (name == "as_is")
        assert (path.parent / "plane_chol.cuh").exists()
