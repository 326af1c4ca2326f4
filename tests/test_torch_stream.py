"""Streaming (``savgol_tpu_torch.stream``, ``SavgolStream``) against the JAX
package's (``savgol_tpu.stream``, ``savgol_tpu.SavgolStream``) on the same
numpy-seeded inputs, on the CPU; the cases of ``tests/test_stream.py`` and
``tests/test_checkpoint.py`` carried over.

Every function's ``(outputs, count)`` and the state's leaves are compared
push by push: counts, counters and buffers exactly, values within 1e-10
(float64) or 2e-6 (float32) of max(1, max|ref|) (the push dot and the edge
sums are product-sums here and matmuls there, so the summation order
differs). Against the compiled reference C stream (the ``ref`` fixture of
``tests/conftest.py``, which skips where the reference sources are absent)
within 1e-5, as ``tests/test_stream.py`` holds the JAX package.

The ``cuda`` tests run the stream on the card (on-card lane, no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_stream.py -q
"""

import io
import pickle

import numpy as np
import pytest
import torch

import savgol_tpu_torch as sgt
from savgol_tpu_torch import stream as ts
from savgol_tpu_torch.ops import cuda_conv as cc

TOL = {torch.float64: 1e-10, torch.float32: 2e-6}
CPU = "cpu"


@pytest.fixture(scope="module")
def jx():
    """(savgol_tpu, savgol_tpu.stream, jax, jax.numpy); skips without JAX."""
    sg = pytest.importorskip("savgol_tpu")
    import jax
    import jax.numpy as jnp
    from savgol_tpu import stream as js
    return sg, js, jax, jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _filters(jx, n, m, d=0, dt=1.0, dtype=torch.float64):
    """(JAX Savgol1D, the port's Savgol1D from its leaves, on the CPU)."""
    sg, _, jax, jnp = jx
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    fj = sg.Savgol1D.create(sg.SavgolConfig(n, m, d, dt), dtype=jdt)
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(fj)]
    ft = sgt.Savgol1D.from_jax(sgt.SavgolConfig(n, m, d, dt), leaves,
                               device=CPU)
    return fj, ft


def _close(got, want, dtype=torch.float64):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size == 0:
        return
    scale = max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= TOL[dtype] * scale, f"{err:.3e} > {TOL[dtype]:.0e} * {scale}"


def _same_state(st_t, st_j):
    """The port's state leaves equal the JAX state's: counters exactly, the
    ring (or tail) bit for bit (both only copy samples into it)."""
    for t, j in zip(st_t, st_j):
        t = t.cpu().numpy()
        assert np.array_equal(t, np.asarray(j)), (t, np.asarray(j))


def _signal(T, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(T).astype(dtype)


def _push_both(jx, fj, ft, x, lead_sign=1.0, max_outputs=None,
               dtype=torch.float64):
    """push_full over x on both sides, compared push by push; returns the
    port's emissions and final states."""
    _, js, _, jnp = jx
    n = ft.half_window
    st_j = js.stream_init(n, dtype=fj.center_weights.dtype)
    st_t = ts.stream_init(n, dtype, device=CPU)
    outs = []
    for v in x:
        st_j, oj, cj = js.stream_push_full(
            st_j, float(v), fj.center_weights, fj.edge_weights, fj.dt_inv,
            lead_sign=lead_sign, max_outputs=max_outputs)
        st_t, ot, ct = ts.stream_push_full(
            st_t, float(v), ft.center_weights, ft.edge_weights, ft.dt_inv,
            lead_sign=lead_sign, max_outputs=max_outputs)
        assert ct == int(cj) and ot.shape == (n + 1,)
        _close(ot, oj, dtype)
        _same_state(st_t, st_j)
        outs.append(ot[:ct])
    return torch.cat(outs), st_t, st_j


# -- lifecycle and gating ------------------------------------------------------


def test_initial_state_and_default_device():
    s = sgt.SavgolStream(sgt.SavgolConfig(5, 2), device=CPU)
    assert (s.ready, s.latency, s.buffered, s.samples_received,
            s.samples_output) == (False, 5, 0, 0, 0)
    assert s.state.buffer.shape == (11,)
    assert s.state.samples_received.device.type == "cpu"
    if not torch.cuda.is_available():
        for make in (lambda: sgt.SavgolStream(sgt.SavgolConfig(5, 2)),
                     lambda: ts.stream_init(5), lambda: ts.chunk_init(5)):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                make()


def test_init_from_existing_filter():
    f = sgt.Savgol1D.create(sgt.SavgolConfig(4, 2), torch.float64, device=CPU)
    s = sgt.SavgolStream(f, torch.float64)
    assert s.filter is f and s.state.buffer.device.type == "cpu"
    with pytest.raises(ValueError, match="filter's device"):
        sgt.SavgolStream(f, device=CPU)
    with pytest.raises(TypeError):
        sgt.SavgolStream(42)


def test_no_output_until_full_and_latency(jx):
    sg, js, _, _ = jx
    n = 5
    fj, ft = _filters(jx, n, 2)
    st_j = js.stream_init(n, dtype=fj.center_weights.dtype)
    st_t = ts.stream_init(n, torch.float64, device=CPU)
    for i in range(3 * n):
        st_j, vj, okj = js.stream_push(st_j, float(i), fj.center_weights,
                                       fj.dt_inv)
        st_t, vt, okt = ts.stream_push(st_t, float(i), ft.center_weights,
                                       ft.dt_inv)
        assert okt == bool(okj) == (i >= 2 * n)
        assert ts.stream_ready(st_t) == okt
        assert ts.stream_buffered(st_t) == int(js.stream_buffered(st_j))
        _close(vt, vj)
        _same_state(st_t, st_j)
    for n in (1, 4, 12, 32):
        assert sgt.SavgolStream(sgt.SavgolConfig(n, 1),
                                device=CPU).latency == n


def test_push_never_writes_into_the_given_state():
    f = sgt.Savgol1D.create(sgt.SavgolConfig(3, 2), torch.float64, device=CPU)
    st = ts.stream_init(3, torch.float64, device=CPU)
    for i in range(9):
        st, _, _ = ts.stream_push_full(st, float(i), f.center_weights,
                                       f.edge_weights)
    before = [t.clone() for t in st]
    a, _, _ = ts.stream_push_full(st, 100.0, f.center_weights, f.edge_weights)
    b, _, _ = ts.stream_push(st, -100.0, f.center_weights)
    for t, t0 in zip(st, before):
        assert torch.equal(t, t0)
    assert not torch.equal(a.buffer, b.buffer)


# -- conservation, stream == batch, derivative ---------------------------------


@pytest.mark.parametrize("T", [13, 40, 100])
def test_conservation_matches_jax(jx, T):
    n = 6
    fj, ft = _filters(jx, n, 3)
    _, js, _, _ = jx
    x = _signal(T, T)
    outs, st_t, st_j = _push_both(jx, fj, ft, x)
    st_j, oj, cj = js.stream_flush(st_j, fj.center_weights, fj.edge_weights,
                                   fj.dt_inv)
    st_t, ot, ct = ts.stream_flush(st_t, ft.center_weights, ft.edge_weights,
                                   ft.dt_inv)
    assert ct == int(cj) == n
    _close(ot, oj)
    _same_state(st_t, st_j)
    assert outs.numel() + ct == T == int(st_t.samples_output)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stream_equals_batch_noisy_sine(jx, dtype):
    n, m = 6, 3
    t = np.linspace(0, 4 * np.pi, 200)
    x = np.sin(t) + 0.1 * np.random.default_rng(99).standard_normal(200)
    s = sgt.SavgolStream(sgt.SavgolConfig(n, m), dtype, device=CPU)
    outs = [s.push_full(float(v)) for v in x] + [s.flush()]
    got = torch.cat(outs)
    f = sgt.Savgol1D.create(sgt.SavgolConfig(n, m), dtype, device=CPU)
    _close(got, f.apply(torch.as_tensor(x, dtype=dtype)), dtype)
    sg, _, _, jnp = jx
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    sj = sg.SavgolStream(sg.SavgolConfig(n, m), dtype=jdt)
    want = np.concatenate([sj.push_full(float(v)) for v in x] + [sj.flush()])
    _close(got, want, dtype)
    assert s.samples_output == sj.samples_output == 200


@pytest.mark.parametrize("n,m,d", [(3, 2, 0), (6, 3, 1), (8, 4, 2), (1, 1, 0),
                                   (12, 4, 0)])
def test_stream_apply_matches_jax_batch_and_pushes(jx, n, m, d):
    sg, _, _, jnp = jx
    fj, ft = _filters(jx, n, m, d, dt=0.5)
    x = _signal(150, 7)
    got = ts.stream_apply(torch.from_numpy(x), ft.center_weights,
                          ft.edge_weights, half_window=n, dt_inv=ft.dt_inv,
                          derivative=d)
    want = sg.stream_apply(jnp.asarray(x), fj.center_weights,
                           fj.edge_weights, half_window=n, dt_inv=fj.dt_inv,
                           derivative=d)
    _close(got, want)
    _close(got, ft.apply(torch.from_numpy(x)))
    # the per-sample pushes are its oracle
    s = sgt.SavgolStream(ft, torch.float64)
    pushed = torch.cat([s.push_full(float(v)) for v in x] + [s.flush()])
    _close(got, pushed)
    _close(s.process(x), pushed)


def test_stream_apply_float32_matches_jax(jx):
    sg, _, _, jnp = jx
    fj, ft = _filters(jx, 12, 4, 1, dt=0.01, dtype=torch.float32)
    x = _signal(300, 3, np.float32)
    got = ts.stream_apply(torch.from_numpy(x), ft.center_weights,
                          ft.edge_weights, half_window=12, dt_inv=ft.dt_inv,
                          derivative=1)
    assert got.dtype == torch.float32
    want = sg.stream_apply(jnp.asarray(x), fj.center_weights,
                           fj.edge_weights, half_window=12, dt_inv=fj.dt_inv,
                           derivative=1)
    _close(got, want, torch.float32)


def test_stream_apply_rejects_batched_and_short_input():
    f = sgt.Savgol1D.create(sgt.SavgolConfig(4, 2), device=CPU)
    with pytest.raises(ValueError, match="ONE sequence"):
        ts.stream_apply(torch.zeros(3, 100), f.center_weights,
                        f.edge_weights, half_window=4)
    with pytest.raises(ValueError, match="at least 9"):
        ts.stream_apply(torch.zeros(8), f.center_weights, f.edge_weights,
                        half_window=4)


def test_derivative_on_ramp(jx):
    s = sgt.SavgolStream(sgt.SavgolConfig(5, 2, 1), torch.float64,
                         device=CPU)
    vals = [v for v, ok in (s.push(2.5 * i) for i in range(60)) if ok]
    assert len(vals) == 50
    _close(torch.stack(vals), np.full(50, 2.5))
    # the corrected leading-edge sign: +slope everywhere, as the JAX stream
    fj, ft = _filters(jx, 5, 2, 1)
    outs, _, _ = _push_both(jx, fj, ft, 3.0 * np.arange(40), lead_sign=-1.0)
    s = sgt.SavgolStream(ft, torch.float64)
    got = torch.cat([s.push_full(3.0 * i) for i in range(40)] + [s.flush()])
    _close(got, np.full(40, 3.0))
    _close(got[:35], outs)


# -- reset, flushes, clamps ------------------------------------------------------


def test_reset_and_reuse():
    s = sgt.SavgolStream(sgt.SavgolConfig(4, 2), torch.float64, device=CPU)
    for i in range(20):
        s.push(float(i))
    assert s.ready
    s.reset()
    assert (s.ready, s.buffered, s.samples_received) == (False, 0, 0)
    run1 = torch.stack([s.push(float(i))[0] for i in range(20)][9:])
    s.reset()
    run2 = torch.stack([s.push(float(i))[0] for i in range(20)][9:])
    assert torch.equal(run1, run2)


def test_flushes_match_jax(jx):
    sg, _, _, _ = jx
    n = 6
    for max_count in (None, 3, 0, -2, 99):
        for T in (5, 30):
            sj = sg.SavgolStream(sg.SavgolConfig(n, 3))
            st = sgt.SavgolStream(sgt.SavgolConfig(n, 3), device=CPU)
            x = _signal(T, T, np.float32)
            for v in x:
                sj.push_full(float(v))
                st.push_full(float(v))
            got, want = st.flush(max_count), sj.flush(max_count)
            k = 0 if T < 2 * n + 1 else (
                n if max_count is None else min(max(0, max_count), n))
            assert got.numel() == want.size == k
            _close(got, want, torch.float32)
            got = st.flush_leading(max_count)
            want = sj.flush_leading(max_count)
            assert got.numel() == want.size
            _close(got, want, torch.float32)
            assert st.samples_output == sj.samples_output


@pytest.mark.parametrize("max_outputs", [1, 2, 4, 0, -1, -7])
def test_push_full_clamp_matches_jax(jx, max_outputs):
    """``max_outputs`` drops the clamped-off values of the fill-completing
    push; <= 0 emits nothing; ``samples_output`` counts delivered samples."""
    n = 5
    fj, ft = _filters(jx, n, 3)
    x = _signal(3 * n, 42)
    outs, st_t, _ = _push_both(jx, fj, ft, x, max_outputs=max_outputs)
    # the fill-completing push (#2n+1) clamped, then one centre a push
    delivered = min(n + 1, max(0, max_outputs)) + (
        x.size - (2 * n + 1) if max_outputs > 0 else 0)
    assert outs.numel() == delivered == int(st_t.samples_output)


def test_clamp_counter_counts_delivered():
    n = 6
    s = sgt.SavgolStream(sgt.SavgolConfig(n, 3), device=CPU)
    delivered = sum(s.push_full(float(i), max_outputs=2).numel()
                    for i in range(2 * n + 5))
    assert s.samples_output == delivered == 2 + 4


# -- chunked ---------------------------------------------------------------------


def _chunks_both(jx, fj, ft, x, C, lead_sign=1.0, dtype=torch.float64):
    """stream_process_chunk over x in chunks of C, then the flush, on both
    sides, compared chunk by chunk; returns the port's emissions."""
    _, js, _, jnp = jx
    n = ft.half_window
    st_j = js.chunk_init(n, fj.center_weights.dtype)
    st_t = ts.chunk_init(n, dtype, device=CPU)
    outs = []
    for i in range(0, x.size, C):
        ch = x[i:i + C]
        st_j, oj, cj = js.stream_process_chunk(
            st_j, jnp.asarray(ch), fj.center_weights, fj.edge_weights,
            fj.dt_inv, lead_sign=lead_sign)
        st_t, ot, ct = ts.stream_process_chunk(
            st_t, torch.from_numpy(ch), ft.center_weights, ft.edge_weights,
            ft.dt_inv, lead_sign=lead_sign)
        assert ct == int(cj) and ot.shape == (ch.size + n + 1,)
        _close(ot, oj, dtype)
        _same_state(st_t, st_j)
        outs.append(ot[:ct])
    st_j, oj, cj = js.stream_flush_chunked(st_j, fj.edge_weights, fj.dt_inv)
    st_t, ot, ct = ts.stream_flush_chunked(st_t, ft.edge_weights, ft.dt_inv)
    assert ct == int(cj)
    _close(ot, oj, dtype)
    _same_state(st_t, st_j)
    return torch.cat(outs + [ot[:ct]])


@pytest.mark.parametrize("n,m,T,C", [(6, 3, 200, 32), (5, 2, 101, 17),
                                     (3, 2, 25, 7), (1, 1, 10, 3),
                                     (32, 6, 300, 70), (12, 4, 80, 3),
                                     (6, 3, 40, 1)])
def test_chunked_matches_jax_and_batch(jx, n, m, T, C):
    fj, ft = _filters(jx, n, m)
    x = _signal(T, 0)
    got = _chunks_both(jx, fj, ft, x, C)
    assert got.numel() == T, "conservation"
    _close(got, ft.apply(torch.from_numpy(x)))


def test_chunked_float32_and_derivative_sign(jx):
    fj, ft = _filters(jx, 12, 4, 1, dt=0.01, dtype=torch.float32)
    x = _signal(500, 5, np.float32)
    got = _chunks_both(jx, fj, ft, x, 128, lead_sign=-1.0,
                       dtype=torch.float32)
    _close(got, ft.apply(torch.from_numpy(x)), torch.float32)
    fj, ft = _filters(jx, 5, 2, 1)
    got = _chunks_both(jx, fj, ft, 3.0 * np.arange(40.0), 8, lead_sign=-1.0)
    _close(got, np.full(40, 3.0))


def test_chunked_matches_push_full_schedule():
    """The chunked and per-sample paths emit identical prefixes after every
    chunk boundary."""
    n, C = 4, 5
    x = _signal(37, 1)
    f = sgt.Savgol1D.create(sgt.SavgolConfig(n, 2), torch.float64, device=CPU)
    st_c = ts.chunk_init(n, torch.float64, device=CPU)
    st_p = ts.stream_init(n, torch.float64, device=CPU)
    got_c, got_p = [], []
    for i in range(0, 35, C):
        st_c, o, c = ts.stream_process_chunk(
            st_c, torch.from_numpy(x[i:i + C]), f.center_weights,
            f.edge_weights, f.dt_inv)
        got_c.append(o[:c])
        for v in x[i:i + C]:
            st_p, o, c = ts.stream_push_full(st_p, float(v), f.center_weights,
                                             f.edge_weights, f.dt_inv)
            got_p.append(o[:c])
        _close(torch.cat(got_c), torch.cat(got_p))
        assert int(st_c.samples_output) == int(st_p.samples_output)


def test_model_process_chunked_matches_jax(jx):
    sg, _, _, _ = jx
    x = _signal(130, 9)
    chunks = [x[i:i + 40] for i in range(0, 130, 40)]
    s = sgt.SavgolStream(sgt.SavgolConfig(5, 3, 1), torch.float64, device=CPU)
    got = list(s.process_chunked(chunks))
    sj = sg.SavgolStream(sg.SavgolConfig(5, 3, 1), dtype=jx[3].float64)
    want = list(sj.process_chunked(chunks))
    assert [g.numel() for g in got] == [w.size for w in want]
    _close(torch.cat(got), np.concatenate(want))
    assert s.samples_received == 0     # the object's state is untouched


# -- the compiled reference C stream ----------------------------------------------


def _within_ref(got, theirs):
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == theirs.shape
    scale = max(1.0, np.abs(theirs).max())
    assert np.abs(got - theirs).max() <= 1e-5 * scale


@pytest.mark.parametrize("n,m,d", [(1, 1, 0), (5, 3, 0), (6, 3, 1),
                                   (12, 4, 2), (32, 10, 0)])
def test_push_full_flush_vs_reference_stream(ref, n, m, d):
    x = np.random.default_rng(n * 100 + m).standard_normal(120).astype(
        np.float32)
    f = sgt.Savgol1D.create(sgt.SavgolConfig(n, m, d), torch.float64,
                            device=CPU)
    st = ts.stream_init(n, torch.float64, device=CPU)
    ours = []
    for v in x:
        st, o, c = ts.stream_push_full(st, float(v), f.center_weights,
                                       f.edge_weights, f.dt_inv)
        ours.append(o[:c])
    st, o, c = ts.stream_flush(st, f.center_weights, f.edge_weights, f.dt_inv)
    _within_ref(torch.cat(ours + [o[:c]]), ref.stream_run(x, n, m, d))
    ys = ts.stream_apply(torch.from_numpy(x.astype(np.float64)),
                         f.center_weights, f.edge_weights, half_window=n,
                         dt_inv=f.dt_inv, derivative=d,
                         reference_edge_sign=True)
    _within_ref(ys, ref.apply(x, n, m, d))


@pytest.mark.parametrize("max_outputs", [1, 2, 4])
def test_push_full_clamp_vs_reference(ref, max_outputs):
    n, m = 5, 3
    x = np.random.default_rng(42).standard_normal(30).astype(np.float32)
    theirs, their_counter = ref.stream_run_clamped(
        x, n, m, max_outputs=max_outputs, flush_max=3)
    s = sgt.SavgolStream(sgt.SavgolConfig(n, m), torch.float64, device=CPU)
    ours = [s.push_full(float(v), max_outputs=max_outputs) for v in x]
    ours = torch.cat(ours + [s.flush(max_count=3)])
    assert s.samples_output == their_counter == ours.numel()
    _within_ref(ours, theirs)


def test_chunked_vs_reference_stream(ref):
    n, m = 8, 3
    x = np.random.default_rng(7).standard_normal(143).astype(np.float32)
    s = sgt.SavgolStream(sgt.SavgolConfig(n, m), torch.float64, device=CPU)
    got = torch.cat(list(s.process_chunked(
        [x[i:i + 17] for i in range(0, x.size, 17)])))
    _within_ref(got, ref.stream_run(x, n, m))


# -- checkpoint / resume -----------------------------------------------------------


def _run(f, st, samples):
    outs = []
    for v in samples:
        st, o, c = ts.stream_push_full(st, float(v), f.center_weights,
                                       f.edge_weights, f.dt_inv)
        outs.append(o[:c])
    return st, torch.cat(outs)


def _round_trips(state):
    """The state through pickle and through torch.save / torch.load."""
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    return (pickle.loads(pickle.dumps(state)),
            torch.load(buf, weights_only=False))


def test_stream_resumes_identically():
    x = _signal(60, 0)
    f = sgt.Savgol1D.create(sgt.SavgolConfig(5, 3), torch.float64, device=CPU)
    _, full = _run(f, ts.stream_init(5, torch.float64, device=CPU), x)
    st, first = _run(f, ts.stream_init(5, torch.float64, device=CPU), x[:30])
    for restored in _round_trips(st):
        assert isinstance(restored, ts.StreamState)
        assert int(restored.samples_received) == 30
        assert int(restored.samples_output) == int(st.samples_output)
        _, second = _run(f, restored, x[30:])
        assert torch.equal(torch.cat([first, second]), full)


def test_chunked_state_resumes_identically():
    data = np.random.default_rng(7).standard_normal((6, 256)).astype(
        np.float32)
    f = sgt.Savgol1D.create(sgt.SavgolConfig(6, 3), device=CPU)

    def run(st, chunks):
        outs = []
        for ch in chunks:
            st, o, c = ts.stream_process_chunk(
                st, torch.from_numpy(ch), f.center_weights, f.edge_weights,
                f.dt_inv)
            outs.append(o[:c])
        return st, torch.cat(outs)

    _, full = run(ts.chunk_init(6, device=CPU), data)
    st, first = run(ts.chunk_init(6, device=CPU), data[:3])
    for restored in _round_trips(st):
        assert isinstance(restored, ts.ChunkState)
        # the tail is its own small tensor, not a view of the last chunk
        assert restored.tail.untyped_storage().nbytes() == 13 * 4
        _, second = run(restored, data[3:])
        assert torch.equal(torch.cat([first, second]), full)


def test_jax_stream_state_resumes_in_the_port(jx):
    """A stream checkpointed from the JAX package continues in the port as
    it continues in the JAX package."""
    _, js, jax, _ = jx
    fj, ft = _filters(jx, 5, 3, 1)
    x = _signal(60, 4)
    st_j = js.stream_init(5, dtype=fj.center_weights.dtype)
    for v in x[:27]:
        st_j, _, _ = js.stream_push_full(st_j, float(v), fj.center_weights,
                                         fj.edge_weights, fj.dt_inv)
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(st_j)]
    st_t = ts.stream_state_from_jax(leaves, device=CPU)
    _same_state(st_t, st_j)
    for v in x[27:]:
        st_j, oj, cj = js.stream_push_full(st_j, float(v), fj.center_weights,
                                           fj.edge_weights, fj.dt_inv)
        st_t, ot, ct = ts.stream_push_full(st_t, float(v), ft.center_weights,
                                           ft.edge_weights, ft.dt_inv)
        assert ct == int(cj)
        _close(ot, oj)
        _same_state(st_t, st_j)


def test_jax_chunk_state_resumes_in_the_port(jx):
    _, js, jax, jnp = jx
    fj, ft = _filters(jx, 6, 3, dtype=torch.float32)
    data = np.random.default_rng(8).standard_normal((5, 64)).astype(
        np.float32)
    st_j = js.chunk_init(6, jnp.float32)
    st_j, _, _ = js.stream_process_chunk(st_j, jnp.asarray(data[0]),
                                         fj.center_weights, fj.edge_weights,
                                         fj.dt_inv)
    st_t = ts.chunk_state_from_jax(
        [np.asarray(a) for a in jax.tree_util.tree_leaves(st_j)], device=CPU)
    _same_state(st_t, st_j)
    for ch in data[1:]:
        st_j, oj, cj = js.stream_process_chunk(
            st_j, jnp.asarray(ch), fj.center_weights, fj.edge_weights,
            fj.dt_inv)
        st_t, ot, ct = ts.stream_process_chunk(
            st_t, torch.from_numpy(ch), ft.center_weights, ft.edge_weights,
            ft.dt_inv)
        assert ct == int(cj)
        _close(ot, oj, torch.float32)
        _same_state(st_t, st_j)


# -- on the card ---------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_stream_apply_is_one_k3_launch(cuda):
    f = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4), device=cuda)
    x = torch.from_numpy(_signal(8192, 1, np.float32)).to(cuda)
    cc.reset_launches()
    y = sgt.SavgolStream(f).process(x)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"sg1d_poly": 0, "sg1d_pad": 0, "corr1d_valid": 1}
    want = ts.stream_apply(x.cpu(), f.center_weights.cpu(),
                           f.edge_weights.cpu(), half_window=12)
    _close(y.cpu(), want, torch.float32)


@pytest.mark.cuda
def test_cuda_chunks_and_pushes_match_the_cpu(cuda):
    x = _signal(3000, 2, np.float32)
    chunks = [x[i:i + 512] for i in range(0, x.size, 512)]
    s = sgt.SavgolStream(sgt.SavgolConfig(6, 3, 1, 0.1), device=cuda)
    s_cpu = sgt.SavgolStream(sgt.SavgolConfig(6, 3, 1, 0.1), device=CPU)
    cc.reset_launches()
    got = list(s.process_chunked(chunks))
    torch.cuda.synchronize()
    assert cc.LAUNCHES["corr1d_valid"] == len(chunks)
    want = list(s_cpu.process_chunked(chunks))
    _close(torch.cat(got).cpu(), torch.cat(want), torch.float32)
    got = torch.cat([s.push_full(float(v)) for v in x[:60]] + [s.flush()])
    want = torch.cat([s_cpu.push_full(float(v)) for v in x[:60]]
                     + [s_cpu.flush()])
    _close(got.cpu(), want, torch.float32)
