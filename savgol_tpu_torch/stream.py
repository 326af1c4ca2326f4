"""Streaming (real-time) Savitzky-Golay filtering on tensors (counterpart of
``savgol_tpu.stream``).

A ring buffer of 2n+1 samples is an explicit, immutable NamedTuple of
tensors (``StreamState``): every push returns a new state and never writes
into the buffer of the state it was given, so two states of one stream can
be held at once, and ``pickle`` / ``torch.save`` checkpoint a stream. The
semantics are the JAX package's, which mirror the reference's streaming
module (src/savgol_stream.c):

  * fixed latency of ``half_window`` samples;
  * ``stream_push`` emits nothing until the buffer holds 2n+1 samples, then
    one centred output per sample;
  * ``stream_push_full`` also emits the n leading-edge outputs and the
    first centre on the push that fills the buffer;
  * ``stream_flush`` emits up to n trailing-edge outputs;
    ``stream_flush_leading`` re-emits the leading edge;
  * conservation: with push_full + flush, total outputs == total inputs.

Functions that emit a variable number of samples return a fixed-size
tensor and a ``count``: only the first ``count`` entries are meaningful.

The buffer (or the chunked stream's tail) lives on the data's device; the
counters are 0-dim int64 tensors on the CPU. The emission schedule is a
function of the counters alone, so the host knows every ``count`` without
waiting for the card, and slicing ``outputs[:count]`` costs no copy back.

The edge sums and the push dot are product-sums, ``(w * x).sum(-1)``, so
TF32 cannot enter them on the card. ``stream_process_chunk`` and
``stream_apply`` compute their centres with one VALID correlation, kernel
K3 on a CUDA tensor (``ops.apply._correlate``) and its plain version on the
CPU, as the JAX package takes its Pallas correlation on the TPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from savgol_tpu_torch._device import card_unless_named
from savgol_tpu_torch.ops.apply import (_check_device, _compute_dtype,
                                        _correlate, _ensure_float)
from savgol_tpu_torch.ops.cuda_conv import _edge_sums, scale_of

__all__ = [
    "StreamState",
    "stream_init",
    "stream_reset",
    "stream_push",
    "stream_push_full",
    "stream_flush",
    "stream_flush_leading",
    "stream_ready",
    "stream_buffered",
    "stream_apply",
    "stream_state_from_jax",
    "ChunkState",
    "chunk_init",
    "stream_process_chunk",
    "stream_flush_chunked",
    "chunk_state_from_jax",
]


class StreamState(NamedTuple):
    """Streaming carry: ring buffer + counters (savgol_stream.h:29-37)."""

    buffer: torch.Tensor            # (2n+1,) ring buffer, on the data's device
    write_pos: torch.Tensor         # next write slot == oldest sample (CPU)
    samples_received: torch.Tensor  # total pushed (CPU)
    samples_output: torch.Tensor    # total emitted (CPU)


def _count(v) -> torch.Tensor:
    """A counter: a 0-dim int64 CPU tensor."""
    return torch.tensor(int(v), dtype=torch.int64)


def stream_init(half_window: int, dtype=torch.float32, *,
                device=None) -> StreamState:
    """Fresh stream state (zeroed ring; savgol_stream_reset,
    src/savgol_stream.c:135-146) on ``device``, by default the card
    (raising without one; pass ``device="cpu"`` for the CPU)."""
    device = card_unless_named(device, "stream_init")
    ws = 2 * int(half_window) + 1
    return StreamState(torch.zeros(ws, dtype=dtype, device=device),
                       _count(0), _count(0), _count(0))


def stream_reset(state: StreamState) -> StreamState:
    return StreamState(torch.zeros_like(state.buffer), _count(0), _count(0),
                       _count(0))


def _write(state: StreamState, sample) -> StreamState:
    ws = state.buffer.shape[0]
    pos = int(state.write_pos)
    buf = state.buffer.clone()           # the given state stays as it was
    buf[pos] = sample
    return state._replace(buffer=buf, write_pos=_count((pos + 1) % ws),
                          samples_received=_count(
                              int(state.samples_received) + 1))


def _aligned(state: StreamState) -> torch.Tensor:
    """Ring contents ordered oldest -> newest: after a write ``write_pos``
    points at the oldest sample (convolve_center_circular,
    src/savgol_stream.c:25-38)."""
    return torch.roll(state.buffer, -int(state.write_pos))


def _emitted(state, count: int):
    return state._replace(
        samples_output=_count(int(state.samples_output) + count))


def stream_ready(state: StreamState) -> bool:
    return int(state.samples_received) >= state.buffer.shape[0]


def stream_buffered(state: StreamState) -> int:
    return min(int(state.samples_received), state.buffer.shape[0])


def _scaled(y: torch.Tensor, dt) -> torch.Tensor:
    """``y * dt``, ``dt`` as :func:`scale_of` gives it (None: ``y``)."""
    return y if dt is None else y * dt


def _center(aligned: torch.Tensor, center_w: torch.Tensor, dt):
    return _scaled((center_w.to(aligned.dtype) * aligned).sum(-1), dt)


def _leading_outputs(aligned, edge_w, dt, lead_sign=1.0):
    """All n leading-edge values: edge row e against the REVERSED window
    (convolve_edge_leading, src/savgol_stream.c:61-74). ``lead_sign``
    corrects the reference's odd-derivative sign flip at the leading edge:
    ``(-1)**derivative`` for the correct sign, 1.0 for reference parity."""
    out = _edge_sums(edge_w.to(aligned.dtype), aligned.flip(-1))
    return out * (lead_sign if dt is None else dt * lead_sign)


def _trailing_outputs(aligned, edge_w, dt):
    """Trailing-edge values in flush order: output i uses edge row n-1-i,
    forward traversal (src/savgol_stream.c:243-248)."""
    return _scaled(_edge_sums(edge_w.to(aligned.dtype), aligned),
                   dt).flip(-1)


def stream_push(
    state: StreamState,
    sample,
    center_w: torch.Tensor,
    dt_inv=1.0,
) -> Tuple[StreamState, torch.Tensor, bool]:
    """Push one sample; returns (state, value, valid). ``value`` (0-dim, on
    the buffer's device) is meaningful only where ``valid`` is True: the
    filling phase emits nothing (src/savgol_stream.c:152-178)."""
    state = _write(state, sample)
    valid = stream_ready(state)
    if valid:
        a = _aligned(state)
        value = _center(a, center_w, scale_of(dt_inv, a))
    else:
        value = state.buffer.new_zeros(())
    return _emitted(state, int(valid)), value, valid


def _clamped(outputs: torch.Tensor, count: int, limit) -> tuple:
    """(outputs, count) with count clamped to ``limit`` (None: no clamp;
    <= 0 emits nothing, as the C returns 0 outputs, src/savgol_stream.c:183)
    and the entries past it zeroed."""
    if limit is not None:
        count = min(count, max(0, int(limit)))
    if count < outputs.shape[0]:
        outputs = F.pad(outputs[:count], (0, outputs.shape[0] - count))
    return outputs, count


def stream_push_full(
    state: StreamState,
    sample,
    center_w: torch.Tensor,
    edge_w: torch.Tensor,
    dt_inv=1.0,
    lead_sign: float = 1.0,
    max_outputs: Optional[int] = None,
) -> Tuple[StreamState, torch.Tensor, int]:
    """Push with full edge handling; returns (state, outputs, count).

    ``outputs`` has fixed shape (n+1,). count == 0 while filling; n+1 on
    the fill-completing push (n leading-edge values, then the first
    centre); 1 afterwards (src/savgol_stream.c:180-227).

    ``max_outputs`` reproduces the C API's buffer-capacity clamp
    (src/savgol_stream.c:208-218): on the fill-completing push only the
    first ``max_outputs`` values are emitted, the rest are dropped (never
    re-emitted), and ``samples_output`` counts only delivered samples.
    """
    ws = state.buffer.shape[0]
    n = (ws - 1) // 2
    was_filling = int(state.samples_received) < ws
    state = _write(state, sample)
    if not stream_ready(state):
        outputs, count = state.buffer.new_zeros(n + 1), 0
    else:
        a = _aligned(state)
        dt = scale_of(dt_inv, a)
        center = _center(a, center_w, dt)[None]
        if was_filling:
            outputs = torch.cat([_leading_outputs(a, edge_w, dt, lead_sign),
                                 center])
            count = n + 1
        else:
            outputs, count = F.pad(center, (0, n)), 1
    outputs, count = _clamped(outputs, count, max_outputs)
    return _emitted(state, count), outputs, count


def _edge_flush(state: StreamState, max_count, values) -> tuple:
    """(state, outputs, count) of a flush: ``values()`` (the n edge values
    of the aligned ring) cut to ``max_count`` clamped to [0, n], or as many
    zeros and count 0 if the buffer never filled."""
    n = (state.buffer.shape[0] - 1) // 2
    k = n if max_count is None else min(max(0, int(max_count)), n)
    if not stream_ready(state):
        return state, state.buffer.new_zeros(k), 0
    return _emitted(state, k), values(_aligned(state))[:k], k


def stream_flush(
    state: StreamState,
    center_w: torch.Tensor,
    edge_w: torch.Tensor,
    dt_inv=1.0,
    max_count: Optional[int] = None,
) -> Tuple[StreamState, torch.Tensor, int]:
    """Trailing-edge flush at the end of a stream; returns (state, outputs,
    count). ``outputs`` has shape (min(max_count, n),); count is 0 if the
    buffer never filled (src/savgol_stream.c:229-252)."""
    del center_w  # kept for API symmetry
    return _edge_flush(state, max_count, lambda a: _trailing_outputs(
        a, edge_w, scale_of(dt_inv, a)))


def stream_flush_leading(
    state: StreamState,
    edge_w: torch.Tensor,
    dt_inv=1.0,
    max_count: Optional[int] = None,
    lead_sign: float = 1.0,
) -> Tuple[StreamState, torch.Tensor, int]:
    """Leading-edge flush (src/savgol_stream.c:254-275)."""
    return _edge_flush(state, max_count, lambda a: _leading_outputs(
        a, edge_w, scale_of(dt_inv, a), lead_sign))


def stream_apply(
    x: torch.Tensor,
    center_w: torch.Tensor,
    edge_w: torch.Tensor,
    *,
    half_window: int,
    dt_inv=1.0,
    derivative: int = 0,
    reference_edge_sign: bool = False,
) -> torch.Tensor:
    """Whole-sequence online processing: the push_full + flush protocol over
    a length-T sequence (T >= 2n+1), stitched into a length-T output.

    The emission schedule is fixed (push #(2n+1) emits n+1 values, every
    later push 1, the flush n) and every emission is a pure function of one
    window, so the output is stitched directly: the n leading-edge values
    of the first window, the T - 2n centres, which are ONE VALID
    correlation (kernel K3 on a CUDA tensor, a single launch where the JAX
    package scans T pushes), and the n trailing values of the last window.
    The per-sample pushes are its test oracle.
    """
    if x.dim() != 1:
        raise ValueError(
            f"stream_apply processes ONE sequence (got shape "
            f"{tuple(x.shape)}); use the batch apply for batches, or the "
            f"chunked stream")
    n = int(half_window)
    ws = 2 * n + 1
    T = x.shape[-1]
    if T < ws:
        raise ValueError(f"stream_apply needs at least {ws} samples, got {T}")
    _check_device(x, center_w, edge_w)
    lead_sign = 1.0
    if not reference_edge_sign and int(derivative) % 2 == 1:
        lead_sign = -1.0
    x, restore = _compute_dtype(_ensure_float(x, center_w))
    dt = scale_of(dt_inv, x)
    centers = _scaled(_correlate(x[None], center_w, kernel=True)[0], dt)
    y = torch.cat([_leading_outputs(x[:ws], edge_w, dt, lead_sign), centers,
                   _trailing_outputs(x[T - ws:], edge_w, dt)])
    return y.to(restore) if restore is not None else y


def stream_state_from_jax(arrays: Sequence[np.ndarray], *,
                          device) -> StreamState:
    """The port's state from a ``savgol_tpu.stream.StreamState``'s leaves,
    given as numpy arrays in pytree order (buffer, write_pos,
    samples_received, samples_output): a stream checkpointed from the JAX
    package resumes here. The buffer keeps its dtype."""
    buffer, write_pos, received, output = arrays
    # np.array copies: arrays handed over from JAX are read-only
    return StreamState(torch.as_tensor(np.array(buffer), device=device),
                       _count(write_pos), _count(received), _count(output))


# -- chunked streaming ---------------------------------------------------------


class ChunkState(NamedTuple):
    """Carry for chunked streaming: the last 2n+1 samples + counters."""

    tail: torch.Tensor              # (2n+1,) most recent samples, oldest first
    samples_received: torch.Tensor  # CPU
    samples_output: torch.Tensor    # CPU


def chunk_init(half_window: int, dtype=torch.float32, *,
               device=None) -> ChunkState:
    """Fresh chunked-streaming state on ``device``, by default the card
    (raising without one; pass ``device="cpu"`` for the CPU)."""
    device = card_unless_named(device, "chunk_init")
    return ChunkState(
        torch.zeros(2 * int(half_window) + 1, dtype=dtype, device=device),
        _count(0), _count(0))


def stream_process_chunk(
    state: ChunkState,
    chunk,
    center_w: torch.Tensor,
    edge_w: torch.Tensor,
    dt_inv=1.0,
    lead_sign: float = 1.0,
) -> Tuple[ChunkState, torch.Tensor, int]:
    """High-throughput streaming: a whole chunk per call.

    The same emissions as :func:`stream_push_full` for every sample of
    ``chunk`` (nothing until 2n+1 samples have arrived, then the n
    leading-edge values and the first centre, then one centre per sample),
    computed with ONE VALID correlation over the previous 2n+1 samples and
    the chunk (kernel K3 on a CUDA tensor), so throughput follows the batch
    path while latency stays bounded by the chunk size + half_window.
    ``chunk`` is placed on the state's device in its dtype.

    Returns ``(state, outputs, count)``; ``outputs`` has fixed shape
    ``(len(chunk) + half_window + 1,)`` and only ``outputs[:count]`` is
    meaningful. Finish the stream with :func:`stream_flush_chunked`.
    """
    ws = state.tail.shape[0]
    n = (ws - 1) // 2
    chunk = torch.as_tensor(chunk, dtype=state.tail.dtype,
                            device=state.tail.device)
    C = chunk.shape[0]
    dt = scale_of(dt_inv, state.tail)
    t0 = int(state.samples_received)
    t1 = t0 + C

    # ext[i] = stream sample t0 - ws + i (zeros where negative); the window
    # starting at ext index i is centred at p(i) = t0 - n - 1 + i
    ext = torch.cat([state.tail, chunk])
    centers = _scaled(_correlate(ext[None], center_w, kernel=True)[0],
                      dt)                                          # (C+1,)

    # centre p is emitted once p + n + 1 samples exist: this chunk emits
    # p in [max(n, t0 - n), t1 - 1 - n]
    first_center = max(t0 - n, n)
    n_centers = min(max(t1 - n - first_center, 0), C)
    coff = first_center - (t0 - n - 1)
    parts = []
    if t0 < ws <= t1:
        # the fill point is crossed: the leading edge of the first ws
        # stream samples, at ext positions [ws - t0, 2 ws - t0)
        first_win = ext[ws - t0:2 * ws - t0]
        parts.append(_leading_outputs(first_win, edge_w, dt, lead_sign))
    parts.append(centers[coff:coff + n_centers])
    out = torch.cat(parts)
    count = out.shape[0]
    out = F.pad(out, (0, C + n + 1 - count))
    # clone: a view would keep the whole ext (and a checkpoint of it) alive
    state = ChunkState(ext[-ws:].clone(), _count(t1),
                       _count(int(state.samples_output) + count))
    return state, out, count


def stream_flush_chunked(
    state: ChunkState,
    edge_w: torch.Tensor,
    dt_inv=1.0,
) -> Tuple[ChunkState, torch.Tensor, int]:
    """Trailing-edge flush for the chunked stream (mirrors
    :func:`stream_flush`): n outputs over the last full window, or n zeros
    and count 0 if fewer than 2n+1 samples arrived."""
    ws = state.tail.shape[0]
    n = (ws - 1) // 2
    if int(state.samples_received) < ws:
        return state, state.tail.new_zeros(n), 0
    trail = _trailing_outputs(state.tail, edge_w,
                              scale_of(dt_inv, state.tail))
    return state._replace(samples_output=_count(
        int(state.samples_output) + n)), trail, n


def chunk_state_from_jax(arrays: Sequence[np.ndarray], *,
                         device) -> ChunkState:
    """The port's chunked state from a ``savgol_tpu.stream.ChunkState``'s
    leaves, as numpy arrays in pytree order (tail, samples_received,
    samples_output)."""
    tail, received, output = arrays
    return ChunkState(torch.as_tensor(np.array(tail), device=device),
                      _count(received), _count(output))
