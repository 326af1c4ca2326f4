"""Stateful convenience wrapper around the functional streaming core
(counterpart of ``savgol_tpu.models.streaming``).

:mod:`savgol_tpu_torch.stream` is the implementation (immutable states,
checkpointable); this class offers the reference's imperative surface
(push / push_full / flush / reset / queries, savgol_stream.h) by threading
a ``StreamState`` through the functional ops. Emissions come back as
tensors on the stream's device, so a push does not wait for the card.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import torch

from savgol_tpu_torch import stream as fstream
from savgol_tpu_torch._device import card_unless_named
from savgol_tpu_torch.config import SavgolConfig
from savgol_tpu_torch.models.filter1d import Savgol1D

__all__ = ["SavgolStream"]


class SavgolStream:
    """Real-time sample-by-sample filter with fixed latency half_window.

    Create from a config (a fresh :class:`Savgol1D` on ``device``, by
    default the card, raising without one) or attach to an existing filter,
    whose device the stream takes (``savgol_stream_create`` /
    ``savgol_stream_init``, src/savgol_stream.c:80-120). ``dtype`` is the
    dtype of the stream's samples and emissions.
    """

    def __init__(self, config_or_filter, dtype=torch.float32, *,
                 device=None):
        if isinstance(config_or_filter, SavgolConfig):
            device = card_unless_named(device, "SavgolStream")
            self.filter = Savgol1D.create(config_or_filter, dtype=dtype,
                                          device=device)
        elif isinstance(config_or_filter, Savgol1D):
            if device is not None:
                raise ValueError(
                    "a stream on an existing Savgol1D runs on that filter's "
                    "device: move the filter with .to() instead of passing "
                    "device=")
            self.filter = config_or_filter
        else:
            raise TypeError(
                "expected SavgolConfig or Savgol1D, got "
                f"{type(config_or_filter)!r}")
        self._dtype = dtype
        self._device = self.filter.center_weights.device
        # the correct leading-edge sign for odd derivatives (the reference
        # flips it; see savgol_tpu_torch.ops.apply)
        d = self.filter.config.derivative
        self._lead_sign = -1.0 if d % 2 == 1 else 1.0
        self.state = fstream.stream_init(self.filter.half_window, dtype,
                                         device=self._device)

    # -- queries (src/savgol_stream.c:281-315) --------------------------------

    @property
    def ready(self) -> bool:
        return fstream.stream_ready(self.state)

    @property
    def latency(self) -> int:
        return self.filter.half_window

    @property
    def buffered(self) -> int:
        return fstream.stream_buffered(self.state)

    @property
    def samples_received(self) -> int:
        return int(self.state.samples_received)

    @property
    def samples_output(self) -> int:
        return int(self.state.samples_output)

    # -- operation -------------------------------------------------------------

    def reset(self) -> None:
        self.state = fstream.stream_reset(self.state)

    def push(self, sample) -> Tuple[torch.Tensor, bool]:
        """Push one sample; returns (value, valid), ``value`` a 0-dim tensor
        on the stream's device."""
        self.state, value, valid = fstream.stream_push(
            self.state, sample, self.filter.center_weights,
            self.filter.dt_inv)
        return value, valid

    def push_full(self, sample,
                  max_outputs: Optional[int] = None) -> torch.Tensor:
        """Push with edge handling; returns the emitted samples (possibly
        none). ``max_outputs`` clamps like the C API: values clamped off the
        fill-completing push are dropped, and ``samples_output`` counts only
        delivered samples (src/savgol_stream.c:208-227)."""
        self.state, outs, count = fstream.stream_push_full(
            self.state, sample, self.filter.center_weights,
            self.filter.edge_weights, self.filter.dt_inv,
            lead_sign=self._lead_sign, max_outputs=max_outputs)
        return outs[:count]

    def flush(self, max_count: Optional[int] = None) -> torch.Tensor:
        """Trailing-edge flush; returns the emitted samples."""
        self.state, outs, count = fstream.stream_flush(
            self.state, self.filter.center_weights,
            self.filter.edge_weights, self.filter.dt_inv,
            max_count=max_count)
        return outs[:count]

    def flush_leading(self, max_count: Optional[int] = None) -> torch.Tensor:
        self.state, outs, count = fstream.stream_flush_leading(
            self.state, self.filter.edge_weights, self.filter.dt_inv,
            max_count=max_count, lead_sign=self._lead_sign)
        return outs[:count]

    def process_chunked(self, chunks: Iterable) -> Iterator[torch.Tensor]:
        """Chunked processing at batch-path throughput (see
        ``stream_process_chunk``, one K3 launch a chunk on the card): yields
        each chunk's emissions, then the final flush. Does not touch this
        object's state."""
        st = fstream.chunk_init(self.filter.half_window, self._dtype,
                                device=self._device)
        cw, ew = self.filter.center_weights, self.filter.edge_weights
        for ch in chunks:
            st, o, c = fstream.stream_process_chunk(
                st, ch, cw, ew, self.filter.dt_inv,
                lead_sign=self._lead_sign)
            yield o[:c]
        st, o, c = fstream.stream_flush_chunked(st, ew, self.filter.dt_inv)
        yield o[:c]

    def process(self, x) -> torch.Tensor:
        """Whole-sequence online processing (``stream_apply``, one K3 launch
        on the card); returns a same-length filtered tensor and does not
        touch this object's state."""
        return fstream.stream_apply(
            torch.as_tensor(x, dtype=self._dtype, device=self._device),
            self.filter.center_weights, self.filter.edge_weights,
            half_window=self.filter.half_window, dt_inv=self.filter.dt_inv,
            derivative=self.filter.config.derivative)
