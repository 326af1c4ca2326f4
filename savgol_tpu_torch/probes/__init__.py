"""Attribution probes, runnable on the card.

``bf16_1d`` (P3) splits K3-bf16's time (the bf16 VALID 1D correlation on
the tensor-core tile) into the staging ring's bytes, the halo and shifted
stores, the products and the halo's loads; ``rowband2d`` (P2) splits
K6a-bf16's (the bf16 dense 2D correlation) into the input-side shift of
the stencil's rows and the per-tile cost; ``dma1d`` (P1) runs the VALID 1D
correlation with the next tile's loads in flight (``cp.async``) while the
taps run, beside K3. Each P3 variant is K3-bf16's kernel with one cost term
removed (``csrc/probe_bf16_1d.cu``), P2's ``B_alignctl`` an instance of
K6a-bf16's (``csrc/corr2d_bf16_mma.cu``), P1 a kernel of its own
(``csrc/probe_dma1d.cu``), each with a plain PyTorch version that defines
its values. Run them as ``python -m savgol_tpu_torch.probes.bf16_1d`` and
``python -m savgol_tpu_torch.probes.rowband2d`` (and ``.dma1d``) on a
machine with a card. ``trace_loss`` counts the ``torch.profiler`` sessions
that lose the card's activity, the ones ``utils.profiling.trace_events``
takes again.
"""
