"""Attribution probes, runnable on the card.

``bf16_1d`` (P3) splits the bf16 VALID 1D correlation's time into bytes,
halo staging and FMAs; ``rowband2d`` (P2) splits the bf16 dense 2D
correlation's into walking the stencil's staged rows and the per-tile cost;
``dma1d`` (P1) runs the VALID 1D correlation with the next tile's loads in
flight (``cp.async``) while the taps run, beside K3, which overlaps none.
Each variant is a hand-written CUDA kernel (``csrc/probe_bf16_1d.cu``,
``csrc/probe_rowband2d.cu``, ``csrc/probe_dma1d.cu``) with a plain PyTorch
version that defines its values. Run them as ``python -m savgol_tpu_torch.probes.bf16_1d`` and
``python -m savgol_tpu_torch.probes.rowband2d`` (and ``.dma1d``) on a
machine with a card.
"""
