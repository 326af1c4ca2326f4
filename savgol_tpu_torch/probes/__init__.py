"""Attribution probes of the bf16 kernels, runnable on the card.

``bf16_1d`` (P3) splits the bf16 VALID 1D correlation's time into bytes,
halo staging and FMAs; ``rowband2d`` (P2) splits the bf16 dense 2D
correlation's into walking the stencil's staged rows and the per-tile cost.
Each variant is a hand-written CUDA kernel (``csrc/probe_bf16_1d.cu``,
``csrc/probe_rowband2d.cu``) with a plain PyTorch version that defines its
values. Run them as ``python -m savgol_tpu_torch.probes.bf16_1d`` and
``python -m savgol_tpu_torch.probes.rowband2d`` on a machine with a card.
"""
