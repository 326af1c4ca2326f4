"""Filter modules mirroring the reference's create/apply lifecycle
(counterpart of ``savgol_tpu.models``; only the 1D filter is ported)."""

from savgol_tpu_torch.models.filter1d import Savgol1D

__all__ = ["Savgol1D"]
