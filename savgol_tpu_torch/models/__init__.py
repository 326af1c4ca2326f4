"""Filter modules mirroring the reference's create/apply lifecycle
(counterpart of ``savgol_tpu.models``: the 1D and 2D filters, the 1D filter
bank and the stream)."""

from savgol_tpu_torch.models.bank import SavgolBank
from savgol_tpu_torch.models.filter1d import Savgol1D
from savgol_tpu_torch.models.filter2d import Savgol2D
from savgol_tpu_torch.models.streaming import SavgolStream

__all__ = ["Savgol1D", "Savgol2D", "SavgolBank", "SavgolStream"]
