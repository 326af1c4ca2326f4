"""The port's rule for a device the caller did not name: the card.

Entry points that create tensors from host data take ``device=`` (or
``device_type=``); ``None`` means ``"cuda"``. Without a card that default
raises and names the argument that selects the CPU, so nothing computes on
the CPU unless the caller asked for it.
"""

from __future__ import annotations

import torch

__all__ = ["card_unless_named"]


def card_unless_named(device, what: str, arg: str = "device"):
    """``device`` as given, or ``"cuda"`` for None; raises RuntimeError for
    None when ``torch.cuda.is_available()`` is False, naming
    ``arg="cpu"``."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the card by default, and "
            f"torch.cuda.is_available() is False: pass {arg}=\"cpu\" to "
            f"compute on the CPU")
    return "cuda"
