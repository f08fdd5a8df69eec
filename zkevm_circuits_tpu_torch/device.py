"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for another device;
with no card present they raise instead of falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`None` means the card.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
