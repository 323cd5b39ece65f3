"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises when CUDA is asked for (or
    defaulted to) and no card is present: the port never drops to the CPU
    on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
