"""Length -> padding mask.  ``mask[b, t] == True`` means padding."""

from __future__ import annotations

import torch


def mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    ids = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return ids[None, :] >= lengths[:, None]


def apply_mask(x: torch.Tensor, mask: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """Fill masked positions; the mask broadcasts over trailing dims."""
    while mask.dim() < x.dim():
        mask = mask[..., None]
    return x.masked_fill(mask, value)
