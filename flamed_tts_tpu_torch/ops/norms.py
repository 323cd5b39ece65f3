"""Mask-aware normalization over channel-last (B, L, C) tensors.

GroupNorm statistics span time, so under bucket padding they are taken
over the valid frames only; with ``pad_mask=None`` these are the plain
ops.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor, nn


def masked_group_norm(x: Tensor, num_groups: int, weight: Tensor, bias: Tensor,
                      pad_mask: Optional[Tensor] = None, eps: float = 1e-5) -> Tensor:
    """GroupNorm over (group channels x valid time); True in pad_mask = pad."""
    b, l, c = x.shape
    xg = x.reshape(b, l, num_groups, c // num_groups).float()
    if pad_mask is not None:
        valid = (~pad_mask)[:, :, None, None].float()
        n = torch.clamp(valid.sum(dim=1, keepdim=True) * (c // num_groups), min=1.0)
        mean = (xg * valid).sum(dim=(1, 3), keepdim=True) / n
        var = (((xg - mean) ** 2) * valid).sum(dim=(1, 3), keepdim=True) / n
    else:
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    out = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, l, c).to(x.dtype)
    out = out * weight + bias
    if pad_mask is not None:
        out = out.masked_fill(pad_mask[:, :, None], 0.0)
    return out


class MaskedGroupNorm(nn.Module):
    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: Tensor, pad_mask: Optional[Tensor] = None) -> Tensor:
        return masked_group_norm(x, self.num_groups, self.weight, self.bias, pad_mask, self.eps)


def layer_norm_noaffine(x: Tensor, eps: float = 1e-6) -> Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)
