"""1-D convolutions over channel-last (B, L, C) tensors, torch weight
layouts: conv1d (out, in/groups, k), conv_transpose1d (in, out/groups, k).
Outputs are contiguous (B, L, C).  The parameter type is the precision
knob (``cast_inference_params``): an input of another type is cast to the
weight's, so a bfloat16 codec accepts float32 inputs."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    if x.dtype != weight.dtype:
        x = x.to(weight.dtype)
    out = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride, padding=padding,
                   dilation=dilation, groups=groups)
    return out.transpose(1, 2).contiguous()


def conv_transpose1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    output_padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    if x.dtype != weight.dtype:
        x = x.to(weight.dtype)
    out = F.conv_transpose1d(
        x.transpose(1, 2), weight, bias, stride=stride, padding=padding,
        output_padding=output_padding, groups=groups,
    )
    return out.transpose(1, 2).contiguous()


def replicate_pad(x: torch.Tensor, pad_lo: int, pad_hi: int) -> torch.Tensor:
    """Edge-replicate padding along the length axis of (B, L, C)."""
    length = x.shape[1]
    idx = torch.arange(-pad_lo, length + pad_hi, device=x.device).clamp(0, length - 1)
    return x.index_select(1, idx)
