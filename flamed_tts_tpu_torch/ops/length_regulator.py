"""Length regulation with silence interleaving, as a static-shape gather.

The repeat vector is [d_0, s_0, d_1, s_1, ...] (phone durations d >= 1,
trailing silences s >= 0, padded phonemes 0); output slot j takes the
segment #{i : cumsum[i] <= j}.  Silence frames copy the utterance's first
encoded frame; slots past the target length are zero.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor


def interleaved_repeats(phone_dur: Tensor, sil_dur: Tensor, src_lens: Tensor) -> Tensor:
    """(B, 2L) int32 interleaved [phone, sil] repeat counts."""
    b, l = phone_dur.shape
    valid = torch.arange(l, device=phone_dur.device)[None, :] < src_lens[:, None]
    phone_rep = torch.clamp(torch.round(phone_dur.float()), min=1).masked_fill(~valid, 0)
    sil_rep = torch.clamp(torch.round(sil_dur.float()), min=0).masked_fill(~valid, 0)
    return torch.stack([phone_rep, sil_rep], dim=2).reshape(b, 2 * l).to(torch.int32)


def length_regulate(x: Tensor, phone_dur: Tensor, sil_dur: Tensor, src_lens: Tensor,
                    max_len: int) -> Tuple[Tensor, Tensor]:
    """(B, L, H) -> ((B, max_len, H), tgt_len clipped to max_len)."""
    b, l, h = x.shape
    csum = torch.cumsum(interleaved_repeats(phone_dur, sil_dur, src_lens), dim=1)
    tgt_len = torch.clamp(csum[:, -1], max=max_len)
    slots = torch.arange(max_len, device=x.device, dtype=csum.dtype)
    seg = torch.searchsorted(csum, slots.expand(b, max_len).contiguous(), right=True)
    seg = torch.clamp(seg, max=2 * l - 1)
    src_idx = torch.where(seg % 2 == 1, torch.zeros_like(seg), seg // 2)
    out = torch.gather(x, 1, src_idx[:, :, None].expand(b, max_len, h))
    out = out.masked_fill((slots[None, :] >= tgt_len[:, None])[:, :, None], 0.0)
    return out, tgt_len
