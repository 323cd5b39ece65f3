"""Probabilistic Variance Adaptor: flow-matching vector fields over
log(duration + 1), one for phone durations and one for trailing silences.

Kept from the reference: the second conv has a literal ``padding=1``,
which is SAME padding only because the kernel size is 3.  In train mode a
dropout follows each LayerNorm.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from flamed_tts_tpu_torch.ops.dropout import Dropout
from flamed_tts_tpu_torch.ops.embeddings import flow_time_embedding


class FlowTimeEmbedding(nn.Module):
    """sinusoid [sin | cos], scale 1000 -> Linear -> SiLU -> Linear."""

    def __init__(self, hidden_dim: int, time_scale: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.mlp_1 = nn.Linear(hidden_dim, hidden_dim * time_scale)
        self.mlp_3 = nn.Linear(hidden_dim * time_scale, hidden_dim)

    def forward(self, t: Tensor) -> Tensor:
        return self.mlp_3(F.silu(self.mlp_1(flow_time_embedding(t, self.hidden_dim))))


class ProbabilisticModule(nn.Module):
    """Vector field v(x_t, encoder output, t)."""

    def __init__(self, input_size: int, filter_size: int, kernel_size: int = 3, time_scale: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        k = kernel_size
        self.proj = nn.Linear(input_size + 1, input_size)
        self.time_emb = FlowTimeEmbedding(input_size, time_scale)
        self.conv1d_1 = nn.Conv1d(input_size, filter_size, k, padding=(k - 1) // 2)
        self.layer_norm_1 = nn.LayerNorm(filter_size, eps=1e-5)
        self.conv1d_2 = nn.Conv1d(filter_size, filter_size, k, padding=1)
        self.layer_norm_2 = nn.LayerNorm(filter_size, eps=1e-5)
        self.dropout = Dropout(dropout)
        self.linear_layer = nn.Linear(filter_size, 1)

    def forward(self, xt: Tensor, enc_out: Tensor, t: Tensor, pad_mask: Optional[Tensor]) -> Tensor:
        """xt (B, L), enc_out (B, L, H), t scalar or (B,) -> (B, L)."""
        out = self.proj(torch.cat([xt[..., None], enc_out], dim=-1))
        out = out + self.time_emb(t)[..., None, :]

        def conv(layer, h):
            # zero the pads so the conv at the true boundary sees zeros
            if pad_mask is not None:
                h = h.masked_fill(pad_mask[..., None], 0.0)
            return layer(h.transpose(1, 2)).transpose(1, 2)

        out = self.dropout(self.layer_norm_1(F.relu(conv(self.conv1d_1, out))))
        out = self.dropout(self.layer_norm_2(F.relu(conv(self.conv1d_2, out))))
        out = self.linear_layer(out)[..., 0]
        if pad_mask is not None:
            out = out.masked_fill(pad_mask, 0.0)
        return out
