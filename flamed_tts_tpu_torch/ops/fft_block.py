"""FFT blocks: post-LN masked self-attention + conv feed-forward.

Masking uses a large negative fill instead of -inf, so fully masked
padding rows give finite values that are then zeroed.  In train mode a
dropout follows the attention's output projection and the conv-FFN, before
each residual LayerNorm.  Submodule names follow the JAX package's
parameter names (``convert.py`` maps them).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from flamed_tts_tpu_torch import precision
from flamed_tts_tpu_torch.ops.dropout import Dropout
from flamed_tts_tpu_torch.ops.masking import apply_mask

_NEG_INF = -1e9


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int, dropout: float = 0.0):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = precision.Linear(d_model, n_head * d_k)
        self.w_ks = precision.Linear(d_model, n_head * d_k)
        self.w_vs = precision.Linear(d_model, n_head * d_v)
        self.fc = precision.Linear(n_head * d_v, d_model)
        self.dropout = Dropout(dropout)
        self.layer_norm = precision.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: Tensor, attn_mask: Optional[Tensor]) -> Tensor:
        """attn_mask: (B, Lk) or (B, Lq, Lk), True = disallowed key."""
        b, l, _ = x.shape
        xo = precision.operand(x)  # cast once for the three projections
        q = self.w_qs(xo).view(b, l, self.n_head, self.d_k).transpose(1, 2)
        k = self.w_ks(xo).view(b, l, self.n_head, self.d_k).transpose(1, 2)
        v = self.w_vs(xo).view(b, l, self.n_head, self.d_v).transpose(1, 2)
        scores = precision.matmul(q, k.transpose(-1, -2)) / np.sqrt(self.d_k)
        if attn_mask is not None:
            m = attn_mask[:, None, None, :] if attn_mask.dim() == 2 else attn_mask[:, None]
            scores = scores.masked_fill(m, _NEG_INF)
        out = precision.matmul(torch.softmax(scores, dim=-1), v)
        out = out.transpose(1, 2).reshape(b, l, self.n_head * self.d_v)
        return self.layer_norm(self.dropout(self.fc(out)) + x)


class ConvFeedForward(nn.Module):
    def __init__(self, d_in: int, d_hid: int, kernel_sizes: Sequence[int], dropout: float = 0.0):
        super().__init__()
        k0, k1 = kernel_sizes
        self.w_1 = precision.Conv1d(d_in, d_hid, k0, padding=(k0 - 1) // 2)
        self.w_2 = precision.Conv1d(d_hid, d_in, k1, padding=(k1 - 1) // 2)
        self.dropout = Dropout(dropout)
        self.layer_norm = precision.LayerNorm(d_in, eps=1e-5)

    def forward(self, x: Tensor) -> Tensor:
        out = self.w_2(F.relu(self.w_1(x.transpose(1, 2)))).transpose(1, 2)
        return self.layer_norm(self.dropout(out) + x)


class FFTBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, d_k: int, d_v: int, d_inner: int,
                 kernel_sizes: Sequence[int], dropout: float = 0.0):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v, dropout)
        self.pos_ffn = ConvFeedForward(d_model, d_inner, kernel_sizes, dropout)

    def forward(self, x: Tensor, pad_mask: Tensor) -> Tensor:
        # key-padding mask only: padded query rows are zeroed afterwards
        out = apply_mask(self.slf_attn(x, pad_mask), pad_mask)
        return apply_mask(self.pos_ffn(out), pad_mask)
