"""ConvNeXt / adaLN denoiser blocks, channel-last and mask-aware.

GELU is the exact (erf) form; ResBlock LayerNorms are affine with eps
1e-6, FinalLayer norms have no affine; adaLN modulation order is
(shift_conv, scale_conv, gate_conv, shift_mlp, scale_mlp[, gate_mlp]).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from flamed_tts_tpu_torch import precision
from flamed_tts_tpu_torch.ops.embeddings import dit_timestep_embedding
from flamed_tts_tpu_torch.ops.norms import MaskedGroupNorm, layer_norm_noaffine


def modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    return x * (1.0 + scale) + shift


class DepthwiseConv1D(nn.Conv1d):
    """Per-channel conv along time (zero padding, cross-correlation) over
    channel-last input."""

    def __init__(self, channels: int, kernel: int, padding: int):
        if 2 * padding != kernel - 1:
            raise ValueError(
                f"DepthwiseConv1D keeps the length only with 2*padding == kernel-1, "
                f"got kernel={kernel} padding={padding}"
            )
        super().__init__(channels, channels, kernel, padding=padding, groups=channels)

    def forward(self, x: Tensor) -> Tensor:
        # float32 under either precision: the JAX package's depthwise conv is
        # a sum of shifted products, not a dot
        return F.conv1d(x.transpose(1, 2), precision.widen(self.weight, x),
                        precision.widen(self.bias, x), padding=self.padding,
                        groups=self.groups).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.freq = frequency_embedding_size
        self.mlp_0 = precision.Linear(frequency_embedding_size, hidden_size)
        self.mlp_2 = precision.Linear(hidden_size, hidden_size)

    def forward(self, t: Tensor) -> Tensor:
        return self.mlp_2(F.silu(self.mlp_0(dit_timestep_embedding(t, self.freq))))


class ConvNeXtBlock(nn.Module):
    def __init__(self, channels: int, kernel: int = 31, padding: int = 15,
                 expand: int = 1, groups: Optional[int] = None):
        super().__init__()
        if groups not in (None, channels):
            raise ValueError("only depthwise ConvNeXt convs (groups=None) are supported")
        self.conv_1 = DepthwiseConv1D(channels, kernel, padding)
        self.ln_1 = MaskedGroupNorm(channels, channels)
        self.conv_2 = precision.Linear(channels, channels * expand)
        self.conv_3 = precision.Linear(channels * expand, channels)

    def forward(self, x: Tensor, pad_mask: Optional[Tensor] = None) -> Tensor:
        h = x if pad_mask is None else x.masked_fill(pad_mask[:, :, None], 0.0)
        h = self.ln_1(self.conv_1(h), pad_mask)
        return x + self.conv_3(F.gelu(self.conv_2(h)))


class AdaLNResBlock(nn.Module):
    def __init__(self, channels: int, kernel: int = 31, padding: int = 15,
                 expand: int = 1, groups: Optional[int] = None):
        super().__init__()
        self.adaLN_modulation = precision.Linear(channels, 6 * channels)
        self.ln_conv = precision.LayerNorm(channels, eps=1e-6)
        self.conv_in = ConvNeXtBlock(channels, kernel, padding, expand, groups)
        self.ln_mlp = precision.LayerNorm(channels, eps=1e-6)
        self.mlp_0 = precision.Linear(channels, channels)
        self.mlp_2 = precision.Linear(channels, channels)

    def mods(self, y: Tensor) -> Tensor:
        return self.adaLN_modulation(F.silu(y))

    def forward(self, x: Tensor, mods: Tensor, pad_mask: Optional[Tensor] = None) -> Tensor:
        shift_c, scale_c, gate_c, shift_m, scale_m, gate_m = mods.chunk(6, dim=-1)
        x = x + gate_c * self.conv_in(modulate(self.ln_conv(x), shift_c, scale_c), pad_mask)
        h = self.mlp_2(F.silu(self.mlp_0(modulate(self.ln_mlp(x), shift_m, scale_m))))
        return x + gate_m * h


class FinalLayer(nn.Module):
    def __init__(self, model_channels: int, out_channels: int, kernel: int = 31,
                 padding: int = 15, expand: int = 1, groups: Optional[int] = None):
        super().__init__()
        self.adaLN_modulation = precision.Linear(model_channels, 5 * model_channels)
        self.conv_in = ConvNeXtBlock(model_channels, kernel, padding, expand, groups)
        self.conv_out = precision.Conv1d(model_channels, out_channels, 3, padding=1)

    def mods(self, c: Tensor) -> Tensor:
        return self.adaLN_modulation(F.silu(c))

    def forward(self, x: Tensor, mods: Tensor, pad_mask: Optional[Tensor] = None) -> Tensor:
        shift_c, scale_c, gate_c, shift_m, scale_m = mods.chunk(5, dim=-1)
        h = self.conv_in(modulate(layer_norm_noaffine(x), shift_c, scale_c), pad_mask)
        x = modulate(layer_norm_noaffine(x + gate_c * h), shift_m, scale_m)
        if pad_mask is not None:
            x = x.masked_fill(pad_mask[:, :, None], 0.0)
        return self.conv_out(x.transpose(1, 2)).transpose(1, 2)
