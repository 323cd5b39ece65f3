"""ConvNeXt / adaLN denoiser blocks, channel-last and mask-aware.

GELU is the exact (erf) form; ResBlock LayerNorms are affine with eps
1e-6, FinalLayer norms have no affine; adaLN modulation order is
(shift_conv, scale_conv, gate_conv, shift_mlp, scale_mlp[, gate_mlp]).

A block's forward runs its products (``precision.linear``, without their
bias) and, between them, the pieces of ``ops/denoiser.py``: one CUDA kernel
each on the card, the ops they fuse, one by one, on the CPU.  The piece
that reads a product adds its bias.  The residual add that ends an
AdaLNResBlock (x + gate_mlp * (h + bias)) is left to the norm that reads
it next, which adds it as it loads x: the block returns it as a
``Residual``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from flamed_tts_tpu_torch import precision
from flamed_tts_tpu_torch.ops import denoiser
from flamed_tts_tpu_torch.ops.denoiser import depthwise_conv1d, modulate  # noqa: F401 (modulate: parallel/)
from flamed_tts_tpu_torch.ops.embeddings import dit_timestep_embedding
from flamed_tts_tpu_torch.ops.norms import MaskedGroupNorm


@dataclass(frozen=True)
class Residual:
    """x + gate * (h + bias), the add not made yet (h a product, bias its
    bias), or x + bias where h is None (x the product).  (Not a pytree:
    gate is a view of the modulations, which a module hook must not take for
    an output.)"""
    x: Tensor
    h: Optional[Tensor]
    gate: Optional[Tensor]
    bias: Optional[Tensor] = None

    def value(self) -> Tensor:
        if self.h is None:
            return denoiser.add_bias(self.x, self.bias)
        return self.x + self.gate * denoiser.add_bias(self.h, self.bias)


def norm_in(x: Union[Tensor, Residual], shift: Tensor, scale: Tensor, norm: Optional[nn.LayerNorm],
            eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """(x, the modulated norm of x) where x may be a ``Residual`` (then
    added first); ``norm`` None: a LayerNorm without affine."""
    weight, bias, eps = (None, None, eps) if norm is None else (norm.weight, norm.bias, norm.eps)
    if isinstance(x, Residual):
        return denoiser.norm_modulate(x.x, shift, scale, weight, bias, eps, gate=x.gate, r1=x.h,
                                      rb=x.bias)
    return denoiser.norm_modulate(x, shift, scale, weight, bias, eps)


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
        return depthwise_conv1d(x, self.weight, self.bias)


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
        """The block's branch, conv_3(gelu(conv_2(ln_1(conv_1(x masked))))),
        without conv_3's bias: the caller adds x and the bias, in the norm
        that reads the sum."""
        h = denoiser.conv_norm(x, self.conv_1.weight, self.conv_1.bias, self.ln_1.weight,
                               self.ln_1.bias, pad_mask, self.ln_1.eps, operand=True)
        h = denoiser.activation(precision.linear(h, self.conv_2.weight), "gelu", self.conv_2.bias,
                                operand=True)
        return precision.linear(h, self.conv_3.weight)


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

    def forward(self, x: Union[Tensor, Residual], mods: Tensor,
                pad_mask: Optional[Tensor] = None) -> Residual:
        """x + gate_c * (u + conv_in(u)), u = modulate(ln_conv(x)); then
        the MLP on modulate(ln_mlp(.)): the output x + gate_m * mlp, as a
        ``Residual``."""
        shift_c, scale_c, gate_c, shift_m, scale_m, gate_m = mods.chunk(6, dim=-1)
        x, u = norm_in(x, shift_c, scale_c, self.ln_conv)
        x, h = denoiser.norm_modulate(x, shift_m, scale_m, self.ln_mlp.weight, self.ln_mlp.bias,
                                      self.ln_mlp.eps, gate=gate_c, r1=u,
                                      r2=self.conv_in(u, pad_mask), rb=self.conv_in.conv_3.bias,
                                      operand=True)
        h = denoiser.activation(precision.linear(h, self.mlp_0.weight), "silu", self.mlp_0.bias,
                                operand=True)
        return Residual(x, precision.linear(h, self.mlp_2.weight), gate_m, self.mlp_2.bias)


class FinalLayer(nn.Module):
    def __init__(self, model_channels: int, out_channels: int, kernel: int = 31,
                 padding: int = 15, expand: int = 1, groups: Optional[int] = None):
        super().__init__()
        self.adaLN_modulation = precision.Linear(model_channels, 5 * model_channels)
        self.conv_in = ConvNeXtBlock(model_channels, kernel, padding, expand, groups)
        self.conv_out = precision.Conv1d(model_channels, out_channels, 3, padding=1)
        self._conv_out_weight = None  # (key, conv_out's weight in the windows' order)

    def mods(self, c: Tensor) -> Tensor:
        return self.adaLN_modulation(F.silu(c))

    def forward(self, x: Union[Tensor, Residual], mods: Tensor,
                pad_mask: Optional[Tensor] = None) -> Tensor:
        shift_c, scale_c, gate_c, shift_m, scale_m = mods.chunk(5, dim=-1)
        x, u = norm_in(x, shift_c, scale_c, None)
        _, windows = denoiser.norm_modulate(x, shift_m, scale_m, gate=gate_c, r1=u,
                                            r2=self.conv_in(u, pad_mask),
                                            rb=self.conv_in.conv_3.bias, pad_mask=pad_mask,
                                            operand=True, windows=True, keep=False)
        return precision.linear(windows, self.conv_out_weight(), self.conv_out.bias)

    def conv_out_weight(self) -> Tensor:
        """conv_out's weight in the windows' order (``denoiser.k3_weight``),
        made once and kept while the parameter's storage and version stand
        (a copy each call where a gradient flows to it)."""
        w = self.conv_out.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return denoiser.k3_weight(w)
        key = (w.data_ptr(), w._version, w.dtype)
        if self._conv_out_weight is None or self._conv_out_weight[0] != key:
            self._conv_out_weight = (key, denoiser.k3_weight(w.detach()))
        return self._conv_out_weight[1]
