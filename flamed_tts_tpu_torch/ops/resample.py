"""Alias-free SnakeBeta: 2x kaiser-sinc upsample -> SnakeBeta -> 2x
decimation (the codec's ``Activation1d``), as plain PyTorch.

``snake_filtered_reference`` is the literal chain and the plain version of
the K1 kernel (ops/snake.py); the FIR filters are fixed numpy arrays.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from flamed_tts_tpu_torch.ops.conv1d import replicate_pad


def _kaiser_beta(half_size: int, half_width: float) -> float:
    delta_f = 4.0 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def _symmetric_kaiser(n: int, beta: float) -> np.ndarray:
    if n == 1:
        return np.ones(1, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)
    alpha = (n - 1) / 2.0
    return np.i0(beta * np.sqrt(1.0 - ((k - alpha) / alpha) ** 2)) / np.i0(beta)


@lru_cache(maxsize=None)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """(kernel_size,) float32 normalized kaiser-windowed sinc low-pass."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    window = _symmetric_kaiser(kernel_size, _kaiser_beta(half_size, half_width))
    if even:
        time = np.arange(-half_size, half_size, dtype=np.float64) + 0.5
    else:
        time = np.arange(kernel_size, dtype=np.float64) - half_size
    filt = 2.0 * cutoff * window * np.sinc(2.0 * cutoff * time)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


def snake_taps() -> np.ndarray:
    """The 12 taps shared by the 2x upsampler and decimator."""
    return kaiser_sinc_filter1d(0.25, 0.3, 12)


def snake_beta(x: torch.Tensor, log_alpha: torch.Tensor, log_beta: torch.Tensor) -> torch.Tensor:
    """x + sin^2(e^a x) / (e^b + 1e-9), channel-last; a, b (C,) log-scale."""
    return x + (1.0 / (torch.exp(log_beta) + 1e-9)) * torch.square(torch.sin(x * torch.exp(log_alpha)))


def _shared_filter(x: torch.Tensor, filt: np.ndarray, transpose: bool, stride: int) -> torch.Tensor:
    """One filter applied to every channel of (B, T, C) along time."""
    b, t, c = x.shape
    xt = x.permute(0, 2, 1).reshape(b * c, 1, t)
    w = torch.as_tensor(filt, dtype=x.dtype, device=x.device).view(1, 1, -1)
    y = F.conv_transpose1d(xt, w, stride=stride) if transpose else F.conv1d(xt, w, stride=stride)
    return y.view(b, c, -1).permute(0, 2, 1)


def upsample1d(x: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    k = int(6 * ratio // 2) * 2
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    filt = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k)
    y = ratio * _shared_filter(replicate_pad(x, pad, pad), filt, True, ratio)
    return y[:, pad_left:-pad_right, :]


def downsample1d(x: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    k = int(6 * ratio // 2) * 2
    filt = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k)
    x = replicate_pad(x, k // 2 - 1, k // 2)
    return _shared_filter(x, filt, False, ratio)


def snake_filtered_reference(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The literal up -> snake -> down chain; alpha/beta are log-scale.
    As in the K1 kernel a bfloat16 ``x`` is upcast, the arithmetic is
    float32 and the result is rounded to bfloat16 once."""
    work = torch.promote_types(x.dtype, torch.float32)
    y = snake_beta(upsample1d(x.to(work), 2), alpha.to(work), beta.to(work))
    return downsample1d(y, 2).contiguous().to(x.dtype)
