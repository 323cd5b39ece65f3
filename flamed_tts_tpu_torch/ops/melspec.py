"""Log-mel spectrogram of the codec's conventions: reflect pre-pad by
(n_fft - hop) / 2, a periodic Hann window of ``win_size`` zero-padded to
``n_fft``, magnitude sqrt(re^2 + im^2 + 1e-9), the slaney-normalized mel
filterbank (librosa ``htk=False, norm='slaney'``), log with a clip at 1e-5.

The filterbank is computed in float64 numpy and stored as float32.  The
codec trainer reads two parameter sets: (n_fft, mels, hop, win) = (1024, 80,
200, 800), the default, and (256, 40, 50, 200).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """The slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= 1000.0,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / 1000.0) / logstep,
                    freq / f_sp)


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, 1000.0 * np.exp(logstep * (mels - min_log_mel)), f_sp * mels)


@lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_mels, 1 + n_fft // 2) float32 slaney-normalized triangles."""
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(np.array([fmin]))[0],
                                     _hz_to_mel(np.array([fmax]))[0], n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=None)
def _window(n_fft: int, win_size: int) -> np.ndarray:
    """The periodic Hann window of ``win_size`` centred in ``n_fft`` zeros."""
    full = np.zeros(n_fft, dtype=np.float64)
    lpad = (n_fft - win_size) // 2
    full[lpad: lpad + win_size] = np.hanning(win_size + 1)[:-1]
    return full.astype(np.float32)


def mel_spectrogram(wav: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                    sampling_rate: int = 16000, hop_size: int = 200, win_size: int = 800,
                    fmin: float = 0.0, fmax: float = 8000.0) -> torch.Tensor:
    """wav (B, T) float32 -> log-mel (B, num_mels, frames), frames = 1 + (T
    + 2 pad - n_fft) // hop_size with pad = (n_fft - hop_size) / 2."""
    pad = int((n_fft - hop_size) / 2)
    wav = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    frames = wav.unfold(-1, n_fft, hop_size)  # (B, frames, n_fft)
    frames = frames * torch.as_tensor(_window(n_fft, win_size), device=wav.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    mel = torch.as_tensor(mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax), device=wav.device)
    return torch.log(torch.clamp(torch.einsum("mk,bfk->bmf", mel, mag), min=1e-5))
