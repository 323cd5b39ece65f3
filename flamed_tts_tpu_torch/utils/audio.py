"""Host-side WAV I/O and resampling: WAVs are decoded by the native codec
(``utils/native_audio.py``, ``csrc/wavio.cpp``) where it is built, else read
with ``scipy.io.wavfile`` (8/16/32-bit PCM and float), as in the JAX
package; resampled with ``scipy.signal``'s polyphase filter; output is
16-bit PCM."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

DEFAULT_SR = 16000


def _to_float32(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.float32:
        return data
    if data.dtype == np.float64:
        return data.astype(np.float32)
    if data.dtype == np.int16:
        return (data / 32768.0).astype(np.float32)
    if data.dtype == np.int32:
        return (data / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return ((data.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
    raise ValueError(f"Unsupported WAV sample dtype: {data.dtype}")


def load_wav(path: str, sr: int = DEFAULT_SR) -> np.ndarray:
    """Load a WAV as mono float32 in [-1, 1] resampled to ``sr``: decoded
    by the native codec where it is available, else by scipy."""
    from flamed_tts_tpu_torch.utils import native_audio

    with open(path, "rb") as fin:
        native = native_audio.decode_wav(fin.read())
    if native is not None:
        wav, file_sr = native
    else:
        file_sr, data = wavfile.read(path)
        wav = _to_float32(np.asarray(data))
        if wav.ndim == 2:  # (T, channels) -> mono
            wav = wav.mean(axis=1)
    if file_sr != sr:
        g = np.gcd(int(file_sr), int(sr))
        wav = resample_poly(wav, sr // g, file_sr // g).astype(np.float32)
    return np.ascontiguousarray(wav, dtype=np.float32)


def save_wav(path: str, wav: np.ndarray, sr: int = DEFAULT_SR) -> None:
    """Write mono float32 audio as 16-bit PCM."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wav = np.asarray(wav, dtype=np.float32).squeeze()
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    wavfile.write(path, sr, pcm)


def duration_seconds(wav: np.ndarray, sr: int = DEFAULT_SR) -> float:
    return float(np.asarray(wav).squeeze().shape[-1]) / float(sr)


def synth_filename(prompt_name: str, nsteps_durgen: int, nsteps_denoiser: int,
                   temp_durgen: float, temp_denoiser: float) -> Tuple[str, str]:
    """(file name, sub-directory) of a synthesized wav:
    ``<prompt stem>-<nfe dur>-<nfe den>-<temp dur>-<temp den>.wav`` under
    ``nfe<nfe den>-temp<temp den>``."""
    stem = os.path.splitext(os.path.basename(prompt_name))[0]
    name = f"{stem}-{nsteps_durgen}-{nsteps_denoiser}-{temp_durgen}-{temp_denoiser}.wav"
    return name, f"nfe{nsteps_denoiser}-temp{temp_denoiser}"
