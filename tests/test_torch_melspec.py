"""The port's log-mel against the JAX package's, at both parameter sets of
the codec trainer (CPU, fp32)."""

import jax
import numpy as np
import pytest
import torch

from flamed_tts_tpu.ops import melspec as jmel

from flamed_tts_tpu_torch.ops import melspec

from torch_parity_utils import prompt_wav

PARAMS = {"default": {}, "fine": {"n_fft": 256, "num_mels": 40, "hop_size": 50, "win_size": 200}}


@pytest.mark.parametrize("which", sorted(PARAMS))
def test_mel_spectrogram_matches_jax(which):
    kw = PARAMS[which]
    rng = np.random.RandomState(0)
    wav = np.stack([prompt_wav(0.5, seed=1), 0.3 * rng.randn(8000).astype(np.float32)])
    ref = np.asarray(jax.jit(lambda w: jmel.mel_spectrogram(w, **kw))(wav))
    out = melspec.mel_spectrogram(torch.from_numpy(wav), **kw).numpy()
    assert out.shape == ref.shape == (2, kw.get("num_mels", 80), 8000 // kw.get("hop_size", 200))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n_fft,n_mels", [(1024, 80), (256, 40)])
def test_filterbank_equals_jax(n_fft, n_mels):
    np.testing.assert_array_equal(melspec.mel_filterbank(16000, n_fft, n_mels, 0.0, 8000.0),
                                  jmel.mel_filterbank(16000, n_fft, n_mels, 0.0, 8000.0))
    freqs = np.array([0.0, 500.0, 999.0, 1000.0, 4000.0, 8000.0])
    np.testing.assert_array_equal(melspec._hz_to_mel(freqs), jmel._hz_to_mel(freqs))
    np.testing.assert_allclose(melspec._mel_to_hz(melspec._hz_to_mel(freqs)), freqs, rtol=1e-12)


def test_mel_spectrogram_gradient_matches_jax():
    """The codec trainer differentiates through the log-mel of its output."""
    wav = prompt_wav(0.25, seed=3)[None]
    g = np.random.RandomState(1).randn(1, 80, 20).astype(np.float32)
    _, vjp = jax.vjp(jmel.mel_spectrogram, wav)
    ref = np.asarray(jax.jit(vjp)(g)[0])
    x = torch.from_numpy(wav).requires_grad_()
    out, = torch.autograd.grad(melspec.mel_spectrogram(x), x, torch.from_numpy(g))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-3)
