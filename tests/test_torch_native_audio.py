"""The port's native WAV codec (``flamed_tts_tpu_torch/utils/native_audio.py``,
built from its own ``csrc/wavio.cpp``) against the JAX package's
(``flamed_tts_tpu/utils/native_audio.py``): the same encoded bytes, the
same decoded arrays, the same None for what is not a WAV, and ``load_wav``
through it and through the scipy fallback."""

import io

import numpy as np
import pytest
from scipy.io import wavfile

from flamed_tts_tpu.utils import native_audio as jax_native
from flamed_tts_tpu.utils.audio import load_wav as jax_load_wav

from flamed_tts_tpu_torch.utils import audio, native_audio


@pytest.fixture(scope="module")
def libs():
    if native_audio.library() is None:
        pytest.fail(f"the port's codec did not build: {native_audio.build_error}")
    if jax_native._get_lib() is None:
        pytest.skip("the JAX package's native codec does not build here")


def _wav_bytes(data, sr=16000):
    buf = io.BytesIO()
    wavfile.write(buf, sr, data)
    return buf.getvalue()


def _inputs():
    rng = np.random.RandomState(0)
    pcm16 = (rng.randn(1000) * 8000).astype(np.int16)
    return {
        "pcm16": _wav_bytes(pcm16, 22050),
        "pcm32": _wav_bytes((rng.randn(700) * 2e8).astype(np.int32), 16000),
        "float32": _wav_bytes((np.sin(np.arange(500) * 0.1) * 0.5).astype(np.float32), 24000),
        "stereo": _wav_bytes(np.stack([pcm16[:300], -pcm16[:300] // 3], axis=1), 16000),
        "uint8": _wav_bytes((rng.rand(200) * 255).astype(np.uint8), 8000),
        "empty_data": _wav_bytes(np.zeros(0, np.int16), 16000),
    }


@pytest.mark.parametrize("name", list(_inputs()))
def test_decode_equals_the_jax_codec(libs, name):
    blob = _inputs()[name]
    ours, ref = native_audio.decode_wav(blob), jax_native.decode_wav(blob)
    if ref is None:  # a format neither decodes (8-bit PCM)
        assert ours is None
        return
    assert ours[1] == ref[1]
    assert ours[0].dtype == np.float32 and np.array_equal(ours[0], ref[0])


def test_malformed_input_gives_the_same_result(libs):
    for blob in (b"not a wav file at all", b"RIFF\x00\x00\x00\x00WAVE", b"",
                 _inputs()["pcm16"][:30]):
        assert native_audio.decode_wav(blob) is None
        assert jax_native.decode_wav(blob) is None


def test_encode_bytes_equal_the_jax_codec(libs):
    rng = np.random.RandomState(1)
    for n, sr in ((0, 16000), (1, 8000), (4097, 16000), (300, 22050)):
        data = (rng.randn(n) * 0.6).astype(np.float32)  # some past +-1: clipped
        blob = native_audio.encode_wav(data, sr)
        assert blob == jax_native.encode_wav(data, sr)
        wav, file_sr = native_audio.decode_wav(blob)
        assert file_sr == sr and wav.shape == (n,)


def test_load_wav_through_the_codec_and_through_scipy(libs, tmp_path, monkeypatch):
    rng = np.random.RandomState(2)
    for name, data, sr in (("a", (np.sin(np.arange(16000) * 0.03) * 12000).astype(np.int16), 16000),
                           ("b", (rng.randn(2, 2205).T * 3000).astype(np.int16), 22050),
                           ("c", (rng.randn(900) * 0.3).astype(np.float32), 16000)):
        path = str(tmp_path / f"{name}.wav")
        wavfile.write(path, sr, data)
        ours = audio.load_wav(path, 16000)
        np.testing.assert_array_equal(ours, jax_load_wav(path, 16000))
        # the scipy fallback reads the same samples (as floats, within the
        # codec's float32 mixdown)
        monkeypatch.setattr(native_audio, "decode_wav", lambda blob: None)
        np.testing.assert_allclose(audio.load_wav(path, 16000), ours, atol=1e-6)
        monkeypatch.undo()


def test_a_failed_build_falls_back_to_scipy(tmp_path, monkeypatch):
    """Where the library cannot be built the functions return None and
    ``load_wav`` reads the file with scipy."""
    monkeypatch.setattr(native_audio, "_lib", None)
    monkeypatch.setattr(native_audio, "_load_failed", False)
    monkeypatch.setattr(native_audio, "build_error", None)
    monkeypatch.setattr(native_audio, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_audio, "COMPILER", str(tmp_path / "no-such-compiler"))
    assert native_audio.decode_wav(_inputs()["pcm16"]) is None
    assert native_audio.encode_wav(np.zeros(4, np.float32), 16000) is None
    assert native_audio.build_error
    pcm = (np.arange(100) * 50).astype(np.int16)
    path = str(tmp_path / "x.wav")
    wavfile.write(path, 16000, pcm)
    np.testing.assert_allclose(audio.load_wav(path, 16000), pcm / 32768.0, atol=1e-7)
