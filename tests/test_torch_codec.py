"""The port's FaCodec against the JAX package's, on the trained weights in
artifacts/codec_r5 (CPU, fp32): prompt analysis and synthesis."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flamed_tts_tpu.config import load_yaml
from flamed_tts_tpu.models.codec_wrapper import FaCodec as JFaCodec

from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec

from torch_parity_utils import CODEC_DIR, ROOT, prompt_wav


@pytest.fixture(scope="module")
def codecs():
    cfg = load_yaml(os.path.join(ROOT, "configs", "codec.yaml"))
    return JFaCodec.from_pretrained(cfg, ckpt_dir=CODEC_DIR), FaCodec.from_pretrained(CODEC_DIR, device="cpu")


def test_encode_prompt_matches_jax(codecs):
    jcodec, codec = codecs
    wav = prompt_wav(1.0)
    j_codes, j_timbre = jcodec.encode_prompt(wav)
    codes, timbre = codec.encode_prompt(wav)
    assert codes.shape == (6, 80)
    np.testing.assert_array_equal(codes, j_codes)
    # 4 transformer layers of fp32 matmuls in another summation order
    np.testing.assert_allclose(timbre, j_timbre, atol=1e-4, rtol=1e-4)


def test_synthesize_matches_jax(codecs):
    jcodec, codec = codecs
    rng = np.random.RandomState(1)
    latents = rng.randn(1, 10, 256).astype(np.float32)
    timbre = rng.randn(1, 256).astype(np.float32) * 0.5
    ref = np.asarray(jcodec.decode(jnp.asarray(latents), jnp.asarray(timbre)))
    out = codec.decode(torch.from_numpy(latents), torch.from_numpy(timbre)).numpy()
    assert out.shape == (1, 2000, 1)
    # 8 conv stages with C up to 1024 and 58 Snakes, all fp32: the
    # summation order differs from XLA's; the wav is tanh-bounded in [-1, 1]
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)
