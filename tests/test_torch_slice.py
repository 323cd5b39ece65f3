"""The whole slice: phonemes + prompt wav -> wav through the port's
Flamed.sample, against the JAX package's staged path
(FaCodec.encode_prompt -> BucketedSampler.sample(fused=False) ->
FaCodec.decode) with the same small random prior/prob weights, the trained
codec_r5 codec and the JAX noise draws (CPU, fp32)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flamed_tts_tpu.models.codec_wrapper import FaCodec as JFaCodec

from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.flamed import Flamed

from torch_parity_utils import CODEC_DIR, jax_params, prompt_wav, small_config

NSTEPS = 3


@pytest.fixture(scope="module")
def runs():
    cfg = small_config()
    jmodel, params = jax_params(cfg, seed=1)
    jcodec = JFaCodec.from_pretrained(cfg["codec_cfg"], ckpt_dir=CODEC_DIR)
    wav = prompt_wav(0.5, seed=2)
    phonemes = np.random.RandomState(3).randint(1, 300, 12)

    # JAX staged path
    codes, timbre = jcodec.encode_prompt(wav)
    rng = jax.random.PRNGKey(7)
    ref = jmodel.sampler.sample(
        jmodel.params["prior"], jmodel.params["prob"], phonemes[None].astype(np.int32),
        np.array([12], np.int32), codes[None], np.array([codes.shape[-1]], np.int32),
        timbre[None], rng, nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS, fused=False)
    n = int(ref["tgt_len"][0]) * jcodec.hop
    ref_wav = np.asarray(jcodec.decode(ref["latents"], jnp.asarray(timbre[None])))[0, :n, 0]

    # the same draws as the JAX sampler makes inside
    rng1, rng2 = jax.random.split(rng)
    rng_dur, rng_sil = jax.random.split(rng1)
    l_bucket, f_bucket = 16, int(ref["frame_bucket"])
    noise = {
        "dur": np.asarray(jax.random.normal(rng_dur, (1, l_bucket))),
        "sil": np.asarray(jax.random.normal(rng_sil, (1, l_bucket))),
        "latents": np.asarray(jax.random.normal(rng2, (1, f_bucket, 256))),
    }
    model = Flamed(cfg, params, device="cpu")
    codec = FaCodec.from_pretrained(CODEC_DIR, device="cpu")
    out = model.sample(phonemes=phonemes, prompt_raw=wav, codec=codec,
                       nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS, noise=noise)
    return ref, ref_wav, out


def test_lengths_and_bucket_equal(runs):
    ref, _, out = runs
    np.testing.assert_array_equal(out["tgt_len"], np.asarray(ref["tgt_len"]))
    assert out["frame_bucket"] == ref["frame_bucket"]
    assert out["tgt_len"][0] >= 12


def test_latents_and_wav_close(runs):
    ref, ref_wav, out = runs
    n = int(out["tgt_len"][0])
    # fp32 everywhere; differences come from summation order through the
    # prior decoders, 3 Euler steps of the denoiser and the codec decoder
    np.testing.assert_allclose(out["latents"][0, :n].numpy(), np.asarray(ref["latents"])[0, :n],
                               atol=1e-4, rtol=1e-4)
    assert out["wav"].shape == ref_wav.shape == (n * 200,)
    assert np.all(np.isfinite(out["wav"]))
    np.testing.assert_allclose(out["wav"], ref_wav, atol=1e-5, rtol=1e-4)
