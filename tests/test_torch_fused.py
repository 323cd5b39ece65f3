"""The port's fused sampling paths against the JAX package's own fused paths
(``BucketedSampler.sample(fused=True)`` with and without ``prompt_wav``),
never against the staged path: same small random prior/prob weights, the
trained codec_r5 codec, the JAX noise draws, CPU, fp32."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flamed_tts_tpu.models.codec_wrapper import FaCodec as JFaCodec
from flamed_tts_tpu.models.facodec.decoder import analyze as j_analyze
from flamed_tts_tpu.models.facodec.encoder import encoder_forward as j_encoder_forward

from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.flamed import Flamed

from torch_parity_utils import CODEC_DIR, jax_params, prompt_wav, small_config

NSTEPS = 2
N_PHON = 12
L_BUCKET = 16


def _jax_noise(rng, f_bucket):
    """The draws the JAX fused path makes from ``rng``."""
    rng1, rng2 = jax.random.split(rng)
    rng_dur, rng_sil = jax.random.split(rng1)
    return {"dur": np.asarray(jax.random.normal(rng_dur, (1, L_BUCKET))),
            "sil": np.asarray(jax.random.normal(rng_sil, (1, L_BUCKET))),
            "latents": np.asarray(jax.random.normal(rng2, (1, f_bucket, 256)))}


@pytest.fixture(scope="module")
def setup():
    cfg = small_config()
    jmodel, params = jax_params(cfg, seed=1)
    jcodec = JFaCodec.from_pretrained(cfg["codec_cfg"], ckpt_dir=CODEC_DIR)
    model = Flamed(cfg, params, device="cpu")
    codec = FaCodec.from_pretrained(CODEC_DIR, device="cpu")
    phonemes = np.random.RandomState(3).randint(1, 300, (1, N_PHON))
    return cfg, jmodel, jcodec, model, codec, phonemes


@pytest.fixture(scope="module")
def prompt_runs(setup):
    """Two calls of the fused prompt path on each side."""
    cfg, jmodel, jcodec, model, codec, phonemes = setup
    wav = prompt_wav(0.5, seed=2)
    padded, n_frames = jcodec.pad_prompt_wav(wav)
    refs, outs = [], []
    for seed in (7, 8):
        rng = jax.random.PRNGKey(seed)
        ref = jmodel.sampler.sample(
            jmodel.params["prior"], jmodel.params["prob"], phonemes.astype(np.int32),
            np.array([N_PHON], np.int32), None, None, None, rng,
            nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS, dec_params=jcodec.dec_params,
            fused=True, prompt_wav=padded[None], prompt_frames=np.array([n_frames], np.int32),
            codec=jcodec)
        refs.append(ref)
        # model.sample pads the prompt as the JAX Flamed.sample does
        outs.append(model.sample(phonemes=phonemes[0], prompt_raw=wav, codec=codec,
                                 nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS,
                                 noise=_jax_noise(rng, int(ref["frame_bucket"]))))
    return refs, outs


def test_fused_prompt_lengths_and_bucket_equal(prompt_runs):
    refs, outs = prompt_runs
    for ref, out in zip(refs, outs):
        np.testing.assert_array_equal(out["tgt_len"], np.asarray(ref["tgt_len"]))
        assert out["frame_bucket"] == ref["frame_bucket"]
        assert out["tgt_len"][0] >= N_PHON


def test_fused_prompt_latents_close(prompt_runs):
    refs, outs = prompt_runs
    for ref, out in zip(refs, outs):
        n = int(out["tgt_len"][0])
        # fp32 both sides: summation order in the prior, the denoiser and the
        # prompt's encoder (the codes and the timbre feed the prior)
        np.testing.assert_allclose(out["latents"][0, :n].numpy(),
                                   np.asarray(ref["latents"])[0, :n], atol=1e-4, rtol=1e-4)


def test_fused_prompt_wav_is_the_same_pcm(prompt_runs):
    """Both sides quantize to int16 on the device and divide by 32767 on the
    host: the samples are equal, or one step of 1/32767 apart where the
    float wav (1e-5 apart at most) fell on either side of a rounding
    boundary."""
    refs, outs = prompt_runs
    for ref, out in zip(refs, outs):
        n = int(out["tgt_len"][0]) * 200
        ref_wav = np.asarray(ref["wav"])[0, :n, 0]
        assert out["wav"].shape == ref_wav.shape and out["wav"].dtype == np.float32
        steps = np.abs(np.round(out["wav"] * 32767.0) - np.round(ref_wav * 32767.0))
        assert steps.max() <= 1
        assert (steps == 0).mean() > 0.99
        pcm = out["wav"] * 32767.0
        np.testing.assert_allclose(pcm, np.round(pcm), atol=1e-3)  # int16 steps exactly


def test_ratio_history_after_two_calls(setup, prompt_runs):
    _, jmodel, _, model, _, _ = setup
    refs, _ = prompt_runs
    hist = model.sampler._ratio_history
    assert len(hist) == len(jmodel.sampler._ratio_history) == 2
    np.testing.assert_allclose(hist, jmodel.sampler._ratio_history, rtol=1e-6)
    np.testing.assert_allclose(hist, [int(r["tgt_len"][0]) / N_PHON for r in refs], rtol=1e-6)


def test_prompt_codes_equal(setup):
    """The prompt's RVQ codes, lengths and timbre from the port's analysis on
    the device against the JAX fused path's own lines (int16 wire, 1/32767,
    encode + analyze, ``vocab_pad`` past the true length)."""
    cfg, jmodel, jcodec, model, codec, _ = setup
    wav = prompt_wav(0.5, seed=2)
    padded, n_frames = codec.pad_prompt_wav(wav)
    wav_q = np.round(np.clip(padded, -1.0, 1.0) * 32767.0).astype(np.int16)
    p_bucket = 64
    prompts, lens, timbres = model.sampler._analyze_prompt(
        codec, torch.from_numpy(wav_q)[None, :, None], torch.tensor([n_frames]), p_bucket, 1024)
    jwav = jnp.asarray(wav_q, jnp.float32)[None, :, None] * (1.0 / 32767.0)
    pad_mask = jnp.arange(len(padded) // 200)[None, :] >= n_frames
    jcodes, jtimbre = j_analyze(jcodec.dec_params,
                                j_encoder_forward(jcodec.enc_params, jwav), pad_mask)
    jcodes = np.transpose(np.asarray(jcodes), (1, 0, 2))[:, :, :p_bucket]
    assert prompts.shape == (1, 6, p_bucket) and int(lens[0]) == n_frames == 40
    np.testing.assert_array_equal(prompts[:, :, :n_frames].numpy(), jcodes[:, :, :n_frames])
    assert (prompts[:, :, n_frames:] == 1024).all()
    np.testing.assert_allclose(timbres.numpy(), np.asarray(jtimbre), atol=1e-5, rtol=1e-4)


def _prompt_inputs(cfg):
    rng = np.random.RandomState(0)
    return (rng.randint(0, 1024, (1, 6, 20)), np.array([20]),
            rng.randn(1, 256).astype(np.float32))


def test_overflow_retry(setup):
    """Half a frame per phoneme is too small a budget (a phoneme takes one
    frame at least): both sides overflow their speculative bucket of 8
    frames, warn nothing (the target fits a larger bucket) and
    answer from the bucket the target length needs."""
    cfg, jmodel, _, model, _, phonemes = setup
    prompts, prompt_lens, timbres = _prompt_inputs(cfg)
    rng = jax.random.PRNGKey(11)
    rng1, _ = jax.random.split(rng)
    rng_dur, rng_sil = jax.random.split(rng1)
    noise = {"dur": np.asarray(jax.random.normal(rng_dur, (1, L_BUCKET))),
             "sil": np.asarray(jax.random.normal(rng_sil, (1, L_BUCKET)))}
    history = (list(jmodel.sampler._ratio_history), list(model.sampler._ratio_history))
    buckets = (jmodel.sampler.frame_buckets, model.sampler.frame_buckets)
    try:
        jmodel.sampler.frame_buckets = model.sampler.frame_buckets = [8, 32, 64, 128]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            ref = jmodel.sampler.sample(
                jmodel.params["prior"], jmodel.params["prob"], phonemes.astype(np.int32),
                np.array([N_PHON], np.int32), prompts.astype(np.int32),
                prompt_lens.astype(np.int32), timbres, rng, nsteps_durgen=NSTEPS,
                nsteps_denoiser=NSTEPS, fused=True, frames_per_phoneme_budget=0.5)
            out = model.sampler.sample(
                phonemes, np.array([N_PHON]), prompts, prompt_lens, timbres, torch.device("cpu"),
                nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS, noise=noise,
                generator=torch.Generator().manual_seed(0), fused=True,
                frames_per_phoneme_budget=0.5)
    finally:
        jmodel.sampler.frame_buckets, model.sampler.frame_buckets = buckets
        jmodel.sampler._ratio_history[:], model.sampler._ratio_history[:] = history
    tgt = int(out["tgt_len"][0])
    assert tgt > 8, "the speculative bucket (8 frames) did not overflow"
    np.testing.assert_array_equal(out["tgt_len"], np.asarray(ref["tgt_len"]))
    assert out["frame_bucket"] == ref["frame_bucket"] == 32
    assert out["latents"].shape == (1, 32, 256) and out["tgt_mask"].shape == (1, 32)
    np.testing.assert_array_equal(out["tgt_mask"], np.asarray(ref["tgt_mask"]))
    assert "wav" not in out
    assert torch.isfinite(out["latents"]).all()


def test_largest_bucket_overflow_warns_and_clips(setup):
    cfg, _, _, model, _, phonemes = setup
    prompts, prompt_lens, timbres = _prompt_inputs(cfg)
    buckets, history = model.sampler.frame_buckets, list(model.sampler._ratio_history)
    try:
        model.sampler.frame_buckets = [8]
        for fused in (True, False):
            with pytest.warns(UserWarning, match="exceeds the largest frame bucket 8"):
                out = model.sampler.sample(
                    phonemes, np.array([N_PHON]), prompts, prompt_lens, timbres,
                    torch.device("cpu"), nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS,
                    generator=torch.Generator().manual_seed(0), fused=fused)
            assert out["latents"].shape[1] == 8 and int(out["tgt_len"][0]) == 8
    finally:
        model.sampler.frame_buckets = buckets
        model.sampler._ratio_history[:] = history


@pytest.mark.parametrize("kwargs,match", [
    (dict(), "`text` and `phonemes` are mutually exclusive"),
    (dict(text="hi", phonemes=[1, 2]), "`text` and `phonemes` are mutually exclusive"),
    (dict(phonemes=[1, 2]), "`prompt_raw` and `prompt_processed` are mutually exclusive"),
    (dict(phonemes=[1, 2], prompt_raw=np.zeros(800, np.float32),
          prompt_processed=np.zeros((6, 4), np.int64)),
     "`prompt_raw` and `prompt_processed` are mutually exclusive"),
    (dict(phonemes=[1, 2], prompt_processed=np.zeros((6, 4), np.int64)),
     "`timbre` must be provided"),
    (dict(phonemes=[1, 2], prompt_raw=np.zeros(800, np.float32)), "`codec` must be provided"),
])
def test_sample_argument_errors(setup, kwargs, match):
    model = setup[3]
    with pytest.raises(ValueError, match=match):
        model.sample(**kwargs)


def test_prompt_wav_needs_the_fused_path(setup):
    cfg, _, _, model, codec, phonemes = setup
    with pytest.raises(ValueError, match="requires fused=True"):
        model.sampler.sample(phonemes, np.array([N_PHON]), None, None, None, torch.device("cpu"),
                             codec=codec, fused=False, prompt_wav=np.zeros((1, 16000), np.float32),
                             prompt_frames=np.array([80]))
    with pytest.raises(ValueError, match="requires `codec`"):
        model.sampler.sample(phonemes, np.array([N_PHON]), None, None, None, torch.device("cpu"),
                             fused=True, prompt_wav=np.zeros((1, 16000), np.float32),
                             prompt_frames=np.array([80]))
    with pytest.raises(ValueError, match="either prompts"):
        model.sample_batch(phonemes, np.array([N_PHON]))
