"""The port's two paths as wholes, on the CPU, with the same small random prior/prob
weights, the trained codec_r5 codec and the JAX noise draws on both sides.

The staged path: phonemes + prompt wav -> wav through the port's staged path
(``Flamed.sample(fused=False)``) against the JAX package's
(FaCodec.encode_prompt -> BucketedSampler.sample(fused=False) with the
codec's decoder), fp32.

The serving path: text + prompt wav -> wav through the frontend and the fused prompt
path with bfloat16 parameters and ``fuse_blocks=True``, against the JAX
``Flamed.sample(text=..., prompt_raw=...)`` after both of its casts."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flamed_tts_tpu.models.codec_wrapper import FaCodec as JFaCodec
from flamed_tts_tpu.ops.melspec import mel_spectrogram

from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.runtime.buckets import pick_bucket

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
        timbre[None], rng, nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS, fused=False,
        dec_params=jcodec.dec_params)
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
                       nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS, noise=noise, fused=False)
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
    # ref_wav is the float wav of the JAX decoder; the port's staged path
    # quantizes to int16 PCM on the way out, half a step of 1/32767 at most
    np.testing.assert_allclose(out["wav"], ref_wav, atol=1e-5 + 0.5 / 32767, rtol=1e-4)


def test_staged_wav_is_the_jax_samplers_pcm(runs):
    """With a codec the JAX staged sampler quantizes the wav to int16 on the
    device and divides by 32767 on the host; so does the port: equal
    samples, or one step apart where the float wavs (1e-5 apart at most)
    fell on either side of a rounding boundary."""
    ref, _, out = runs
    n = int(out["tgt_len"][0]) * 200
    ref_pcm = np.round(np.asarray(ref["wav"])[0, :n, 0] * 32767.0)
    pcm = out["wav"] * 32767.0
    np.testing.assert_allclose(pcm, np.round(pcm), atol=1e-3)
    steps = np.abs(np.round(pcm) - ref_pcm)
    assert steps.max() <= 1 and (steps == 0).mean() > 0.99


TEXT = "Hello there, this is 1 test."


@pytest.fixture(scope="module")
def bf16_runs():
    cfg = small_config()
    jmodel, params = jax_params(cfg, seed=1)
    jcodec = JFaCodec.from_pretrained(cfg["codec_cfg"], ckpt_dir=CODEC_DIR)
    model = Flamed(cfg, params, device="cpu")
    codec = FaCodec.from_pretrained(CODEC_DIR, device="cpu", fuse_blocks=True)
    wav = prompt_wav(0.5, seed=2)
    rng = jax.random.PRNGKey(9)
    # the draws the JAX fused path makes from rng, at the buckets a first
    # call takes: 9 frames a phoneme
    n_phon = model._get_frontend()(TEXT)[0].shape[1]
    l_bucket = pick_bucket(n_phon, model.sampler.phoneme_buckets)
    f_bucket = pick_bucket(int(n_phon * 9.0), model.sampler.frame_buckets)
    rng1, rng2 = jax.random.split(rng)
    rng_dur, rng_sil = jax.random.split(rng1)
    noise = {"dur": np.asarray(jax.random.normal(rng_dur, (1, l_bucket))),
             "sil": np.asarray(jax.random.normal(rng_sil, (1, l_bucket))),
             "latents": np.asarray(jax.random.normal(rng2, (1, f_bucket, 256)))}

    def port_run():
        model.sampler._ratio_history.clear()  # a first call's guess, as on the JAX side
        return model.sample(text=TEXT, prompt_raw=wav, codec=codec, nsteps_durgen=NSTEPS,
                            nsteps_denoiser=NSTEPS, noise=noise)

    fp32 = port_run()
    for m in (jmodel, jcodec, model, codec):
        m.cast_inference_params()
    ref = jmodel.sample(text=TEXT, prompt_raw=wav, codec=jcodec, nsteps_durgen=NSTEPS,
                        nsteps_denoiser=NSTEPS, rng=rng)
    return ref, port_run(), fp32


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_slice_lengths_equal(bf16_runs):
    """The durations come from the phonemes alone (frontend ids equal, fp32
    arithmetic on bf16-rounded weights on both sides): equal."""
    ref, out, _ = bf16_runs
    np.testing.assert_array_equal(out["tgt_len"], np.asarray(ref["tgt_len"]))
    assert out["frame_bucket"] == np.asarray(ref["latents"]).shape[1]
    assert out["wav"].shape == np.asarray(ref["wav"]).shape == (int(out["tgt_len"][0]) * 200,)


def test_bf16_slice_close_to_jax(bf16_runs):
    """The JAX run on the CPU takes its bf16 XLA chain (FIR taps and every
    intermediate rounded to bf16), the port the kernels' arithmetic (fp32
    inside, rounded where a unit stores): two different bf16 approximations
    of one fp32 result, which also pick different RVQ codes for a part of
    the prompt's frames.  So the port is held to the fp32 result, no further
    from it than the JAX run is (with a half again for the draw), and to the
    JAX run within their summed distances; the wav to the JAX package's bf16
    bound of 2.0 in mean log-mel frame distance."""
    ref, out, fp32 = bf16_runs
    n = int(out["tgt_len"][0])
    assert np.array_equal(out["tgt_len"], fp32["tgt_len"])
    lat, lat32 = out["latents"][0, :n].numpy(), fp32["latents"][0, :n].numpy()
    jlat = np.asarray(ref["latents"], np.float32)[0, :n]
    ours, theirs = _rel(lat, lat32), _rel(jlat, lat32)
    assert 0 < ours <= 1.5 * theirs < 0.5, (ours, theirs)
    assert _rel(lat, jlat) <= ours + theirs
    jwav = np.asarray(ref["wav"], np.float32)
    assert np.isfinite(out["wav"]).all() and np.abs(out["wav"]).max() <= 1.0
    for a, b in ((out["wav"], fp32["wav"]), (out["wav"], jwav)):
        mel_a, mel_b = (np.asarray(mel_spectrogram(jnp.asarray(w[None]))) for w in (a, b))
        d = float(np.sqrt(((mel_a - mel_b) ** 2).sum(axis=1)).mean())
        assert d < 2.0, d
