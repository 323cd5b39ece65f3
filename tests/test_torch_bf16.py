"""bfloat16 in the port: the plain bf16 versions of K1/K2/K3 against the
Pallas kernels they replace (interpret mode, bf16 inputs), the bf16 codec
and the bf16-weight denoiser under the JAX package's quality bounds, and
``cast_inference_params`` against the JAX model after its own cast.

The kernels (and so their plain versions) do not follow the JAX XLA chain in
bf16: that chain rounds the FIR taps and every intermediate to bf16, the
kernels compute in fp32 and round where a unit stores a value.  The JAX
wrappers patch the rows near the global edges with that XLA chain, so the
Pallas comparison is made on interior rows only.

Interpret mode runs the kernel body under ``jit`` on the CPU, where XLA is
allowed excess precision: it drops f32 -> bf16 -> f32 round trips, so the
interpreted kernel does not round at every point the TPU kernel rounds at.
Those comparisons therefore state a bound in bf16 steps and no share of
equal elements; the kernel body run eagerly, op by op, does round at every
point, and there nearly every element is equal
(``test_unit_plain_bf16_matches_unit_core_eagerly``).
"""

import functools

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import flamed_tts_tpu.ops.pallas_resample as pr
import flamed_tts_tpu.ops.pallas_resunit as pru
from flamed_tts_tpu.models.codec_wrapper import FaCodec as JFaCodec
from flamed_tts_tpu.ops.melspec import mel_spectrogram

from flamed_tts_tpu_torch.convert import codec_tree, params_from_jax
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.models.prob.prob_generator import prob_sample
from flamed_tts_tpu_torch.ops.masking import mask_from_lengths
from flamed_tts_tpu_torch.ops.resample import snake_filtered_reference
from flamed_tts_tpu_torch.ops.resunit import residual_stack_reference, residual_unit_reference

from torch_parity_utils import CODEC_DIR, jax_params, small_config


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor as a numpy array of the bfloat16 extension type (bits kept)."""
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _steps(out: torch.Tensor, ref: np.ndarray) -> np.ndarray:
    """|out - ref| in bf16 steps (2^-7 relative) at max(|ref|, mean |ref|)."""
    ref = np.asarray(ref, dtype=np.float32)
    step = 2.0 ** -7 * np.maximum(np.abs(ref), np.abs(ref).mean())
    return np.abs(out.float().numpy() - ref) / step


def _units(rng, c, n=3):
    def v(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.1).astype(np.float32))

    return [{"act1": {"alpha": v(c), "beta": v(c)}, "act2": {"alpha": v(c), "beta": v(c)},
             "conv1": {"w": v(c, c, 7).bfloat16(), "b": v(c).bfloat16()},
             "conv2": {"w": v(c, c, 1).bfloat16(), "b": v(c).bfloat16()}} for _ in range(n)]


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(_bf16_np(tree) if tree.dtype == torch.bfloat16 else tree.numpy())


@pytest.mark.parametrize("t_len,c", [(300, 16), (257, 64), (130, 128)])
def test_snake_plain_bf16_matches_pallas(interpret_mode, t_len, c):
    """K1.  The Pallas kernel multiplies each bf16 input by its tap in bf16
    before summing in fp32, the port sums fp32 products: two bf16 steps."""
    rng = np.random.RandomState(3 + t_len)
    x = torch.from_numpy(rng.randn(2, t_len, c).astype(np.float32)).bfloat16()
    a, b = (torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32)) for _ in range(2))
    ref = pr.snake_filtered_pallas(jnp.asarray(_bf16_np(x)), jnp.asarray(a.numpy()),
                                   jnp.asarray(b.numpy()))
    out = snake_filtered_reference(x, a, b)
    assert out.dtype == torch.bfloat16
    steps = _steps(out, ref)[:, 3:-3]  # the wrapper patches 3 rows an edge
    assert steps.max() <= 2.0, steps.max()


@pytest.mark.parametrize("t_len,c,d,tile", [(300, 16, 3, 128), (290, 16, 9, 128), (513, 64, 3, 256)])
def test_unit_plain_bf16_matches_pallas(interpret_mode, t_len, c, d, tile):
    """K2, interior rows, within four bf16 steps (five rounding points on
    the port's side, fewer in the interpreted kernel: see the module text)."""
    rng = np.random.RandomState(5 + t_len + d)
    p = _units(rng, c, 1)[0]
    x = torch.from_numpy(rng.randn(2, t_len, c).astype(np.float32)).bfloat16()
    ref = pru.residual_unit_pallas(jnp.asarray(_bf16_np(x)), _to_jax(p), d, tile=tile)
    out = residual_unit_reference(x, p, d)
    halo = pru._unit_halo(d, 128 // c if c in (32, 64) else 1)
    steps = _steps(out, ref)[:, halo: t_len - halo]
    assert steps.max() <= 4.0, steps.max()


@pytest.mark.parametrize("c,d", [(16, 1), (64, 3), (128, 9)])
def test_unit_plain_bf16_matches_unit_core_eagerly(c, d):
    """The body of the TPU kernel (``_unit_core``) run op by op, so that it
    rounds at each of its points: the port rounds at the same ones, and only
    a rounding that the order of an fp32 sum decides can differ, by one
    step, in under one element in a thousand."""
    rng = np.random.RandomState(15 + c)
    t_len, halo = 300, 3 * d + 12
    p = _units(rng, c, 1)[0]
    x = torch.from_numpy(rng.randn(1, t_len, c).astype(np.float32)).bfloat16()
    ops = pru._unit_operands(_to_jax(p), c, jnp.bfloat16, 1)
    ref = pru._unit_core(jnp.asarray(_bf16_np(x))[0].astype(jnp.float32), *ops,
                         n_out=t_len - 2 * halo, halo=halo, dilation=d, taps=pr._filters(),
                         io_dtype=jnp.bfloat16)
    out = residual_unit_reference(x, p, d)[0, halo: t_len - halo]
    steps = _steps(out, ref)
    assert steps.max() <= 1.0 and (steps > 0).mean() < 1e-3, (steps.max(), (steps > 0).mean())


@pytest.mark.parametrize("t_len,c,tile", [(1400, 16, 512), (1300, 64, 512)])
def test_stack_plain_bf16_matches_pallas(interpret_mode, t_len, c, tile):
    """K3, interior rows, within eight bf16 steps (three units' worth)."""
    rng = np.random.RandomState(7 + t_len)
    units = _units(rng, c)
    x = torch.from_numpy(rng.randn(2, t_len, c).astype(np.float32)).bfloat16()
    ref = pru.residual_stack_pallas(jnp.asarray(_bf16_np(x)), _to_jax(units), (1, 3, 9), tile=tile)
    out = residual_stack_reference(x, units)
    fold = 128 // c if c in (32, 64) else 1
    total = sum(pru._unit_halo(d, fold) for d in (1, 3, 9))
    steps = _steps(out, ref)[:, total: t_len - total]
    assert steps.max() <= 8.0, steps.max()


@pytest.mark.parametrize("t_len", [1, 30, 200])
def test_plain_bf16_edges_follow_the_fp32_plain_version(t_len):
    """Every row, the edge rows included, against the fp32 plain version on
    the same (bf16-representable) inputs: a unit rounds five times, each to
    half a step of the values at that point."""
    rng = np.random.RandomState(9 + t_len)
    units = _units(rng, 32)
    x = torch.from_numpy(rng.randn(1, t_len, 32).astype(np.float32)).bfloat16()
    units32 = [{k: {n: v.float() for n, v in sub.items()} for k, sub in p.items()} for p in units]
    a, b = units[0]["act1"]["alpha"], units[0]["act1"]["beta"]
    snake = _steps(snake_filtered_reference(x, a, b), snake_filtered_reference(x.float(), a, b).numpy())
    assert snake.max() <= 0.5 + 1e-3  # one rounding of the output
    unit = _steps(residual_unit_reference(x, units[0], 3),
                  residual_unit_reference(x.float(), units32[0], 3).numpy())
    assert unit.max() <= 4.0, unit.max()
    edge = np.r_[0:min(39, t_len), max(t_len - 39, 0):t_len]
    stack = _steps(residual_stack_reference(x, units), residual_stack_reference(x.float(), units32).numpy())
    assert stack[:, edge].max() <= 8.0, stack[:, edge].max()


def _mel_l2(wav_a: np.ndarray, wav_b: np.ndarray) -> float:
    mel_a, mel_b = (np.asarray(mel_spectrogram(jnp.asarray(w))) for w in (wav_a, wav_b))
    return float(np.sqrt(((mel_a - mel_b) ** 2).sum(axis=1)).mean())


def test_codec_decode_bf16_mel_distance():
    """The bound of tests/test_bf16_quality.py::test_codec_decode_bf16_mel_distance
    (mean log-mel frame distance under 2.0), on the trained codec."""
    rng = np.random.RandomState(1)
    latents = torch.from_numpy(rng.randn(1, 24, 256).astype(np.float32))
    timbre = torch.from_numpy(rng.randn(1, 256).astype(np.float32))
    codec = FaCodec.from_pretrained(CODEC_DIR, device="cpu")
    wav32 = codec.decode(latents, timbre)[:, :, 0].numpy()
    codec.cast_inference_params()
    out = codec.decode(latents, timbre)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 24 * 200, 1)
    wav16 = out[:, :, 0].float().numpy()
    d = _mel_l2(wav32, wav16)
    assert d < 2.0, f"bf16 codec decode drifted: mel-L2 {d:.3f}"
    rel = np.abs(wav32 - wav16).mean() / (np.abs(wav32).mean() + 1e-9)
    assert rel < 0.05, rel


def test_codec_cast_holds_the_bits_of_the_jax_cast():
    cfg = small_config()
    jcodec = JFaCodec.from_pretrained(cfg["codec_cfg"], ckpt_dir=CODEC_DIR)
    jcodec.cast_inference_params()
    codec = FaCodec.from_pretrained(CODEC_DIR, device="cpu")
    codec.cast_inference_params()
    for ours, theirs in ((codec.enc_params, jcodec.enc_params), (codec.dec_params, jcodec.dec_params)):
        carried = codec_tree(jax.tree.map(np.asarray, theirs))  # bf16 leaves stay bf16
        flat_ours = jax.tree.leaves(ours, is_leaf=lambda v: isinstance(v, torch.Tensor))
        flat_theirs = jax.tree.leaves(carried, is_leaf=lambda v: isinstance(v, torch.Tensor))
        assert len(flat_ours) == len(flat_theirs) > 50
        n_bf16 = 0
        for a, b in zip(flat_ours, flat_theirs):
            assert b.dtype == torch.bfloat16
            # the snakes' alpha / beta keep float32 storage in the port; the values are the same
            assert torch.equal(a.to(torch.bfloat16), b) and torch.equal(a.float(), b.float())
            n_bf16 += a.dtype == torch.bfloat16
        assert n_bf16 > 40


def test_denoiser_bf16_latent_distance():
    """The bound of tests/test_bf16_quality.py::test_denoiser_bf16_latent_distance
    (relative latent error under 0.05 after 8 Euler steps)."""
    cfg = small_config()
    _, params = jax_params(cfg, seed=5)
    rng = np.random.RandomState(6)
    b, f = 1, 24
    cond = torch.from_numpy(rng.randn(b, 6, f, cfg["prob_generator"]["cond_dim"]).astype(np.float32))
    timbre = torch.from_numpy(rng.randn(b, 256).astype(np.float32))
    noise = torch.from_numpy(rng.randn(b, f, 256).astype(np.float32))
    mask = mask_from_lengths(torch.tensor([f]), f)
    model = Flamed(cfg, params, device="cpu")
    lat32 = prob_sample(model.prob, cond, timbre, mask, noise, 8, 0.3).numpy()
    model.cast_inference_params()
    lat16 = prob_sample(model.prob, cond, timbre, mask, noise, 8, 0.3).numpy()
    rel = float(np.linalg.norm(lat32 - lat16) / (np.linalg.norm(lat32) + 1e-9))
    assert 0 < rel < 0.05, f"bf16 denoiser drifted: rel {rel:.3f}"


def test_flamed_cast_matches_the_jax_cast():
    """Both models cast, same inputs and noise through the staged samplers:
    durations and target length equal, latents at the fp32 tolerance (the
    arithmetic is fp32 on both sides; only the stored weights are rounded)."""
    cfg = small_config()
    jmodel, params = jax_params(cfg, seed=1)
    model = Flamed(cfg, params, device="cpu")
    jmodel.cast_inference_params()
    model.cast_inference_params()
    host = jax.device_get(jmodel.params)
    carried = params_from_jax(host["prior"])
    for name, p in model.prior.state_dict().items():
        assert carried[name].dtype == torch.bfloat16
        assert torch.equal(p, carried[name].float()), name

    rng = np.random.RandomState(3)
    phonemes = rng.randint(1, 300, (1, 12))
    prompts, timbres = rng.randint(0, 1024, (1, 6, 20)), rng.randn(1, 256).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jmodel.sampler.sample(
        jmodel.params["prior"], jmodel.params["prob"], phonemes.astype(np.int32),
        np.array([12], np.int32), prompts.astype(np.int32), np.array([20], np.int32), timbres,
        key, nsteps_durgen=3, nsteps_denoiser=3, fused=False)
    rng1, rng2 = jax.random.split(key)
    rng_dur, rng_sil = jax.random.split(rng1)
    f_bucket = int(ref["frame_bucket"])
    noise = {"dur": np.asarray(jax.random.normal(rng_dur, (1, 16))),
             "sil": np.asarray(jax.random.normal(rng_sil, (1, 16))),
             "latents": np.asarray(jax.random.normal(rng2, (1, f_bucket, 256)))}
    out = model.sample_batch(phonemes, np.array([12]), prompts=prompts, timbres=timbres,
                             nsteps_durgen=3, nsteps_denoiser=3, noise=noise, fused=False)
    np.testing.assert_array_equal(out["tgt_len"], np.asarray(ref["tgt_len"]))
    np.testing.assert_array_equal(out["tgt_mask"], np.asarray(ref["tgt_mask"]))
    assert out["frame_bucket"] == f_bucket
    n = int(out["tgt_len"][0])
    np.testing.assert_allclose(out["latents"][0, :n].numpy(),
                               np.asarray(ref["latents"], dtype=np.float32)[0, :n],
                               atol=1e-4, rtol=1e-4)
