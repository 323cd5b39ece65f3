"""The port's prior and prob generators against the JAX package's, with
small random JAX weights carried across by params_from_jax and the JAX
noise draws handed in (CPU, fp32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flamed_tts_tpu.models.prior.sampling import pva_sample as j_pva_sample
from flamed_tts_tpu.models.prob.prob_generator import prob_sample as j_prob_sample
from flamed_tts_tpu.ops.masking import mask_from_lengths as j_mask

from flamed_tts_tpu_torch.models.prior.prior_generator import PriorGenerator
from flamed_tts_tpu_torch.models.prior.sampling import pva_sample
from flamed_tts_tpu_torch.models.prob.prob_generator import ProbGenerator, prob_sample
from flamed_tts_tpu_torch.ops.masking import mask_from_lengths

from torch_parity_utils import jax_params, small_config

# Deep fp32 stacks in another summation order: the float outputs agree to
# ~1e-6 relative; 1e-4 leaves room for the Euler loops' accumulation.
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    cfg = small_config()
    jmodel, params = jax_params(cfg)
    prior = PriorGenerator(cfg["prior_generator"])
    prior.load_state_dict(params["prior"])
    prob = ProbGenerator(cfg["prob_generator"])
    prob.load_state_dict(params["prob"])
    return jmodel, prior.eval(), prob.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_state_dict_covers_every_jax_param():
    cfg = small_config()
    jmodel, params = jax_params(cfg)
    for name, module in (("prior", PriorGenerator(cfg["prior_generator"])),
                         ("prob", ProbGenerator(cfg["prob_generator"]))):
        assert set(params[name]) == set(module.state_dict())
        n_jax = sum(np.size(v) for v in jax.tree.leaves(jmodel.params[name]))
        assert n_jax == sum(v.numel() for v in params[name].values())


def _inputs():
    rng = np.random.RandomState(0)
    phonemes = rng.randint(1, 300, (2, 16)).astype(np.int32)
    src_lens = np.array([16, 11], np.int32)
    phonemes[1, 11:] = 0
    return phonemes, src_lens


def test_encoder_and_pva_sample_match(models):
    jmodel, prior, _ = models
    phonemes, src_lens = _inputs()
    jp = jmodel.params["prior"]
    src_mask = j_mask(jnp.asarray(src_lens), 16)
    enc = jmodel.prior_module.apply(jp, jnp.asarray(phonemes), src_mask, method="encode")
    rng = jax.random.PRNGKey(3)
    j_dur, j_sil = j_pva_sample(jmodel.prior_module, jp, enc, src_mask, rng, 4, 1.0)
    rng_dur, rng_sil = jax.random.split(rng)
    dur_noise = np.asarray(jax.random.normal(rng_dur, (2, 16)))
    sil_noise = np.asarray(jax.random.normal(rng_sil, (2, 16)))

    with torch.no_grad():
        t_mask = mask_from_lengths(_t(src_lens).long(), 16)
        t_enc = prior.encode(_t(phonemes).long(), t_mask)
        np.testing.assert_allclose(t_enc.numpy(), np.asarray(enc), **TOL)
        dur, sil = pva_sample(prior, t_enc, t_mask, _t(dur_noise), _t(sil_noise), 4, 1.0)
    # integer outputs of round(exp(x) - 1): exactly equal
    np.testing.assert_array_equal(dur.numpy(), np.asarray(j_dur))
    np.testing.assert_array_equal(sil.numpy(), np.asarray(j_sil))
    assert dur.sum() > 0


def test_decode_matches(models):
    jmodel, prior, _ = models
    rng = np.random.RandomState(1)
    lr = rng.randn(2, 40, 32).astype(np.float32)
    tgt_lens = np.array([40, 23], np.int32)
    prompts = rng.randint(0, 1024, (2, 6, 64)).astype(np.int32)
    prompt_lens = np.array([50, 64], np.int32)
    prompts[0, :, 50:] = 1024
    jh, jl = jmodel.prior_module.apply(
        jmodel.params["prior"], jnp.asarray(lr), j_mask(jnp.asarray(tgt_lens), 40),
        jnp.asarray(prompts), jnp.asarray(prompt_lens), method="decode")
    with torch.no_grad():
        h, lg = prior.decode(_t(lr), mask_from_lengths(_t(tgt_lens).long(), 40),
                             _t(prompts).long(), _t(prompt_lens).long())
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)


def test_prob_sample_matches(models):
    jmodel, _, prob = models
    rng = np.random.RandomState(2)
    hiddens = rng.randn(2, 6, 32, 48).astype(np.float32)
    spk = rng.randn(2, 256).astype(np.float32)
    lens = np.array([32, 20], np.int32)
    key = jax.random.PRNGKey(4)
    ref = j_prob_sample(jmodel.prob_module, jmodel.params["prob"], jnp.asarray(hiddens),
                        jnp.asarray(spk), j_mask(jnp.asarray(lens), 32), key, 3, 0.3)
    noise = np.asarray(jax.random.normal(key, (2, 32, 256)))
    out = prob_sample(prob, _t(hiddens), _t(spk), mask_from_lengths(_t(lens).long(), 32),
                      _t(noise), 3, 0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
