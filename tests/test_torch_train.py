"""The port's training path against the JAX package's, on the CPU at small
widths: the losses and their gradients, the schedule, three AdamW steps,
dropout and the checkpoint format (the trainer CLI, ``avg_weights`` and the
smoke test: tests/test_torch_train_cli.py).

The JAX side draws its flow-matching times and noises from keys; the
tests replay the same ``jax.random`` splits and hand the draws to the port,
in deterministic mode (eval, or dropout rates 0).  Gradients are compared
leaf by leaf after ``params_to_jax`` maps the port's names and layouts."""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flamed_tts_tpu.models.prior.sampling import pva_loss as j_pva_loss
from flamed_tts_tpu.models.prob.prob_generator import prob_loss as j_prob_loss
from flamed_tts_tpu.ops.length_regulator import length_regulate as j_length_regulate
from flamed_tts_tpu.ops.masking import mask_from_lengths as j_mask
from flamed_tts_tpu.runtime.pytree_io import load_pytree_npz as j_load_pytree_npz
from flamed_tts_tpu.train.losses import compute_losses as j_compute_losses
from flamed_tts_tpu.train.losses import prior_ce_loss as j_prior_ce_loss
from flamed_tts_tpu.train.step import init_train_state as j_init_train_state
from flamed_tts_tpu.train.step import make_optimizer as j_make_optimizer
from flamed_tts_tpu.train.step import make_train_step as j_make_train_step
from flamed_tts_tpu.train.step import warmup_cosine_schedule as j_schedule

from flamed_tts_tpu_torch.config import load_yaml, save_yaml
from flamed_tts_tpu_torch.convert import params_from_jax, params_to_jax
from flamed_tts_tpu_torch.data.dataset import BucketedCollator
from flamed_tts_tpu_torch.models.prior.prior_generator import PriorGenerator
from flamed_tts_tpu_torch.models.prior.sampling import pva_loss
from flamed_tts_tpu_torch.models.prob.prob_generator import ProbGenerator, prob_loss
from flamed_tts_tpu_torch.ops.length_regulator import length_regulate
from flamed_tts_tpu_torch.ops.masking import mask_from_lengths
from flamed_tts_tpu_torch.runtime.pytree_io import save_pytree_npz
from flamed_tts_tpu_torch.train.losses import compute_losses, prior_ce_loss
from flamed_tts_tpu_torch.train.step import (batch_to_device, init_train_state, train_step,
                                             warmup_cosine_schedule)

from torch_parity_utils import ROOT, jax_params, small_config

# fp32 on both sides, sums in another order
LOSS_RTOL = 1e-5
# of the leaf's largest |gradient|, floored at 1e-2 of the tree's: a leaf
# whose gradient is zero in exact arithmetic (the attention's key bias, which
# shifts every key's score of a query alike) holds rounding noise only
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-2
NORMS = ["masked", "reference"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _no_dropout(cfg):
    cfg = copy.deepcopy(cfg)
    t = cfg["prior_generator"]["transformer"]
    t["encoder_dropout"] = t["decoder_dropout"] = 0.0
    for g in ("duration_generator", "sil_generator"):
        cfg["prior_generator"]["variance_adaptor"][g]["drop_out"] = 0.0
    return cfg


def _modules(cfg, params):
    prior = PriorGenerator(cfg["prior_generator"])
    prior.load_state_dict(params["prior"])
    prob = ProbGenerator(cfg["prob_generator"])
    prob.load_state_dict(params["prob"])
    return prior, prob


@pytest.fixture(scope="module")
def setup():
    cfg = small_config()
    jmodel, params = jax_params(cfg, seed=2)
    return cfg, jmodel, params


def _items(seed, n=3, vocab=1024):
    """Training samples of random phonemes, durations, codes and latents."""
    rng = np.random.RandomState(seed)
    items = []
    for _ in range(n):
        l = int(rng.randint(6, 15))
        phone_dur = rng.randint(1, 5, l).astype(np.int32)
        sil_dur = (rng.rand(l) < 0.3) * rng.randint(0, 4, l)
        lf = int(phone_dur.sum() + sil_dur.sum())
        items.append({"phoneme": rng.randint(1, 300, l).astype(np.int32),
                      "code": rng.randint(0, vocab, (6, lf)).astype(np.int32),
                      "emb": rng.randn(lf, 256).astype(np.float32),
                      "spk": rng.randn(256).astype(np.float32),
                      "phone_dur": phone_dur, "sil_dur": sil_dur.astype(np.int32)})
    return items


def _batch(seed, n=3):
    """One batch of ``_items`` at the same bucket shapes whatever the seed
    (one compile of each jitted JAX function)."""
    collator = BucketedCollator(prompt_max_len=40, phoneme_buckets=[16], frame_buckets=[128],
                                prompt_buckets=[32], seed=seed)
    return collator(_items(seed, n))


def _jax_draws(rng, b, l, lf):
    """The draws compute_losses makes from ``rng``, replayed."""
    rng_pva, rng_prob = jax.random.split(rng, 5)[:2]
    rng_t, rng_d0, rng_s0 = jax.random.split(rng_pva, 3)
    rng_pt, rng_pn = jax.random.split(rng_prob)
    return {"pva_t": jax.random.uniform(rng_t, (b, 1)),
            "dur_noise": jax.random.normal(rng_d0, (b, l)),
            "sil_noise": jax.random.normal(rng_s0, (b, l)),
            "prob_t": jax.random.uniform(rng_pt, (b, lf, 1)),
            "prob_noise": jax.random.normal(rng_pn, (b, lf, 256))}


def _port_grads(module):
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in module.named_parameters()}
    return params_to_jax(grads)


def _assert_grads_close(port_tree, jax_tree):
    flat_p = dict(jax.tree_util.tree_flatten_with_path(port_tree)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jax_tree)[0])
    assert set(flat_p) == set(flat_j)
    top = max(float(np.abs(np.asarray(g)).max()) for g in flat_j.values())
    for path, gj in flat_j.items():
        gj = np.asarray(gj)
        scale = max(float(np.abs(gj).max()), GRAD_FLOOR * top)
        err = float(np.abs(np.asarray(flat_p[path]) - gj).max())
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err, scale)


def _close(a, b):
    np.testing.assert_allclose(float(a.detach()) if isinstance(a, torch.Tensor) else float(a),
                               float(b), rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("loss_norm", NORMS)
def test_pva_loss_and_grads_match(setup, loss_norm):
    cfg, jmodel, params = setup
    prior, _ = _modules(cfg, params)
    prior.eval()
    batch = _batch(0)
    b, l = batch["phonemes"].shape
    rng = np.random.RandomState(1)
    t = rng.rand(b, 1).astype(np.float32)
    noise = rng.randn(2, b, l).astype(np.float32)
    src_mask_j = j_mask(jnp.asarray(batch["x_len"]), l)

    def j_loss(p):
        enc = jmodel.prior_module.apply(p, jnp.asarray(batch["phonemes"]), src_mask_j,
                                        method="encode")
        out = j_pva_loss(jmodel.prior_module, p, enc, src_mask_j, jnp.asarray(batch["phone_dur"]),
                         jnp.asarray(batch["sil_dur"]), jax.random.PRNGKey(0), 1e-4,
                         loss_norm=loss_norm, _t_override=jnp.asarray(t),
                         _noise_override=(jnp.asarray(noise[0]), jnp.asarray(noise[1])))
        return out["dur_loss"] + out["sil_loss"], out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(jmodel.params["prior"])
    tb = batch_to_device(batch, "cpu")
    src_mask = mask_from_lengths(tb["x_len"], l)
    enc = prior.encode(tb["phonemes"], src_mask)
    out = pva_loss(prior, enc, src_mask, tb["phone_dur"], tb["sil_dur"], 1e-4, t=_t(t),
                   noise=(_t(noise[0]), _t(noise[1])), loss_norm=loss_norm)
    (out["dur_loss"] + out["sil_loss"]).backward()
    for k in ("dur_loss", "sil_loss"):
        _close(out[k], j_out[k])
    _assert_grads_close(_port_grads(prior), j_grads)


@pytest.mark.parametrize("loss_norm", NORMS)
def test_prob_loss_per_position_t_and_grads_match(setup, loss_norm):
    cfg, jmodel, params = setup
    _, prob = _modules(cfg, params)
    rng = np.random.RandomState(2)
    b, lf = 2, 32
    lens = np.array([32, 19], np.int32)
    hiddens = rng.randn(b, 6, lf, 48).astype(np.float32)
    x1 = rng.randn(b, lf, 256).astype(np.float32)
    x1[1, 19:] = 0.0  # zero-padded, as the collator pads
    spk = rng.randn(b, 256).astype(np.float32)
    t = rng.rand(b, lf, 1).astype(np.float32)  # a time per frame
    noise = rng.randn(b, lf, 256).astype(np.float32)
    mask_j = j_mask(jnp.asarray(lens), lf)

    def j_loss(p):
        out = j_prob_loss(jmodel.prob_module, p, jnp.asarray(x1), jnp.asarray(hiddens),
                          jnp.asarray(spk), mask_j, jax.random.PRNGKey(0), 1e-6,
                          loss_norm=loss_norm, _t_override=jnp.asarray(t),
                          _noise_override=jnp.asarray(noise))
        return out["fm_loss"] + out["anchor_loss"], out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(jmodel.params["prob"])
    out = prob_loss(prob, _t(x1), _t(hiddens), _t(spk), mask_from_lengths(_t(lens).long(), lf),
                    1e-6, t=_t(t), noise=_t(noise), loss_norm=loss_norm)
    (out["fm_loss"] + out["anchor_loss"]).backward()
    for k in ("fm_loss", "anchor_loss"):
        _close(out[k], j_out[k])
    _assert_grads_close(_port_grads(prob), j_grads)


@pytest.mark.parametrize("loss_norm", NORMS)
def test_prior_ce_loss_and_grads_match(setup, loss_norm):
    cfg, jmodel, params = setup
    prior, _ = _modules(cfg, params)
    prior.eval()
    batch = _batch(3)
    b, l = batch["phonemes"].shape
    lf = batch["codes"].shape[-1]
    src_mask_j = j_mask(jnp.asarray(batch["x_len"]), l)
    tgt_mask_j = j_mask(jnp.asarray(batch["y_len"]), lf)

    def j_loss(p):
        enc = jmodel.prior_module.apply(p, jnp.asarray(batch["phonemes"]), src_mask_j,
                                        method="encode")
        lr, _ = j_length_regulate(enc, jnp.asarray(batch["phone_dur"]),
                                  jnp.asarray(batch["sil_dur"]), jnp.asarray(batch["x_len"]), lf)
        _, logits = jmodel.prior_module.apply(p, lr, tgt_mask_j, jnp.asarray(batch["prompts"]),
                                              jnp.asarray(batch["prompt_lens"]), method="decode")
        return j_prior_ce_loss(logits, jnp.asarray(batch["codes"]), tgt_mask_j, loss_norm)

    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss))(jmodel.params["prior"])
    tb = batch_to_device(batch, "cpu")
    src_mask, tgt_mask = mask_from_lengths(tb["x_len"], l), mask_from_lengths(tb["y_len"], lf)
    enc = prior.encode(tb["phonemes"], src_mask)
    lr, _ = length_regulate(enc, tb["phone_dur"], tb["sil_dur"], tb["x_len"], lf)
    _, logits = prior.decode(lr, tgt_mask, tb["prompts"], tb["prompt_lens"])
    loss = prior_ce_loss(logits, tb["codes"], tgt_mask, loss_norm)
    loss.backward()
    _close(loss, j_val)
    _assert_grads_close(_port_grads(prior), j_grads)


@pytest.mark.parametrize("loss_norm", NORMS)
def test_compute_losses_deterministic_with_jax_draws(setup, loss_norm):
    cfg, jmodel, params = setup
    prior, prob = _modules(cfg, params)
    prior.eval()
    prob.eval()
    batch = _batch(4)
    b, l = batch["phonemes"].shape
    lf = batch["codes"].shape[-1]
    rng = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, bt, key: j_compute_losses(
        jmodel.prior_module, jmodel.prob_module, p, bt, key, train=False, loss_norm=loss_norm))(
        jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    draws = {k: _t(v) for k, v in _jax_draws(rng, b, l, lf).items()}
    with torch.no_grad():
        out = compute_losses(prior, prob, batch_to_device(batch, "cpu"), draws=draws,
                             loss_norm=loss_norm)
    assert list(out) == ["dur_loss", "sil_loss", "prior_loss", "fm_loss", "anchor_loss",
                         "total_loss"]
    for k, v in out.items():
        _close(v, ref[k])


def test_batch_without_prompt_lens_takes_the_whole_prompt(setup):
    cfg, _, params = setup
    prior, prob = _modules(cfg, params)
    prior.eval()
    prob.eval()
    batch = batch_to_device(_batch(6), "cpu")
    full = dict(batch, prompt_lens=torch.full_like(batch["prompt_lens"], batch["prompts"].shape[-1]))
    del batch["prompt_lens"]
    with torch.no_grad():
        a = compute_losses(prior, prob, batch, generator=torch.Generator().manual_seed(0))
        b = compute_losses(prior, prob, full, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_unknown_draw_is_refused(setup):
    cfg, _, params = setup
    prior, prob = _modules(cfg, params)
    with pytest.raises(ValueError, match="unknown draws"):
        compute_losses(prior, prob, batch_to_device(_batch(0), "cpu"), draws={"t": None})


@pytest.mark.parametrize("step", [0, 1, 7, 10, 55, 100, 150])
def test_schedule_matches(step):
    """Steps 0 and 1, inside the warmup, at its end, mid-cosine, at and
    beyond max_steps."""
    ours = warmup_cosine_schedule(1e-4, 10, 100)(step)
    np.testing.assert_allclose(ours, float(j_schedule(1e-4, 10, 100)(step)), rtol=1e-6, atol=1e-12)


def test_adamw_steps_match_make_train_step(setup):
    """Three steps from the same weights on the same batches and draws,
    dropout rates 0.  The first step has lr 0 (warmup), as in optax.

    eps is 1e-4 here, not the config's 1e-9: a parameter whose gradient is
    zero in exact arithmetic (the attention's key biases; the depthwise
    conv biases before the ConvNeXt's per-channel norm) gets rounding noise
    of ~1e-8 on either side, which Adam's first steps scale to +-lr whatever
    its size; at eps 1e-4 such noise moves a parameter by ~lr / 10^4, while
    a gradient above 1e-3 still takes a near sign-like step of ~lr."""
    cfg = _no_dropout(setup[0])
    jmodel, params = jax_params(cfg, seed=3)
    opt_cfg = dict(load_yaml(os.path.join(ROOT, "configs", "optimizer.yaml")),
                   lr=1e-3, warmup_steps=1, max_steps=10, eps=1e-4)
    tx, _ = j_make_optimizer(opt_cfg)
    j_step = jax.jit(j_make_train_step(jmodel.prior_module, jmodel.prob_module, tx))
    j_state = j_init_train_state(jmodel.params, tx)
    prior, prob = _modules(cfg, params)
    state = init_train_state(prior, prob, opt_cfg)
    for i in range(3):
        batch = _batch(10 + i)
        b, l = batch["phonemes"].shape
        rng = jax.random.PRNGKey(20 + i)
        j_state, j_metrics = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        draws = {k: _t(v) for k, v in _jax_draws(rng, b, l, batch["codes"].shape[-1]).items()}
        metrics = train_step(state, batch_to_device(batch, "cpu"), draws=draws)
        for k in ("total_loss", "prior_loss", "fm_loss", "dur_loss"):
            _close(metrics[k], j_metrics[k])
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(j_metrics["grad_norm"]),
                                   rtol=1e-4)
    assert state.step == 3 and int(j_state.step) == 3
    for name, module in (("prior", prior), ("prob", prob)):
        flat_p = dict(jax.tree_util.tree_flatten_with_path(params_to_jax(module.state_dict()))[0])
        flat_j = dict(jax.tree_util.tree_flatten_with_path(j_state.params[name])[0])
        assert set(flat_p) == set(flat_j)
        for path, vj in flat_j.items():
            np.testing.assert_allclose(flat_p[path], np.asarray(vj), rtol=0, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))
    # the two steps after the warmup step moved the weights by ~2 lr, far past
    # the tolerance
    kernel = lambda tree: tree["params"]["denoiser"]["proj_in"]["kernel"]
    assert np.abs(kernel(params_to_jax(prob.state_dict()))
                  - kernel(params_to_jax(params["prob"]))).max() > 1e-3


def _loss_pair(cfg, params, rate_seed):
    prior, prob = _modules(cfg, params)
    state = init_train_state(prior, prob, dict(load_yaml(os.path.join(ROOT, "configs",
                                                                      "optimizer.yaml"))),
                             seed=rate_seed)
    batch = batch_to_device(_batch(7), "cpu")
    train = train_step(state, batch)["total_loss"]
    state.generator.manual_seed(rate_seed)
    prior.eval()
    prob.eval()
    with torch.no_grad():
        evaluated = compute_losses(prior, prob, batch, state.generator)["total_loss"]
    return float(train), float(evaluated)


def test_dropout_is_train_mode_only_and_seeded(setup):
    cfg, _, params = setup
    # rate 0: a training step's losses equal eval mode's from the same draws
    train, evaluated = _loss_pair(_no_dropout(cfg), params, 0)
    assert train == evaluated
    # rate 0.1 (the config's): they differ, and the same seed gives the same losses
    train, evaluated = _loss_pair(cfg, params, 0)
    assert train != evaluated
    assert _loss_pair(cfg, params, 0) == (train, evaluated)
    assert _loss_pair(cfg, params, 1)[0] != train


def test_params_to_jax_inverts_params_from_jax(setup, tmp_path):
    _, jmodel, _ = setup
    host = jax.device_get(jmodel.params)
    tree = {k: params_to_jax(params_from_jax(host[k])) for k in ("prior", "prob")}
    flat_p = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(host)[0])
    assert set(flat_p) == set(flat_j)
    for path, vj in flat_j.items():
        vj = np.asarray(vj)
        assert flat_p[path].dtype == vj.dtype and np.array_equal(flat_p[path], vj), path
    # a port-written checkpoint, read by the JAX package's loader
    save_pytree_npz(str(tmp_path / "last.npz"), tree)
    loaded = j_load_pytree_npz(str(tmp_path / "last.npz"))
    flat_l = dict(jax.tree_util.tree_flatten_with_path(loaded)[0])
    assert set(flat_l) == set(flat_j)
    assert all(np.array_equal(flat_l[p], np.asarray(v)) for p, v in flat_j.items())


def _write_samples(root, n, seed):
    rng = np.random.RandomState(seed)
    lines = []
    for i, item in enumerate(_items(seed, n)):
        np.savez(os.path.join(root, f"u{i}.npz"), **item)
        lines.append(f"u{i}.npz|{1.0 + rng.rand():.3f}|one two three four")
    for name, part in (("train_manifest.txt", lines[1:]), ("valid_manifest.txt", lines[:1])):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(part) + "\n")


def _tiny_config_dir(root, data_root):
    cfg = small_config()
    cfg["dataset_cfg"].update(data_root=data_root, use_precomputed=True, batch_size=2,
                              dur_min=0.5, prompt_dur_max=0.5, prompt_buckets=[16, 32])
    opt = dict(load_yaml(os.path.join(ROOT, "configs", "optimizer.yaml")),
               warmup_steps=1, max_steps=10)
    for key, name in (("prior_generator", "prior"), ("prob_generator", "prob"),
                      ("codec_cfg", "codec"), ("dataset_cfg", "data")):
        save_yaml(cfg[key], os.path.join(root, f"{name}.yaml"))
    save_yaml(opt, os.path.join(root, "optimizer.yaml"))
    return cfg
