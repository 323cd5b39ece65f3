"""The port's recognizer trainer (``flamed_tts_tpu_torch/train_asr.py``)
against the JAX package's ``tools/train_asr.py`` on the CPU: the corpus
and its features, three optimizer steps of a narrow model from the same
parameters on the same batches, and the CLI's weights file."""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flamed_tts_tpu import asr as jasr
from tools import train_asr as jtrain

from flamed_tts_tpu_torch import asr, train_asr
from flamed_tts_tpu_torch.dump_decoded import dump_decoded
from flamed_tts_tpu_torch.fabricate_corpus import fabricate
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.train_codec import leaves, tree_map

from torch_parity_utils import narrow_codec_dir
from torch_parity_utils import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four utterances of up to 7 s (one longer than a CHUNK) by two
    speakers, and their round trips through a narrow random codec."""
    root = tmp_path_factory.mktemp("asr_train")
    corpus, codec_dir, cache = str(root / "corpus"), str(root / "codec"), str(root / "decoded")
    fabricate(corpus, n=4, seed=0, n_speakers=2, dur_max=7.0)
    narrow_codec_dir(codec_dir)
    dump_decoded(corpus, FaCodec.from_pretrained(codec_dir, device="cpu"), cache, log=lambda *a: None)
    return corpus, cache


@pytest.mark.parametrize("holdout", [(), ("spk001",)])
def test_load_corpus_equals_jax(corpus, holdout):
    assert train_asr.load_corpus(corpus[0], holdout) == jtrain.load_corpus(corpus[0], holdout)


@pytest.mark.parametrize("decoded", [False, True])
def test_featurize_matches_jax(corpus, decoded):
    """Two utterances' chunks of reflect-padded log-mel within 1e-4;
    labels and speakers equal."""
    items = train_asr.load_corpus(corpus[0])[0][:2]
    cache = corpus[1] if decoded else None
    mels, labels, spks = train_asr.featurize(items, decoded_cache=cache, device="cpu")
    ref = jtrain.featurize(items, decoded_cache=cache, log=lambda *a: None)
    assert mels.shape == ref[0].shape and mels.shape[1:] == (train_asr.CHUNK, 80)
    if decoded:  # each utterance twice: as it is, then its round trip
        assert mels.shape[0] == 2 * len(train_asr.featurize(items, device="cpu")[0])
    np.testing.assert_allclose(mels, ref[0], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(labels, ref[1])
    np.testing.assert_array_equal(spks, ref[2])
    assert (labels == -1).any() and (labels > 0).any()


def _jax_step(lr, total):
    """tools/train_asr.py's loss, chain and jitted step (its main()
    builds them from the same lines)."""
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, min(200, total // 10), total)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-4))

    def loss_fn(p, batch_mel, batch_lab, batch_spk):
        logits = jasr.forward(p, jnp, batch_mel)
        valid = (batch_lab >= 0).astype(jnp.float32)
        lab = jnp.maximum(batch_lab, 0)
        logp = jax.nn.log_softmax(logits, axis=-1)
        onehot = jax.nn.one_hot(lab, jasr.N_CLASSES)
        ce = -((0.95 * onehot + 0.05 / jasr.N_CLASSES) * logp).sum(-1)
        loss = (ce * valid).sum() / jnp.maximum(valid.sum(), 1.0)
        emb = jasr.speaker_embed(p, jnp, batch_mel, frame_mask=valid)
        slogp = jax.nn.log_softmax(8.0 * (emb @ p["spk_cls"]), axis=-1)
        ok = (batch_spk >= 0).astype(jnp.float32)
        sce = -jnp.take_along_axis(slogp, jnp.maximum(batch_spk, 0)[:, None], axis=-1)[:, 0]
        return loss + 0.5 * (sce * ok).sum() / jnp.maximum(ok.sum(), 1.0)

    @jax.jit
    def train_step(p, opt_state, batch_mel, batch_lab, batch_spk):
        loss, grads = jax.value_and_grad(loss_fn)(p, batch_mel, batch_lab, batch_spk)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    return tx, train_step


def test_three_steps_match_jax():
    """A narrow model (32 x 3, a speaker head of 3) from the same
    parameters through three steps on the same batches (labels -1 past an
    utterance, one unlabelled speaker): losses within 1e-5, parameters
    within 1e-5 + 1e-4 rel.  lr 2e-2 over 30 steps: the warmup's 0, then
    6.7e-3 and 1.3e-2."""
    lr, total = 2e-2, 30
    params = asr.init_params(np.random.RandomState(3), n_speakers=3, d_model=32, n_layers=3)
    rng = np.random.RandomState(4)
    batches = []
    for _ in range(3):
        mel = rng.randn(4, 64, 80).astype(np.float32)
        lab = rng.randint(0, asr.N_CLASSES, (4, 64)).astype(np.int32)
        lab[1, 40:] = lab[3, 10:] = -1
        batches.append((mel, lab, np.array([0, 2, -1, 1], np.int32)))
    tx, jstep = _jax_step(lr, total)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    p = tree_map(lambda t: t.requires_grad_(), asr.to_tensors(params))
    opt = train_asr.make_optimizer(p, lr, total)
    assert opt.params == leaves(p)
    for n, (mel, lab, spk) in enumerate(batches):
        jp, state, jloss = jstep(jp, state, jnp.asarray(mel), jnp.asarray(lab), jnp.asarray(spk))
        loss = train_asr.train_step(p, opt, torch.from_numpy(mel), torch.from_numpy(lab), torch.from_numpy(spk))
        assert abs(float(loss) - float(jloss)) <= 1e-5, n
        ours, ref = asr.to_numpy(p), jax.device_get(jp)
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, err_msg=f"step {n}")
    moved = max(float(np.abs(a - b).max()) for a, b in
                zip(jax.tree_util.tree_leaves(asr.to_numpy(p)), jax.tree_util.tree_leaves(params)))
    assert moved > 5e-3


def test_non_finite_gradient_is_applied_as_optax_applies_it():
    """One finite step, then a gradient holding a NaN: the JAX tool's chain
    (no apply_if_finite) clips by a NaN norm and writes NaNs into the
    moments and the parameters, and counts the step; the port's optimizer
    does the same (parameters, moments and count, NaN where optax has NaN)."""
    lr, total = 2e-2, 30
    params = asr.init_params(np.random.RandomState(3), n_speakers=3, d_model=32, n_layers=3)
    rng = np.random.RandomState(5)
    mel = rng.randn(4, 64, 80).astype(np.float32)
    lab = rng.randint(0, asr.N_CLASSES, (4, 64)).astype(np.int32)
    spk = np.array([0, 2, -1, 1], np.int32)
    tx, jstep = _jax_step(lr, total)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    jp, state, _ = jstep(jp, state, jnp.asarray(mel), jnp.asarray(lab), jnp.asarray(spk))
    p = tree_map(lambda t: t.requires_grad_(), asr.to_tensors(params))
    opt = train_asr.make_optimizer(p, lr, total)
    train_asr.train_step(p, opt, torch.from_numpy(mel), torch.from_numpy(lab), torch.from_numpy(spk))

    grads = tree_map(lambda t: torch.from_numpy(rng.randn(*t.shape).astype(np.float32)),
                     asr.to_tensors(params))
    leaves(grads)[0].view(-1)[0] = float("nan")
    updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, asr.to_numpy(grads)), state, jp)
    jp = optax.apply_updates(jp, updates)
    opt.step(leaves(grads))

    adam = state[1][0]
    assert int(adam.count) == opt.count == 2

    def port_order(tree, like=params):
        """The JAX tree's arrays in the port's leaf order (``like``'s keys)."""
        if isinstance(like, dict):
            return [a for k in like for a in port_order(tree[k], like[k])]
        if isinstance(like, list):
            return [a for t, l in zip(tree, like) for a in port_order(t, l)]
        return [np.asarray(tree)]

    for ours, ref in (([t.detach().numpy() for t in leaves(p)], port_order(jax.device_get(jp))),
                      ([t.numpy() for t in opt.mu], port_order(jax.device_get(adam.mu))),
                      ([t.numpy() for t in opt.nu], port_order(jax.device_get(adam.nu)))):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, equal_nan=True)
    assert all(np.isnan(t.detach().numpy()).any() for t in leaves(p))


def test_cli_writes_weights_jax_reads(corpus, tmp_path):
    """Two epochs on the CPU at the default widths (256 x 8), on the clean
    and decoded audio: finite losses, a weights file that the JAX
    package's load_weights reads into the same forward, and the report."""
    out = str(tmp_path / "asr.npz")
    res = train_asr.main(["--corpus", corpus[0], "--out", out, "--epochs", "2", "--device", "cpu",
                          "--train-on", "decoded", "--decoded-cache", corpus[1]])
    assert len(res["epoch_loss"]) == 2 and np.isfinite(res["epoch_loss"]).all()
    assert [e for e, _ in res["valid_acc"]] == [1, 2] and 0.0 <= res["spk_acc"] <= 1.0
    assert np.isfinite(res["wer"]) and len(res["step_s"]) == len(res["step_frames"]) == 2
    loaded = jasr.load_weights(out)
    assert loaded["in_w"].shape == (80, 256) and len(loaded["layers"]) == 8 and "spk_cls" in loaded
    mel = np.random.RandomState(0).randn(1, 30, 80).astype(np.float32)
    np.testing.assert_allclose(jasr.forward(loaded, np, mel),
                               asr.forward(asr.to_tensors(res["params"]), torch.from_numpy(mel)).numpy(),
                               atol=2e-4, rtol=2e-4)


def test_cli_needs_an_output_path(corpus):
    with pytest.raises(SystemExit):
        train_asr.main(["--corpus", corpus[0], "--device", "cpu"])
    assert "out" in [a.dest for a in train_asr._parser()._actions if a.required]
