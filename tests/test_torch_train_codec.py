"""The port's codec trainer (``flamed_tts_tpu_torch/train_codec.py``)
against the JAX package's ``tools/train_codec.py`` on the CPU in fp32, at
small widths: the corpus reader and the crops, the loss and its gradient,
the optimizer (optax's chain), and a CLI run whose checkpoints the JAX
package's ``FaCodec`` reads with the codes the port's reads."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flamed_tts_tpu import asr as jasr
from flamed_tts_tpu.config import load_yaml
from flamed_tts_tpu.models.codec_wrapper import FaCodec as JFaCodec
from flamed_tts_tpu.models.facodec.decoder import synthesize as j_synthesize
from flamed_tts_tpu.models.facodec.encoder import encoder_forward as j_encoder_forward
from flamed_tts_tpu.models.facodec.extras import analyze_train as j_analyze_train
from flamed_tts_tpu.ops.melspec import mel_spectrogram as j_mel

from flamed_tts_tpu_torch import asr, train_codec
from flamed_tts_tpu_torch.convert import codec_tree, params_to_jax
from flamed_tts_tpu_torch.data.synthetic import fabricate_speaker_corpus
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.facodec.decoder import init_decoder_params
from flamed_tts_tpu_torch.models.facodec.encoder import init_encoder_params
from flamed_tts_tpu_torch.runtime.pytree_io import flatten_pytree

from torch_parity_utils import ROOT, prompt_wav

WEIGHTS = {"mel": 1.0, "wav": 10.0, "commit": 1.0, "phone": 2.0, "spk": 1.0, "latreg": 1.0}


def _jax_loss_fn(p, wav, lab, spk, rng, quantizer_dropout=0.25):
    """``loss_fn`` of tools/train_codec.py (nested in its main there), with
    the tool's default flags."""
    latents = j_encoder_forward(p["enc"], wav)
    q_sum, codes, commit, buf, timbre = j_analyze_train(
        p["dec"], latents, rng, quantizer_dropout=quantizer_dropout, normalized_losses=True, center=True)
    recon = j_synthesize(p["dec"], q_sum, timbre)
    wav_l1 = jnp.abs(recon - wav).mean()
    mel_l1 = jnp.abs(j_mel(recon[:, :, 0]) - j_mel(wav[:, :, 0])).mean()
    mel_t2 = j_mel(wav[:, :, 0], n_fft=256, num_mels=40, hop_size=50, win_size=200)
    mel_r2 = j_mel(recon[:, :, 0], n_fft=256, num_mels=40, hop_size=50, win_size=200)
    mel_l1 = mel_l1 + jnp.abs(mel_r2 - mel_t2).mean()

    def _norm(v):
        return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-6)

    tf = buf[1].shape[1]
    phone_logits = 8.0 * (_norm(buf[1]) @ _norm(p["heads"]["phone_w"].T).T)
    logp = jax.nn.log_softmax(phone_logits, axis=-1)
    onehot_p = jax.nn.one_hot(lab[:, :tf], jasr.N_CLASSES)
    phone_ce = -((0.95 * onehot_p + 0.05 / jasr.N_CLASSES) * logp).sum(-1).mean()
    spk_logits = 8.0 * (_norm(timbre) @ _norm(p["heads"]["spk_w"].T).T)
    slogp = jax.nn.log_softmax(spk_logits, axis=-1)
    onehot_s = jax.nn.one_hot(spk, slogp.shape[-1])
    spk_ce = -((0.95 * onehot_s + 0.05 / slogp.shape[-1]) * slogp).sum(-1).mean()
    commit_loss = commit.sum()
    lat_rms = jnp.sqrt(jnp.mean(latents ** 2) + 1e-12)
    lat_reg = jnp.log(lat_rms) ** 2
    total = (mel_l1 + 10.0 * wav_l1 + commit_loss + 2.0 * phone_ce + spk_ce + lat_reg)
    usage = jnp.stack([(jnp.zeros((1024,)).at[codes[i].reshape(-1)].add(1.0) > 0).sum()
                       for i in range(codes.shape[0])])
    metrics = {"mel_l1": mel_l1, "wav_l1": wav_l1, "commit": commit_loss, "phone_ce": phone_ce,
               "spk_ce": spk_ce, "total": total, "lat_rms": lat_rms,
               "phone_acc": (jnp.argmax(phone_logits, -1) == lab[:, :tf]).mean(),
               "spk_acc": (jnp.argmax(spk_logits, -1) == spk).mean(), "code_usage": usage}
    return total, metrics


def _jax_counts(key, b, n_layers, quantizer_dropout):
    """The quantizer-dropout counts the JAX RVQ draws from ``key``."""
    r1, _ = jax.random.split(key)
    n_q = np.full((b,), n_layers + 1, np.int32)
    n_drop = int(b * quantizer_dropout)
    n_q[:n_drop] = np.asarray(jax.random.randint(r1, (b,), 1, n_layers + 1))[:n_drop]
    return torch.from_numpy(n_q)


def _small_params(seed=0):
    """Narrow codec params (encoder ngf 4, width 32, decoder from 16
    channels; hop 200) and heads, as a numpy tree."""
    g = torch.Generator().manual_seed(seed)
    params = {"enc": init_encoder_params(g, ngf=4, out_channels=32),
              "dec": init_decoder_params(g, in_channels=32, upsample_initial_channel=16),
              "heads": {"phone_w": torch.randn((32, asr.N_CLASSES), generator=g) * 0.05,
                        "phone_b": torch.zeros(asr.N_CLASSES),
                        "spk_w": torch.randn((32, 3), generator=g) * 0.05, "spk_b": torch.zeros(3)}}
    return params_to_jax(params)


def _tool():
    """tools/train_codec.py as a module (it sets FLAMED_NO_PALLAS when
    imported; the caller's monkeypatch puts the environment back)."""
    spec = importlib.util.spec_from_file_location("train_codec_tool", os.path.join(ROOT, "tools",
                                                                                   "train_codec.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return fabricate_speaker_corpus(str(tmp_path_factory.mktemp("codec_corpus")), [1.0, 1.3, 0.8, 1.1, 0.9],
                                    n_speakers=3, seed=0)


def test_phone_inventory_equals_jax():
    assert asr.BASE_PHONES == jasr.BASE_PHONES and asr.PHONE_TO_ID == jasr.PHONE_TO_ID
    assert (asr.SIL, asr.N_CLASSES) == (jasr.SIL, jasr.N_CLASSES) == (0, 40)
    for text in ("AH0", "ZH", "sil", "sp", "", "spn", "EY1", "XX"):
        assert asr.phone_label(text) == jasr.phone_label(text)


def test_corpus_and_crops_equal_the_tool(corpus, monkeypatch):
    """load_corpus and the crops of a seeded RandomState, against the JAX
    tool's load_corpus and a copy of its make_batch (nested in its main)."""
    monkeypatch.setenv("FLAMED_NO_PALLAS", "")
    tool = _tool()
    with open(os.path.join(corpus, "speakers.txt"), encoding="utf-8") as fin:
        assert [ln.split("|")[1] for ln in fin.read().split()] == ["spk000", "spk001", "spk002",
                                                                   "spk000", "spk001"]
    for holdout in (set(), {"spk001"}):
        ours, ref = train_codec.load_corpus(corpus, holdout), tool.load_corpus(corpus, holdout)
        assert ours[3:] == ref[3:] and np.array_equal(ours[2], ref[2])
        for a, b in zip(ours[0] + ours[1], ref[0] + ref[1]):
            np.testing.assert_array_equal(a, b)
    wavs, labels, spks, _, _ = ref
    assert 1 < len(np.unique(np.concatenate(labels))) and set(spks) == {0, 1}

    def tool_make_batch(rng_np, batch, crop_frames):  # tools/train_codec.py:160-176
        wav_b = np.zeros((batch, crop_frames * 200, 1), np.float32)
        lab_b = np.zeros((batch, crop_frames), np.int32)
        spk_b = np.zeros((batch,), np.int32)
        for i in range(batch):
            u = rng_np.randint(len(wavs))
            w, l = wavs[u], labels[u]
            f0 = rng_np.randint(len(l) - crop_frames) if len(l) > crop_frames else 0
            seg_l, seg_w = l[f0: f0 + crop_frames], w[f0 * 200: (f0 + crop_frames) * 200]
            wav_b[i, : len(seg_w), 0] = seg_w
            lab_b[i, : len(seg_l)] = seg_l
            spk_b[i] = spks[u]
        return wav_b, lab_b, spk_b

    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    for crop in (40, 160, 40):
        for a, b in zip(train_codec.make_batch(r1, wavs, labels, spks, 3, crop), tool_make_batch(r2, 3, crop)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def step_inputs():
    """Small params, a batch of 4 x 4 frames, a key, and the JAX tool's loss,
    metrics and gradients on them."""
    rng = np.random.RandomState(1)
    wav = np.stack([prompt_wav(0.05, seed=s) * (0.5 + 0.5 * s) for s in range(4)])[:, :, None]
    lab = rng.randint(0, 40, (4, 4)).astype(np.int32)
    spk = np.array([0, 2, 1, 2], np.int32)
    params, key = _small_params(), jax.random.PRNGKey(5)
    (_, metrics), grads = jax.jit(jax.value_and_grad(_jax_loss_fn, has_aux=True))(params, wav, lab, spk, key)
    return params, wav, lab, spk, key, jax.device_get(metrics), jax.device_get(grads)


def test_loss_and_gradient_match_jax(step_inputs):
    """The loss terms and metrics within 1e-5 + 1e-4 rel, the code usage
    exactly, and the gradient of every parameter within 1e-5 + 2e-4 of the
    leaf's largest gradient (a parameter's gradient sums over every
    position, through ~40 layers and the whitening's inverse square root).
    One exception: a ReLU of a transformer's conv FFN whose input lies
    within rounding of 0 takes the other branch in one package; that moves
    the gradient of the one output channel it belongs to (this batch has
    one such tie, in the timbre encoder's last layer), and nothing else may
    lie outside."""
    params, wav, lab, spk, key, ref_m, ref_g = step_inputs
    n_q = [_jax_counts(k, 4, n, 0.25) for k, n in zip(jax.random.split(key, 3), (1, 2, 3))]
    pt = codec_tree(params)
    flat = train_codec.leaves(pt)
    for t in flat:
        t.requires_grad_()
    total, metrics = train_codec.loss_fn(pt, torch.from_numpy(wav), torch.from_numpy(lab),
                                         torch.from_numpy(spk), n_q, WEIGHTS)
    assert metrics.keys() == ref_m.keys()
    np.testing.assert_array_equal(metrics["code_usage"].numpy(), np.asarray(ref_m["code_usage"]))
    for k in ref_m:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(ref_m[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    grads = torch.autograd.grad(total, flat, allow_unused=True)
    by_id = {id(t): g if g is not None else torch.zeros_like(t) for t, g in zip(flat, grads)}
    ours = flatten_pytree(params_to_jax(train_codec.tree_map(lambda t: by_id[id(t)], pt)))
    ref = flatten_pytree(ref_g)
    assert ours.keys() == ref.keys()
    outside = {}
    for k in ref:
        bad = np.argwhere(np.abs(ours[k] - ref[k]) > 1e-5 + 2e-4 * float(np.abs(ref[k]).max()))
        if len(bad):
            outside[k] = bad
    # the one exception: a ReLU tie, which moves the gradient of one output
    # channel c of one conv FFN (its bias b[c] and its weights w[c])
    assert set(outside) <= {f"{k}/b" for k in _ffn1_paths(ref)} | {f"{k}/w" for k in _ffn1_paths(ref)}, \
        sorted(outside)
    assert len({k.rsplit("/", 1)[0] for k in outside}) <= 1
    assert len({int(i[0]) for v in outside.values() for i in v}) <= 1, outside


def _ffn1_paths(flat):
    return {k.rsplit("/", 1)[0] for k in flat if k.endswith("/ffn1/w")}


def test_schedule_equals_optax():
    for lr, steps in ((2e-4, 4000), (1e-2, 3), (1e-3, 25)):
        ours = train_codec.warmup_cosine_decay(lr, steps)
        ref = optax.warmup_cosine_decay_schedule(0.0, lr, max(min(300, steps // 10), 1), steps,
                                                 end_value=lr * 0.05)
        for count in sorted({0, 1, 2, steps // 20, steps // 10, steps // 2, steps - 1, steps, steps + 5}):
            np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("lr,steps", [(2e-4, 4000), (1e-2, 5)])
def test_optimizer_step_matches_optax(step_inputs, lr, steps):
    """The JAX tool's chain (apply_if_finite, clip_by_global_norm(1.0),
    adam over the warmup-cosine schedule) and FiniteAdam from the same
    parameters on the same gradients (the JAX tool's): three updates (the
    first at the schedule's lr 0) within 1e-5 + 1e-4 rel, then a skipped
    non-finite one."""
    params, _, _, _, _, _, grads = step_inputs
    # the heads and the encoder's first block: every kind of leaf, few of them
    params, grads = ({"enc": t["enc"]["blocks"][0], "heads": t["heads"]} for t in (params, grads))
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, max(min(300, steps // 10), 1), steps,
                                               end_value=lr * 0.05)
    tx = optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched)),
                               max_consecutive_errors=10 ** 9)
    state, p_ref = tx.init(params), params
    pt = codec_tree(params)
    flat = train_codec.leaves(pt)
    opt = train_codec.FiniteAdam(flat, train_codec.warmup_cosine_decay(lr, steps))
    start, g_flat = flatten_pytree(params), flatten_pytree(grads)
    g = [torch.from_numpy(np.array(g_flat[k])) for k in start]  # in the order of ``flat``
    update = jax.jit(tx.update)
    for n in range(3):
        updates, state = update(grads, state, p_ref)
        p_ref = optax.apply_updates(p_ref, updates)
        assert opt.step(g) and opt.count == n + 1
        ours, ref = flatten_pytree(params_to_jax(pt)), flatten_pytree(jax.device_get(p_ref))
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], atol=1e-5, rtol=1e-4, err_msg=f"update {n}: {k}")
    moved = max(float(np.abs(ref[k] - start[k]).max()) for k in ref)
    assert moved > 0.5 * sched(1)  # the later updates moved the parameters by about lr
    # a non-finite gradient: nothing changes and the skip is counted, as in optax
    before = [t.clone() for t in flat]
    bad = [x.clone() for x in g]
    bad[3].view(-1)[0] = float("nan")
    assert not opt.step(bad) and (opt.count, opt.notfinite_count, opt.total_notfinite) == (3, 1, 1)
    assert all(torch.equal(a, b) for a, b in zip(before, flat))
    updates, state = update(jax.tree_util.tree_map(lambda x: x * np.nan, grads), state, p_ref)
    assert int(state.notfinite_count) == 1 and not any(np.any(u) for u in jax.tree_util.tree_leaves(updates))
    assert opt.step(g) and opt.notfinite_count == 0


def test_revive_dead_codes_and_layer_z_e():
    """A revival on the small codec: every code no frame selects takes a z_e
    sample, the parameters stay finite, and the rows that were live keep
    their values."""
    pt = codec_tree(_small_params(1))
    wav = np.stack([prompt_wav(0.1, seed=s) for s in range(2)])[:, :, None]
    zs, cs = train_codec.layer_z_e(pt, torch.from_numpy(wav))
    assert zs.shape == (6, 16, 8) and cs.shape == (6, 16)
    before = [l["codebook"].clone() for g in pt["dec"]["quantizers"] for l in g]
    n = train_codec.revive_dead_codes(pt, wav, np.random.RandomState(0))
    for li, (cb0, layer) in enumerate(zip(before, (l for g in pt["dec"]["quantizers"] for l in g))):
        used = torch.zeros(1024, dtype=torch.bool)
        used[cs[li].long()] = True
        assert n[li] == int((~used).sum()) > 0
        assert torch.equal(layer["codebook"][used], cb0[used])
        assert not torch.equal(layer["codebook"][~used], cb0[~used])
    assert all(bool(torch.isfinite(t).all()) for t in train_codec.leaves(pt))


def test_cli_writes_checkpoints_the_jax_codec_reads(corpus, tmp_path):
    """Three steps of the CLI on the CPU; its .npz files load in both
    packages' FaCodec.from_pretrained, whose prompt codes are equal."""
    out = tmp_path / "codec"
    res = train_codec.main(["--corpus", corpus, "--out-dir", str(out), "--steps", "3", "--batch", "2",
                            "--crop-frames", "8", "--device", "cpu", "--log-every", "2"])
    assert len(res["step_s"]) == 3 and res["opt"].count == 3
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert set(rows[0]) == {"mel_l1", "wav_l1", "commit", "phone_ce", "spk_ce", "total", "lat_rms",
                            "phone_acc", "spk_acc", "step", "steps_per_sec", "code_usage"}
    assert all(np.isfinite(r["total"]) for r in rows)
    assert sorted(os.listdir(out)) == ["metrics.jsonl", "ns3_facodec_decoder.npz",
                                       "ns3_facodec_encoder.npz", "train_heads.npz"]
    wav = prompt_wav(0.6, seed=7)
    cfg = load_yaml(os.path.join(ROOT, "configs", "codec.yaml"))
    j_codes, j_timbre = JFaCodec.from_pretrained(cfg, ckpt_dir=str(out)).encode_prompt(wav)
    codes, timbre = FaCodec.from_pretrained(str(out), device="cpu").encode_prompt(wav)
    assert codes.shape == (6, 48)
    np.testing.assert_array_equal(codes, j_codes)
    np.testing.assert_allclose(timbre, j_timbre, atol=1e-4, rtol=1e-4)
