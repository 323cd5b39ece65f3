"""The port's checkpoint converter (``flamed_tts_tpu_torch.convert_ckpt``)
against ``tools/convert_torch_ckpt.py``, on reference-format state dicts
built here from small random JAX trees by inverting the key mapping
(weight norm un-folded as ``weight_g`` = ||w||, ``weight_v`` = w), and
``Flamed.from_pretrained`` of a PyTorch checkpoint in the port against the
JAX package's: CPU, fp32, JAX at ``jax_default_matmul_precision=highest``."""

import os
import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax

from flamed_tts_tpu.models.facodec.decoder import init_decoder_params
from flamed_tts_tpu.models.facodec.extras import init_decoder_training_heads
from flamed_tts_tpu.models.flamed import Flamed as JFlamed
from flamed_tts_tpu.runtime.pytree_io import load_pytree_npz as j_load_pytree_npz

from flamed_tts_tpu_torch import convert_ckpt
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.runtime.pytree_io import flatten_pytree

from torch_parity_utils import CODEC_DIR, ROOT, jax_params, small_config

sys.path.insert(0, ROOT)
from tools import convert_torch_ckpt as tool  # noqa: E402

NSTEPS = 2
N_PHON = 12
L_BUCKET = 16
# the three ways a conv's weight is stored in a reference state dict
WN_STYLES = ("weight_v", "parametrizations", "plain")


# --- the inverse of the key mapping: trees -> reference state dicts --------


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _wn(sd, tree, prefix, style):
    w = np.asarray(tree["w"], np.float32)
    g = np.sqrt((w.astype(np.float64) ** 2).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
    if style == "weight_v":
        sd[f"{prefix}.weight_v"], sd[f"{prefix}.weight_g"] = _t(w), _t(g)
    elif style == "parametrizations":
        sd[f"{prefix}.parametrizations.weight.original1"] = _t(w)
        sd[f"{prefix}.parametrizations.weight.original0"] = _t(g)
    else:
        sd[f"{prefix}.weight"] = _t(w)
    if "b" in tree:
        sd[f"{prefix}.bias"] = _t(tree["b"])


def _act(sd, tree, prefix):
    sd[f"{prefix}.alpha"], sd[f"{prefix}.beta"] = _t(tree["alpha"]), _t(tree["beta"])


def _unit(sd, tree, prefix, style):
    _act(sd, tree["act1"], f"{prefix}.block.0.act")
    _wn(sd, tree["conv1"], f"{prefix}.block.1", style)
    _act(sd, tree["act2"], f"{prefix}.block.2.act")
    _wn(sd, tree["conv2"], f"{prefix}.block.3", style)


def encoder_state_dict(tree, style):
    sd = {}
    _wn(sd, tree["stem"], "block.0", style)
    for i, blk in enumerate(tree["blocks"], start=1):
        for j, unit in enumerate(blk["res"]):
            _unit(sd, unit, f"block.{i}.block.{j}", style)
        _act(sd, blk["act"], f"block.{i}.block.3.act")
        _wn(sd, blk["down"], f"block.{i}.block.4", style)
    _act(sd, tree["final_act"], "block.5.act")
    _wn(sd, tree["out"], "block.6", style)
    return sd


def _transformer(sd, tree, prefix):
    for i, layer in enumerate(tree["layers"]):
        lp = f"{prefix}.layers.{i}"
        for name, key in (("ln_1", "ln1"), ("ln_2", "ln2")):
            sd[f"{lp}.{name}.weight"], sd[f"{lp}.{name}.bias"] = _t(layer[key]["g"]), _t(layer[key]["b"])
        attn = layer["attn"]
        sd[f"{lp}.self_attn.in_proj_weight"] = _t(attn["in_proj_w"])
        sd[f"{lp}.self_attn.in_proj_bias"] = _t(attn["in_proj_b"])
        sd[f"{lp}.self_attn.out_proj.weight"] = _t(attn["out_proj_w"])
        sd[f"{lp}.self_attn.out_proj.bias"] = _t(attn["out_proj_b"])
        for name, key in (("ffn_1", "ffn1"), ("ffn_2", "ffn2")):
            sd[f"{lp}.ffn.{name}.weight"], sd[f"{lp}.ffn.{name}.bias"] = _t(layer[key]["w"]), _t(layer[key]["b"])
    sd[f"{prefix}.last_ln.weight"], sd[f"{prefix}.last_ln.bias"] = _t(tree["last_ln"]["g"]), _t(tree["last_ln"]["b"])


def decoder_state_dict(tree, style):
    sd = {}
    for g, group in enumerate(tree["quantizers"]):
        for q, fvq in enumerate(group):
            p = f"quantizer.{g}.layers.{q}"
            _wn(sd, fvq["in_proj"], f"{p}.in_proj", style)
            _wn(sd, fvq["out_proj"], f"{p}.out_proj", style)
            sd[f"{p}._codebook.weight"] = _t(fvq["codebook"])
    _transformer(sd, tree["timbre_encoder"], "timbre_encoder")
    sd["timbre_linear.weight"], sd["timbre_linear.bias"] = _t(tree["timbre_linear"]["w"]), _t(tree["timbre_linear"]["b"])
    _wn(sd, tree["stem"], "model.0", style)
    for i, blk in enumerate(tree["blocks"], start=1):
        _act(sd, blk["act"], f"model.{i}.block.0.act")
        _wn(sd, blk["up"], f"model.{i}.block.1", style)
        for j, unit in enumerate(blk["res"], start=2):
            _unit(sd, unit, f"model.{i}.block.{j}", style)
    _act(sd, tree["final_act"], "model.5.act")
    _wn(sd, tree["out"], "model.6", style)
    return sd


def heads_state_dict(heads, style):
    sd = {}
    for name, tree in heads.items():
        prefix = f"{name}.1" if name.startswith(("res_", "x_")) else name  # GradientReversal-wrapped
        for j, unit in enumerate(tree["res"]):
            _unit(sd, unit, f"{prefix}.model.{j}", style)
        _act(sd, tree["act"], f"{prefix}.model.3.act")
        for i, h in enumerate(tree["heads"]):
            sd[f"{prefix}.heads.{i}.weight"], sd[f"{prefix}.heads.{i}.bias"] = _t(h["w"]), _t(h["b"])
    return sd


# --- trees and comparisons --------------------------------------------------


def assert_trees_identical(a, b, path="root"):
    """Same structure and leaves equal bit for bit, with the same dtype,
    shape and memory order."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_trees_identical(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_identical(x, y, f"{path}/{i}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.flags.f_contiguous == b.flags.f_contiguous, path
        assert np.array_equal(np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8)), path


@pytest.fixture(scope="module")
def codec_trees():
    """The trained codec_r5 encoder; a narrow random decoder and predictor
    heads (all the JAX package's trees)."""
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    enc = j_load_pytree_npz(os.path.join(CODEC_DIR, "ns3_facodec_encoder.npz"))
    # one compiled program (eagerly, the init is hundreds of small calls)
    dec = jax.device_get(jax.jit(partial(init_decoder_params, in_channels=32,
                                         upsample_initial_channel=64))(keys[0]))
    heads = jax.device_get(init_decoder_training_heads(
        keys[1], in_channels=32, phone_classes=11, speaker_classes=7, use_gr_residual_f0=True,
        use_gr_residual_phone=True, use_gr_x_timbre=True))
    rng = np.random.RandomState(0)
    v2 = {"melspec_linear": {"w": rng.randn(32, 20).astype(np.float32), "b": rng.randn(32).astype(np.float32)},
          "melspec_encoder": dec["timbre_encoder"]}
    return enc, dec, heads, v2


@pytest.mark.parametrize("style", WN_STYLES)
def test_codec_encoder_equal_to_the_tool(codec_trees, style):
    enc = codec_trees[0]
    sd = encoder_state_dict(enc, style)
    got = convert_ckpt.convert_facodec_encoder(sd)
    assert_trees_identical(got, tool.convert_facodec_encoder(sd))
    assert_trees_identical(convert_ckpt.convert_facodec_encoder_v2(sd), tool.convert_facodec_encoder_v2(sd))
    # the fold undoes the un-fold to within float64 rounding
    got, enc = flatten_pytree(got), flatten_pytree(enc)
    assert set(got) == set(enc)
    for k in enc:
        np.testing.assert_allclose(got[k], enc[k], rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("style", WN_STYLES)
def test_codec_decoder_and_v2_equal_to_the_tool(codec_trees, style):
    _, dec, _, v2 = codec_trees
    sd = decoder_state_dict(dec, style)
    assert_trees_identical(convert_ckpt.convert_facodec_decoder(sd), tool.convert_facodec_decoder(sd))
    sd["melspec_linear.weight"], sd["melspec_linear.bias"] = _t(v2["melspec_linear"]["w"]), _t(v2["melspec_linear"]["b"])
    _transformer(sd, v2["melspec_encoder"], "melspec_encoder")
    got = convert_ckpt.convert_facodec_decoder_v2(sd)
    assert_trees_identical(got, tool.convert_facodec_decoder_v2(sd))
    assert set(got) == set(dec) | {"melspec_linear", "melspec_encoder"}


@pytest.mark.parametrize("style", ["weight_v", "parametrizations"])
def test_training_heads_equal_to_the_tool(codec_trees, style):
    heads = codec_trees[2]
    sd = heads_state_dict(heads, style)
    got = convert_ckpt.convert_decoder_training_heads(sd)
    assert_trees_identical(got, tool.convert_decoder_training_heads(sd))
    assert set(got) == set(heads) == {"f0_predictor", "phone_predictor", "res_f0_predictor",
                                      "res_phone_predictor", "x_timbre_predictor"}
    plain = {k: v for k, v in sd.items() if not k.startswith(("res_", "x_"))}
    assert set(convert_ckpt.convert_decoder_training_heads(plain)) == {"f0_predictor", "phone_predictor"}


@pytest.fixture(scope="module")
def flamed_setup():
    cfg = small_config()
    jmodel, params = jax_params(cfg, seed=5)
    host = jax.device_get(jmodel.params)
    return cfg, jmodel, host, convert_ckpt.flamed_state_dict(host)


def test_flamed_state_dict_inverts_the_tool(flamed_setup):
    """The inverse used to build reference-format checkpoints: the tool
    maps it back to the JAX tree exactly, and the port's converter agrees."""
    _, _, host, sd = flamed_setup
    assert_trees_identical(tool.convert_flamed_checkpoint(sd), convert_ckpt.convert_flamed_checkpoint(sd))
    for part in ("prior", "prob"):
        back = flatten_pytree(convert_ckpt.convert_flamed_checkpoint({"state_dict": sd})[part])
        ref = flatten_pytree(host[part])
        assert set(back) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def _save_input(tmp_path, kind, codec_trees, flamed_sd):
    enc, dec = codec_trees[:2]
    sd = {"codec-encoder": lambda: encoder_state_dict(enc, "weight_v"),
          "codec-decoder": lambda: decoder_state_dict(dec, "parametrizations"),
          "flamed": lambda: {"state_dict": flamed_sd, "epoch": 3}}[kind]()
    path = str(tmp_path / f"{kind}.ckpt")
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("kind", ["codec-encoder", "codec-decoder", "flamed"])
def test_cli_writes_the_tools_npz(tmp_path, monkeypatch, codec_trees, flamed_setup, kind):
    path = _save_input(tmp_path, kind, codec_trees, flamed_setup[3])
    convert_ckpt.main(["--kind", kind, path, str(tmp_path / "port.npz")])
    monkeypatch.setattr(sys, "argv", ["convert_torch_ckpt.py", "--kind", kind, path,
                                      str(tmp_path / "tool.npz")])
    tool.main()
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "tool.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert_trees_identical(j_load_pytree_npz(str(tmp_path / "port.npz")),
                           j_load_pytree_npz(str(tmp_path / "tool.npz")))


def _jax_noise(rng, f_bucket):
    rng1, rng2 = jax.random.split(rng)
    rng_dur, rng_sil = jax.random.split(rng1)
    return {"dur": np.asarray(jax.random.normal(rng_dur, (1, L_BUCKET))),
            "sil": np.asarray(jax.random.normal(rng_sil, (1, L_BUCKET))),
            "latents": np.asarray(jax.random.normal(rng2, (1, f_bucket, 256)))}


@pytest.mark.parametrize("lightning,weights_only", [(False, True), (True, False)])
def test_from_pretrained_reference_checkpoint_equals_jax(tmp_path, flamed_setup, lightning,
                                                         weights_only):
    """A reference checkpoint (a bare dict read weights-only, or a
    Lightning-style dict read in full) through ``Flamed.from_pretrained`` of
    both packages: the same durations, lengths and mask, and latents within
    the fused parity tests' 1e-4."""
    cfg, _, _, sd = flamed_setup
    path = str(tmp_path / ("model.ckpt" if lightning else "model.pt"))
    torch.save({"state_dict": sd, "epoch": 3} if lightning else sd, path)
    jmodel = JFlamed.from_pretrained(cfg, path, weights_only=weights_only)
    model = Flamed.from_pretrained(cfg, path, weights_only=weights_only, device="cpu")

    rng = np.random.RandomState(8)
    phonemes = rng.randint(1, 300, (1, N_PHON))
    prompts = rng.randint(0, 1024, (1, 6, 20))
    timbres = rng.randn(1, 256).astype(np.float32)
    key = jax.random.PRNGKey(9)
    padded = np.zeros((1, L_BUCKET), np.int64)
    padded[:, :N_PHON] = phonemes
    _, j_dur, j_sil, _ = jmodel.sampler._stage1_impl(
        jmodel.params["prior"], padded.astype(np.int32), np.array([N_PHON], np.int32),
        jax.random.split(key)[0], NSTEPS, 0.3)
    _, dur, sil, _ = model.sampler._stage1(torch.from_numpy(padded), torch.tensor([N_PHON]),
                                           _jax_noise(key, 8), None, NSTEPS, 0.3)
    np.testing.assert_array_equal(dur.numpy(), np.asarray(j_dur))
    np.testing.assert_array_equal(sil.numpy(), np.asarray(j_sil))

    ref = jmodel.sample_batch(phonemes=phonemes.astype(np.int32), src_lens=np.array([N_PHON], np.int32),
                              prompts=prompts.astype(np.int32), timbres=timbres,
                              nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS, rng=key)
    f_bucket = int(ref["latents"].shape[1])
    out = model.sample_batch(phonemes=phonemes, src_lens=np.array([N_PHON]), prompts=prompts,
                             timbres=timbres, nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS,
                             noise=_jax_noise(key, f_bucket))
    np.testing.assert_array_equal(out["tgt_len"], np.asarray(ref["tgt_len"]))
    np.testing.assert_array_equal(out["tgt_mask"], np.asarray(ref["tgt_mask"]))
    n = int(out["tgt_len"][0])
    np.testing.assert_allclose(out["latents"][0, :n].numpy(), np.asarray(ref["latents"])[0, :n],
                               atol=1e-4, rtol=1e-4)


def test_from_pretrained_refuses_pickles_weights_only(tmp_path, flamed_setup):
    """weights_only (the default) refuses a checkpoint that holds objects
    other than tensors and plain containers."""
    cfg, _, _, sd = flamed_setup
    path = str(tmp_path / "odd.ckpt")
    torch.save({"state_dict": sd, "hparams": np.random.RandomState(0)}, path)
    with pytest.raises(Exception, match="[Ww]eights"):
        Flamed.from_pretrained(cfg, path, device="cpu")
    assert Flamed.from_pretrained(cfg, path, weights_only=False, device="cpu").num_params() > 0
