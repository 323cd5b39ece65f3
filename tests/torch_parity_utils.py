"""Shared set-up of the port's parity tests: a narrow config, JAX random
weights carried across with params_from_jax, a deterministic prompt."""

import copy
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from flamed_tts_tpu_torch.config import load_default_config
from flamed_tts_tpu_torch.convert import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODEC_DIR = os.path.join(ROOT, "artifacts", "codec_r5")


def small_config():
    """configs/*.yaml cut to narrow widths and 1-2 layers; the codec-facing
    widths (target_dim, spk_dim 256) stay, so the real codec plugs in."""
    cfg = copy.deepcopy(load_default_config())
    prior = cfg["prior_generator"]
    t = prior["transformer"]
    t.update(encoder_layer=2, encoder_head=2, encoder_hidden=32, encoder_conv_filter_size=64,
             decoder_shared_layers=1, decoder_layers=[1, 2, 1, 1, 1, 1], decoder_head=4,
             decoder_hidden=48, decoder_conv_filter_size=96)
    for g in ("duration_generator", "sil_generator"):
        prior["variance_adaptor"][g].update(input_size=32, filter_size=64)
    cfg["prob_generator"].update(cond_dim=48, hidden_dim=64, n_layers=2)
    cfg["dataset_cfg"].update(phoneme_buckets=[16, 32], frame_buckets=[32, 64, 128, 256],
                              prompt_buckets=[64, 128])
    return cfg


def jax_params(cfg, seed=0):
    """(JAX Flamed with random weights, the same weights as port params)."""
    from flamed_tts_tpu.models.flamed import Flamed as JFlamed

    jmodel = JFlamed(cfg, rng=jax.random.PRNGKey(seed))
    host = jax.device_get(jmodel.params)
    return jmodel, {k: params_from_jax(host[k]) for k in ("prior", "prob")}


def prompt_wav(seconds: float, seed: int = 0) -> np.ndarray:
    """A deterministic voiced-like test signal at 16 kHz."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    f0 = 140.0 + 20.0 * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    wav = sum(np.sin(k * phase) / k for k in range(1, 6)) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2)
    return (0.2 * wav + 0.01 * rng.randn(t.size)).astype(np.float32)


def summaries_equal(exp_dir, capsys, monkeypatch, every=2):
    """``python -m flamed_tts_tpu_torch.summarize_training`` against
    ``tools/summarize_training.py`` on ``exp_dir``: the same return code,
    stdout and stderr.  Returns (rc, stdout)."""
    from flamed_tts_tpu_torch import summarize_training

    spec = importlib.util.spec_from_file_location(
        "summarize_training_tool", os.path.join(ROOT, "tools", "summarize_training.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["summarize_training.py", str(exp_dir), "--every", str(every)])
    capsys.readouterr()  # what the caller printed before
    rc_ref, ref = tool.main(), capsys.readouterr()
    rc = summarize_training.main([str(exp_dir), "--every", str(every)])
    out = capsys.readouterr()
    assert (rc, out.out, out.err) == (rc_ref, ref.out, ref.err)
    return rc, out.out


def narrow_codec_dir(out_dir, seed=0):
    """A narrow random codec (encoder ngf 4, decoder from 64 channels; the
    256-wide latents and timbre stay) saved as the two .npz files that
    both packages' FaCodec.from_pretrained read; returns (encoder tree,
    decoder tree) as numpy."""
    from flamed_tts_tpu_torch.convert import params_to_jax
    from flamed_tts_tpu_torch.models.facodec.decoder import init_decoder_params
    from flamed_tts_tpu_torch.models.facodec.encoder import init_encoder_params
    from flamed_tts_tpu_torch.runtime.pytree_io import save_pytree_npz

    g = torch.Generator().manual_seed(seed)
    enc = params_to_jax(init_encoder_params(g, ngf=4))
    dec = params_to_jax(init_decoder_params(g, upsample_initial_channel=64))
    codec_cfg = load_default_config()["codec_cfg"]
    save_pytree_npz(os.path.join(out_dir, codec_cfg["encoder"]["ckpt_filename"]), enc)
    save_pytree_npz(os.path.join(out_dir, codec_cfg["decoder"]["ckpt_filename"]), dec)
    return enc, dec


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch ops on one CPU thread, then restore the
    count.  The evaluation tests run many small ops, which lose more to
    thread start-up (and, under several test workers on one host, to
    threads waiting on each other) than they gain from a pool; a test
    module imports this fixture by name to take it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
