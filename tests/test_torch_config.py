"""The port's config module against the JAX package's: the composed
default config (with ``optimizer_cfg``), ``load_config``,
``default_config_dir``, ``iter_flat`` and ``ConfigDict``'s attribute
access, on ``configs/`` and ``configs_demo/``."""

import os

import pytest

from flamed_tts_tpu import config as jconfig

import flamed_tts_tpu_torch
from flamed_tts_tpu_torch import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("prior", "prob", "codec", "optimizer", "data")


def _jax_compose(d):
    return jconfig.compose_training_config(*(os.path.join(d, f"{name}.yaml") for name in FILES))


@pytest.mark.parametrize("dirname", ["configs", "configs_demo"])
def test_default_config_matches_jax(dirname):
    d = os.path.join(ROOT, dirname)
    ours, theirs = config.load_default_config(d), _jax_compose(d)
    assert list(ours) == list(theirs) == ["prior_generator", "prob_generator", "codec_cfg",
                                          "optimizer_cfg", "dataset_cfg"]
    assert ours == theirs.to_dict()
    assert ours["optimizer_cfg"] == theirs["optimizer_cfg"]
    assert list(config.iter_flat(ours)) == list(jconfig.iter_flat(theirs))
    wrapped = config.ConfigDict(ours)
    assert wrapped.prob_generator.convnext.kernel_size == theirs.prob_generator.convnext.kernel_size
    assert wrapped.to_dict() == ours
    if dirname == "configs":
        assert config.load_default_config() == jconfig.load_default_config().to_dict()


def test_load_config_and_default_dir(tmp_path):
    assert os.path.realpath(config.default_config_dir()) == os.path.realpath(jconfig.default_config_dir())
    merged = str(tmp_path / "config.yaml")
    wrapped = config.ConfigDict(config.load_default_config())
    assert wrapped.prior_generator.transformer.encoder_layer == 6  # nested ConfigDicts, then the dump
    config.save_yaml(wrapped, merged)
    ours, theirs = flamed_tts_tpu_torch.load_config(merged), jconfig.load_config(merged)
    assert isinstance(ours, config.ConfigDict)
    assert ours.to_dict() == theirs.to_dict() == jconfig.load_default_config().to_dict()
    assert list(config.iter_flat(ours)) == list(jconfig.iter_flat(theirs))
    assert ours.dataset_cfg.get("no_such_key", 7) == theirs.dataset_cfg.get("no_such_key", 7) == 7
    with pytest.raises(AttributeError):
        ours.no_such_key
    ours.extra = {"a": 1}
    assert ours["extra"].a == 1
