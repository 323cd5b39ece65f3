"""YAML config reading and writing (the schema of ``configs/*.yaml``).

The merged config has the keys ``prior_generator``, ``prob_generator``,
``codec_cfg`` and ``dataset_cfg`` (and for training ``optimizer_cfg``), as
the JAX package composes them; ``save_yaml`` writes the merged
``config.yaml`` that the synthesis CLI reads.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Mapping, Optional

import yaml

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG_DIR = os.path.join(REPO_ROOT, "configs")


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as fin:
        data = yaml.safe_load(fin) or {}
    if not isinstance(data, dict):
        raise ValueError(f"top-level YAML value in {path} must be a mapping")
    return data


def load_default_config(config_dir: Optional[str] = None) -> Dict[str, Any]:
    d = config_dir or DEFAULT_CONFIG_DIR
    return {
        "prior_generator": load_yaml(os.path.join(d, "prior.yaml")),
        "prob_generator": load_yaml(os.path.join(d, "prob.yaml")),
        "codec_cfg": load_yaml(os.path.join(d, "codec.yaml")),
        "dataset_cfg": load_yaml(os.path.join(d, "data.yaml")),
    }


def _deep_merge(base: Dict[str, Any], override: Mapping[str, Any]) -> Dict[str, Any]:
    for key, value in override.items():
        if isinstance(base.get(key), dict) and isinstance(value, Mapping):
            _deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


def compose_training_config(prior_path: str, prob_path: str, codec_path: str,
                            optimizer_path: str, data_path: str,
                            overrides: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """The five config files -> the merged training config, with
    ``overrides`` merged in key by key."""
    cfg = {"prior_generator": load_yaml(prior_path), "prob_generator": load_yaml(prob_path),
           "codec_cfg": load_yaml(codec_path), "optimizer_cfg": load_yaml(optimizer_path),
           "dataset_cfg": load_yaml(data_path)}
    return _deep_merge(cfg, overrides) if overrides else cfg


def save_yaml(cfg: Mapping[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fout:
        yaml.safe_dump(dict(cfg), fout, sort_keys=False)
