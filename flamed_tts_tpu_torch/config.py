"""YAML config reading (the schema of ``configs/*.yaml``).

The merged config has the keys ``prior_generator``, ``prob_generator``,
``codec_cfg`` and ``dataset_cfg``, as the JAX package composes them.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

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
