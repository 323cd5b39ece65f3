"""YAML config reading and writing (the schema of ``configs/*.yaml``).

The merged config has the keys ``prior_generator``, ``prob_generator``,
``codec_cfg``, ``optimizer_cfg`` and ``dataset_cfg``, as the JAX package
composes them; ``save_yaml`` writes the merged ``config.yaml`` that the
synthesis CLI reads.  ``load_config`` returns a ``ConfigDict``
(``cfg["a"]["b"]`` and ``cfg.a.b``), as the JAX package's does.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Iterator, Mapping, Optional

import yaml

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG_DIR = os.path.join(REPO_ROOT, "configs")


class ConfigDict(dict):
    """A dict with attribute access; a dict value is wrapped in a
    ConfigDict when it is first read."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __getitem__(self, key: str) -> Any:
        value = dict.__getitem__(self, key)
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
            dict.__setitem__(self, key, value)
        return value

    def get(self, key: str, default: Any = None) -> Any:
        return self[key] if key in self else default

    def to_dict(self) -> Dict[str, Any]:
        """A deep copy as plain dicts."""
        return _plain(self)


def _plain(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return copy.deepcopy(value)


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as fin:
        data = yaml.safe_load(fin) or {}
    if not isinstance(data, dict):
        raise ValueError(f"top-level YAML value in {path} must be a mapping")
    return data


def default_config_dir() -> str:
    return DEFAULT_CONFIG_DIR


def load_config(path: str) -> ConfigDict:
    """A merged config.yaml (the file the synthesis CLI reads)."""
    return ConfigDict(load_yaml(path))


def load_default_config(config_dir: Optional[str] = None) -> Dict[str, Any]:
    """The five files of ``config_dir`` (the repository's ``configs/`` by
    default) composed into the merged config, plain dicts (wrap it in a
    ``ConfigDict`` for attribute access)."""
    d = config_dir or DEFAULT_CONFIG_DIR
    return compose_training_config(
        os.path.join(d, "prior.yaml"), os.path.join(d, "prob.yaml"), os.path.join(d, "codec.yaml"),
        os.path.join(d, "optimizer.yaml"), os.path.join(d, "data.yaml"))


def iter_flat(cfg: Mapping[str, Any], prefix: str = "") -> Iterator[tuple]:
    """(dotted path, value) of every leaf, depth first in key order."""
    for key, value in cfg.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from iter_flat(value, path)
        else:
            yield path, value


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
        yaml.safe_dump(_plain(cfg), fout, sort_keys=False)
