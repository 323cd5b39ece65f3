"""Nested-pytree .npz files: keys are '/'-joined paths, list indices are
numeric components (the format of ``artifacts/codec_r5/*.npz`` and of the
JAX package's training checkpoints)."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def flatten_pytree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for key, value in tree.items():
            out.update(flatten_pytree(value, f"{prefix}/{key}" if prefix else str(key)))
    elif isinstance(tree, (list, tuple)):
        for idx, value in enumerate(tree):
            out.update(flatten_pytree(value, f"{prefix}/{idx}" if prefix else str(idx)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def unflatten_pytree(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_pytree_npz(path: str) -> Any:
    with np.load(path) as data:
        flat = {key: data[key] for key in data.files}
    return unflatten_pytree(flat)


def save_pytree_npz(path: str, tree: Any) -> None:
    """Write ``tree`` as a compressed .npz that ``load_pytree_npz`` (here or
    in the JAX package) reads back."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flatten_pytree(tree))
