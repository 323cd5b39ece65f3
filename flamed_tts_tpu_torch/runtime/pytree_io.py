"""Nested-pytree .npz reading: keys are '/'-joined paths, list indices are
numeric components (the format of ``artifacts/codec_r5/*.npz``)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


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
