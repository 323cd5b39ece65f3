"""Parameter trees of the JAX package -> the port's parameters.

* Flax trees (prior, prob: ``{"params": {...}}``) become a PyTorch
  ``state_dict``: path components join with '.', Dense kernels (in, out)
  become Linear weights (out, in), Conv kernels (K, Cin, Cout) become
  Conv1d weights (Cout, Cin, K) (a DepthwiseConv1D kernel (K, 1, C)
  becomes (C, 1, K)), and ``embedding`` / ``scale`` become ``weight``.
* Codec trees (encoder, decoder) already hold PyTorch layouts
  (conv (out, in, k), conv-transpose (in, out, k)); they keep their
  nesting with every leaf a float32 tensor.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

_RENAME = {"kernel": "weight", "embedding": "weight", "scale": "weight"}


def _flax_state_dict(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flax_state_dict(value, f"{prefix}{key}."))
            continue
        v = np.asarray(value, dtype=np.float32)
        if key == "kernel":
            v = v.T if v.ndim == 2 else v.transpose(2, 1, 0)
        out[prefix + _RENAME.get(key, key)] = torch.from_numpy(np.array(v, order="C"))
    return out


def codec_tree(tree: Any, device: Union[str, torch.device] = "cpu") -> Any:
    """Nested dicts/lists of arrays -> the same of contiguous float32
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: codec_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [codec_tree(v, device) for v in tree]
    return torch.as_tensor(np.array(tree, dtype=np.float32)).to(device)


def params_from_jax(tree: Any) -> Any:
    """A JAX parameter tree of numpy arrays -> a state_dict (flax trees)
    or a tensor tree (codec trees)."""
    if isinstance(tree, dict) and set(tree) == {"params"}:
        return _flax_state_dict(tree["params"])
    return codec_tree(tree)
