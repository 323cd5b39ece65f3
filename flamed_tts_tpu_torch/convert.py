"""Parameter trees of the JAX package <-> the port's parameters.

* Flax trees (prior, prob: ``{"params": {...}}``) become a PyTorch
  ``state_dict``: path components join with '.', Dense kernels (in, out)
  become Linear weights (out, in), Conv kernels (K, Cin, Cout) become
  Conv1d weights (Cout, Cin, K) (a DepthwiseConv1D kernel (K, 1, C)
  becomes (C, 1, K)), and ``embedding`` / ``scale`` become ``weight``.
* Codec trees (encoder, decoder) already hold PyTorch layouts
  (conv (out, in, k), conv-transpose (in, out, k)); they keep their
  nesting with every leaf a float tensor.

``params_to_jax`` is the inverse of both: a prior or prob ``state_dict`` (or
any flat dict of tensors under the same dotted names, such as their
gradients) becomes a ``{"params": ...}`` flax tree of float32 numpy arrays,
which is what the JAX package's training checkpoints hold; a codec tree (the
encoder, the decoder, the codec trainer's heads, the predictor heads, the
redecoder and the V2 trees: nested dicts and lists, or a flat dict without a
dotted name) becomes the same nesting of float32 numpy arrays.

A leaf is a numpy array or a tensor.  A bfloat16 leaf (a bfloat16 tensor,
or a numpy array of the ``bfloat16`` extension type that JAX arrays convert
to) stays bfloat16 with the same bits; every other leaf becomes float32.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

_RENAME = {"kernel": "weight", "embedding": "weight", "scale": "weight"}
# the modules of the prior and prob generators that are flax ``nn.Embed``s
EMBEDDINGS = ("src_word_emb", "code_embedding", "quantizer_emb")


def _flax_state_dict(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flax_state_dict(value, f"{prefix}{key}."))
            continue
        v = _leaf(value)
        if key == "kernel":
            v = v.t() if v.dim() == 2 else v.permute(2, 1, 0)
        out[prefix + _RENAME.get(key, key)] = v.contiguous()
    return out


def _leaf(value: Any) -> torch.Tensor:
    """One array -> a float32 tensor, or a bfloat16 tensor of the same
    bits where the array is bfloat16."""
    if isinstance(value, torch.Tensor):
        return value if value.dtype == torch.bfloat16 else value.float()
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":  # numpy itself has no such type
        bits = np.ascontiguousarray(value).view(np.uint16).astype(np.int32)
        return torch.from_numpy(bits).to(torch.int16).view(torch.bfloat16)
    return torch.from_numpy(np.array(value, dtype=np.float32))


def codec_tree(tree: Any, device: Union[str, torch.device] = "cpu") -> Any:
    """Nested dicts/lists of arrays -> the same of contiguous float
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: codec_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [codec_tree(v, device) for v in tree]
    return _leaf(tree).contiguous().to(device)


def params_from_jax(tree: Any) -> Any:
    """A JAX parameter tree of numpy arrays -> a state_dict (flax trees)
    or a tensor tree (codec trees)."""
    if isinstance(tree, dict) and set(tree) == {"params"}:
        return _flax_state_dict(tree["params"])
    return codec_tree(tree)


def _is_state_dict(tree: Any) -> bool:
    return (isinstance(tree, dict) and bool(tree) and all(isinstance(v, torch.Tensor) for v in tree.values())
            and any("." in k for k in tree))


def _codec_to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _codec_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_codec_to_numpy(v) for v in tree]
    return np.ascontiguousarray(tree.detach().float().cpu().numpy())


def params_to_jax(state_dict: Any) -> Any:
    """A prior or prob ``state_dict`` -> ``{"params": nested flax tree}``:
    Linear weights (out, in) become Dense kernels (in, out), Conv1d weights
    (Cout, Cin, K) become Conv kernels (K, Cin, Cout), the weights of the
    ``EMBEDDINGS`` become ``embedding`` and 1-D (norm) weights ``scale``.
    A codec tree -> the same nesting of float32 numpy arrays (the inverse
    of ``codec_tree``)."""
    if not _is_state_dict(state_dict):
        return _codec_to_numpy(state_dict)
    tree: Dict = {}
    for name, value in state_dict.items():
        *path, leaf = name.split(".")
        v = value.detach().float().cpu()
        if leaf == "weight":
            if v.dim() == 1:
                leaf = "scale"
            elif path[-1] in EMBEDDINGS:
                leaf = "embedding"
            else:
                leaf = "kernel"
                v = v.t() if v.dim() == 2 else v.permute(2, 1, 0)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(v.numpy())
    return {"params": tree}
