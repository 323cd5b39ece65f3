"""Factorized / residual vector quantization, inference path: project to
the 8-d codebook space, L2-normalize both sides, nearest neighbour by
argmax of the cosine.

Per layer: {"in_proj": {"w": (8, 256), "b"}, "out_proj": {"w": (256, 8),
"b"}, "codebook": (1024, 8)}.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import Tensor


def linear(x: Tensor, p: Dict) -> Tensor:
    """x @ w.T + b with w (out, in).  Operands of unlike types are promoted
    to the wider one first (float32 activations against bfloat16 weights
    give float32), as the JAX package's ``@`` does."""
    dtype = torch.promote_types(x.dtype, p["w"].dtype)
    return x.to(dtype) @ p["w"].t().to(dtype) + p["b"]


def _l2_normalize(x: Tensor) -> Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def fvq_encode(x: Tensor, p: Dict) -> Tuple[Tensor, Tensor]:
    """(B, T, D) -> (codes (B, T) int32, quantized (B, T, D))."""
    z_n = _l2_normalize(linear(x, p["in_proj"]))
    c_n = _l2_normalize(p["codebook"])
    codes = torch.argmax(z_n @ c_n.t(), dim=-1)
    z_q = linear(p["codebook"][codes], p["out_proj"])
    return codes.to(torch.int32), z_q


def rvq_encode(x: Tensor, layers: List[Dict]) -> Tuple[Tensor, Tensor]:
    """Returns (codes (n_layers, B, T), quantized sum (B, T, D))."""
    residual = x
    quantized_sum = torch.zeros_like(x)
    codes = []
    for layer in layers:
        c, q = fvq_encode(residual, layer)
        residual = residual - q
        quantized_sum = quantized_sum + q
        codes.append(c)
    return torch.stack(codes, dim=0), quantized_sum


def rvq_decode(codes: Tensor, layers: List[Dict]) -> Tensor:
    """(n_layers, B, T) codes -> summed embeddings (B, T, D)."""
    out = None
    for idx, layer in enumerate(layers):
        q = linear(layer["codebook"][codes[idx].long()], layer["out_proj"])
        out = q if out is None else out + q
    return out
