"""FaCodec timbre (speaker) encoder: 4-layer pre-LN transformer, masked
mean pooling.

Kept from the trained reference: its positional encoding is indexed by
the *batch* index, so batch row b gets the constant sinusoid row b added
to every frame (``batch_constant_positional_bias``).  Padded keys are
masked and the pooling is a masked mean, so a padded prompt gives the
exact-length result.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from flamed_tts_tpu_torch.models.facodec.quantize import linear
from flamed_tts_tpu_torch.ops.conv1d import conv1d

_NEG_INF = -1e9


def positional_buffer_np(d_model: int, max_len: int = 5000) -> np.ndarray:
    """The reference's (max_len, d) sinusoid buffer in float64."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


@functools.lru_cache(maxsize=None)
def _positional_bias(b: int, d_model: int, max_len: int, device: torch.device) -> Tensor:
    return torch.as_tensor(positional_buffer_np(d_model, max_len)[:b, None, :], dtype=torch.float32,
                           device=device)


def batch_constant_positional_bias(b: int, d_model: int, device=None, max_len: int = 5000) -> Tensor:
    """(B, 1, d) bias: rows 0..B-1 of the reference's sinusoid buffer, built
    in float64 as the JAX package builds it, once per (shape, device): later
    calls return the same tensor, so the codec's analysis copies nothing up
    from the host for it.  Callers must not write into it."""
    return _positional_bias(b, d_model, max_len, torch.device("cpu" if device is None else device))


def _layer_norm(x: Tensor, p: Dict, eps: float = 1e-5) -> Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["g"] + p["b"]


def _mha(x: Tensor, p: Dict, n_head: int, pad_mask: Optional[Tensor]) -> Tensor:
    """torch.nn.MultiheadAttention math with packed qkv projections."""
    b, l, d = x.shape
    q, k, v = linear(x, {"w": p["in_proj_w"], "b": p["in_proj_b"]}).split(d, dim=-1)
    hd = d // n_head
    q, k, v = (t.reshape(b, l, n_head, hd).transpose(1, 2) for t in (q, k, v))
    scores = q @ k.transpose(-1, -2) / np.sqrt(hd)
    if pad_mask is not None:
        scores = scores.masked_fill(pad_mask[:, None, None, :], _NEG_INF)
    out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, l, d)
    return linear(out, {"w": p["out_proj_w"], "b": p["out_proj_b"]})


def timbre_encoder_forward(params: Dict, x: Tensor, pad_mask: Optional[Tensor] = None,
                           n_head: int = 4, conv_kernel: int = 5) -> Tensor:
    """(B, T, 256) latents -> (B, 256) speaker embedding.  The positional
    bias is float32, so with bfloat16 parameters the residual stream is
    float32 and only the k=5 conv and the linear after it run in bfloat16
    (``conv1d`` casts to the weight's type), as in the JAX package."""
    x = x + batch_constant_positional_bias(x.shape[0], x.shape[-1], x.device)
    for layer in params["layers"]:
        x = x + _mha(_layer_norm(x, layer["ln1"]), layer["attn"], n_head, pad_mask)
        h = _layer_norm(x, layer["ln2"])
        if pad_mask is not None:
            # the k=5 conv must see zeros at the true boundary
            h = h.masked_fill(pad_mask[:, :, None], 0.0)
        h = F.relu(conv1d(h, layer["ffn1"]["w"], layer["ffn1"]["b"], padding=conv_kernel // 2))
        x = x + linear(h, layer["ffn2"])
    x = _layer_norm(x, params["last_ln"])
    if pad_mask is not None:
        valid = (~pad_mask)[:, :, None].to(x.dtype)
        return (x * valid).sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1.0)
    return x.mean(dim=1)


def init_linear(g: torch.Generator, c_out: int, c_in: int) -> Dict:
    return {"w": torch.randn((c_out, c_in), generator=g) * 0.02, "b": torch.zeros(c_out)}


def init_timbre_params(g: torch.Generator, d_model: int = 256, n_layers: int = 4, d_ffn: int = 1024,
                       conv_kernel: int = 5) -> Dict:
    """Random timbre-encoder parameters from ``g`` (normal, std 0.02; unit
    LayerNorms), the JAX package's ``init_timbre_params`` tree."""
    def ln():
        return {"g": torch.ones(d_model), "b": torch.zeros(d_model)}

    layers = [{"ln1": ln(), "ln2": ln(),
               "attn": {"in_proj_w": init_linear(g, 3 * d_model, d_model)["w"],
                        "in_proj_b": torch.zeros(3 * d_model),
                        "out_proj_w": init_linear(g, d_model, d_model)["w"],
                        "out_proj_b": torch.zeros(d_model)},
               "ffn1": {"w": torch.randn((d_ffn, d_model, conv_kernel), generator=g) * 0.02,
                        "b": torch.zeros(d_ffn)},
               "ffn2": init_linear(g, d_model, d_ffn)} for _ in range(n_layers)]
    return {"layers": layers, "last_ln": ln()}
