"""FaCodec decoder: analysis (RVQ codes + timbre) and synthesis
(latents + timbre -> wav).

* ``analyze``: prompt latents -> 6 code streams [prosody, content x2,
  residual x3] (the residual group quantizes x - (prosody + content)) and
  the pooled timbre vector.
* ``synthesize``: timbre-conditioned LayerNorm -> conv stem -> 4 decoder
  blocks (Snake, strided conv-transpose, 3 residual units) -> Snake ->
  output conv -> tanh.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from flamed_tts_tpu_torch.models.facodec.encoder import init_act, init_conv, init_unit
from flamed_tts_tpu_torch.models.facodec.quantize import linear, rvq_decode, rvq_encode
from flamed_tts_tpu_torch.models.facodec.timbre import (init_linear, init_timbre_params,
                                                        timbre_encoder_forward)
from flamed_tts_tpu_torch.ops.conv1d import conv1d, conv_transpose1d
from flamed_tts_tpu_torch.ops.resunit import residual_stack
from flamed_tts_tpu_torch.ops.snake import snake_filtered

GROUP_SIZES = (1, 2, 3)  # prosody, content, residual quantizer counts


def analyze(params: Dict, latents: Tensor, pad_mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Returns (codes (6, B, T) int32, timbre (B, 256))."""
    x = latents if pad_mask is None else latents.masked_fill(pad_mask[:, :, None], 0.0)
    prosody_codes, prosody_q = rvq_encode(x, params["quantizers"][0])
    content_codes, content_q = rvq_encode(x, params["quantizers"][1])
    residual_codes, _ = rvq_encode(x - (prosody_q + content_q), params["quantizers"][2])
    codes = torch.cat([prosody_codes, content_codes, residual_codes], dim=0)
    return codes, timbre_encoder_forward(params["timbre_encoder"], latents, pad_mask)


def vq2emb(params: Dict, codes: Tensor, use_residual: bool = True) -> Tensor:
    """codes (6, B, T) -> summed embeddings (B, T, 256)."""
    out = rvq_decode(codes[0:1], params["quantizers"][0])
    out = out + rvq_decode(codes[1:3], params["quantizers"][1])
    if use_residual:
        out = out + rvq_decode(codes[3:6], params["quantizers"][2])
    return out


def decoder_block(x: Tensor, p: Dict, stride: int, fuse_blocks: bool = False,
                  prepared: Optional[List[Dict]] = None) -> Tensor:
    x = snake_filtered(x, p["act"]["alpha"], p["act"]["beta"])
    x = conv_transpose1d(x, p["up"]["w"], p["up"]["b"], stride=stride,
                         padding=stride // 2 + stride % 2, output_padding=stride % 2)
    return residual_stack(x, p["res"], fuse=fuse_blocks, prepared=prepared)


def synthesize(params: Dict, latents: Tensor, timbre: Tensor,
               up_ratios: Sequence[int] = (5, 5, 4, 2), fuse_blocks: bool = False,
               prepared: Optional[List[List[Dict]]] = None) -> Tensor:
    """latents (B, T, 256) + timbre (B, 256) -> wav (B, T * 200, 1), in the
    type of the parameters.  ``fuse_blocks`` runs a block's three residual
    units as one K3 launch where ``ops.resunit.stack_tile`` admits it.
    ``prepared`` holds, per block, its units' kernel-layout weights
    (``ops.resunit.prepare_unit``) where the caller keeps them."""
    style = linear(timbre, params["timbre_linear"])
    gamma, beta = style[:, None, :].chunk(2, dim=-1)
    mean = latents.mean(-1, keepdim=True)
    var = ((latents - mean) ** 2).mean(-1, keepdim=True)
    x = (latents - mean) / torch.sqrt(var + 1e-5) * gamma + beta
    x = conv1d(x, params["stem"]["w"], params["stem"]["b"], padding=3)
    for i, (block, stride) in enumerate(zip(params["blocks"], up_ratios)):
        x = decoder_block(x, block, stride, fuse_blocks, prepared[i] if prepared else None)
    x = snake_filtered(x, params["final_act"]["alpha"], params["final_act"]["beta"])
    x = conv1d(x, params["out"]["w"], params["out"]["b"], padding=3)
    return torch.tanh(x)


def init_fvq(g: torch.Generator, dim: int = 256, codebook_dim: int = 8, codebook_size: int = 1024) -> Dict:
    return {"in_proj": init_linear(g, codebook_dim, dim), "out_proj": init_linear(g, dim, codebook_dim),
            "codebook": torch.randn((codebook_size, codebook_dim), generator=g)}


def init_decoder_params(g: torch.Generator, in_channels: int = 256, upsample_initial_channel: int = 1024,
                        up_ratios: Sequence[int] = (5, 5, 4, 2)) -> Dict:
    """Random decoder parameters from ``g``: the JAX package's
    ``init_decoder_params`` tree (normal, not truncated normal, fan-in
    convs; the output conv scaled by 0.01 so that the tanh starts in its
    linear region)."""
    dim, ch = in_channels, upsample_initial_channel
    timbre = init_timbre_params(g, dim)  # drawn first: FaCodec.random_init's values stay as they were
    p: Dict = {
        "quantizers": [[init_fvq(g, dim) for _ in range(n)] for n in GROUP_SIZES],
        "timbre_encoder": timbre,
        # gamma half of the bias 1, beta half 0
        "timbre_linear": {"w": init_linear(g, 2 * dim, dim)["w"],
                          "b": torch.cat([torch.ones(dim), torch.zeros(dim)])},
        "stem": init_conv(g, ch, dim, 7),
        "blocks": [],
    }
    for i, stride in enumerate(up_ratios):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        up = torch.randn((c_in, c_out, 2 * stride), generator=g) / np.sqrt(2 * c_in)
        p["blocks"].append({"act": init_act(c_in), "up": {"w": up, "b": torch.zeros(c_out)},
                            "res": [init_unit(g, c_out) for _ in range(3)]})
    final = ch // 2 ** len(up_ratios)
    p["final_act"] = init_act(final)
    p["out"] = init_conv(g, 1, final, 7)
    p["out"]["w"] = p["out"]["w"] * 0.01
    return p
