"""FaCodec encoder: wav (B, T, 1) -> latents (B, T / 200, 256).

Conv stem (k7) -> 4 encoder blocks (3 dilated residual units, Snake,
strided conv doubling the channels) -> Snake -> output conv.  Functions
over the converted param tree (nested dicts of tensors, torch conv
layouts).  On the card every Snake is K1 (ops/snake.py) and every block's
residual units are K2, or one K3 launch with ``fuse_blocks``
(ops/resunit.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import Tensor

from flamed_tts_tpu_torch.ops.conv1d import conv1d
from flamed_tts_tpu_torch.ops.resunit import residual_stack
from flamed_tts_tpu_torch.ops.snake import snake_filtered


def encoder_block(x: Tensor, p: Dict, stride: int, fuse_blocks: bool = False,
                  prepared: Optional[List[Dict]] = None) -> Tensor:
    x = residual_stack(x, p["res"], fuse=fuse_blocks, prepared=prepared)
    x = snake_filtered(x, p["act"]["alpha"], p["act"]["beta"])
    return conv1d(x, p["down"]["w"], p["down"]["b"], stride=stride,
                  padding=stride // 2 + stride % 2)


def encoder_forward(params: Dict, wav: Tensor, up_ratios: Sequence[int] = (2, 4, 5, 5),
                    fuse_blocks: bool = False,
                    prepared: Optional[List[List[Dict]]] = None) -> Tensor:
    """(B, T, 1) -> (B, T // hop, out_channels), in the type of the
    parameters.  ``fuse_blocks`` runs a block's three residual units as one
    K3 launch where ``ops.resunit.stack_tile`` admits it.  ``prepared``
    holds, per block, its units' kernel-layout weights
    (``ops.resunit.prepare_unit``) where the caller keeps them."""
    x = conv1d(wav, params["stem"]["w"], params["stem"]["b"], padding=3)
    for i, (block, stride) in enumerate(zip(params["blocks"], up_ratios)):
        x = encoder_block(x, block, stride, fuse_blocks, prepared[i] if prepared else None)
    x = snake_filtered(x, params["final_act"]["alpha"], params["final_act"]["beta"])
    return conv1d(x, params["out"]["w"], params["out"]["b"], padding=1)


# ----- random parameters (the converted checkpoints' structure) ----------


def init_conv(g: torch.Generator, c_out: int, c_in: int, k: int) -> Dict:
    """Fan-in-scaled normal weights (out, in, k), zero bias."""
    w = torch.randn((c_out, c_in, k), generator=g) / np.sqrt(c_in * k)
    return {"w": w, "b": torch.zeros(c_out)}


def init_act(c: int) -> Dict:
    return {"alpha": torch.zeros(c), "beta": torch.zeros(c)}


def init_unit(g: torch.Generator, c: int) -> Dict:
    return {"act1": init_act(c), "conv1": init_conv(g, c, c, 7), "act2": init_act(c),
            "conv2": init_conv(g, c, c, 1)}


def init_encoder_params(g: torch.Generator, ngf: int = 32, up_ratios: Sequence[int] = (2, 4, 5, 5),
                        out_channels: int = 256) -> Dict:
    """Random encoder parameters from ``g``: the JAX package's
    ``init_encoder_params`` tree, with normal (not truncated normal)
    fan-in-scaled convs."""
    d = ngf
    p: Dict = {"stem": init_conv(g, d, 1, 7), "blocks": []}
    for stride in up_ratios:
        d *= 2
        p["blocks"].append({"res": [init_unit(g, d // 2) for _ in range(3)], "act": init_act(d // 2),
                            "down": init_conv(g, d, d // 2, 2 * stride)})
    p["final_act"] = init_act(d)
    p["out"] = init_conv(g, out_channels, d, 3)
    return p
