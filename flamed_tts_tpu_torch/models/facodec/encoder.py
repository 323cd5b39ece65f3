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
