"""K2: one FaCodec residual unit as one CUDA kernel
(csrc/residual_unit.cu):

    out = x + conv1(snake2(conv7_d(snake1(x))))

``residual_unit_reference`` is its plain version (the separate-op chain);
``residual_unit`` runs the kernel for a CUDA tensor and the plain chain
for a CPU tensor.

Unit params ``p``: act1/act2 {"alpha", "beta"} (C,) log-scale,
conv1 {"w": (C, C, 7), "b": (C,)}, conv2 {"w": (C, C, 1), "b": (C,)}.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import torch

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.ops.conv1d import conv1d
from flamed_tts_tpu_torch.ops.resample import snake_filtered_reference

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper (SMEM_LIMIT in residual_unit.cu)
_RT = 8  # rows per conv work item in the kernel (RT in residual_unit.cu)


def residual_unit_reference(x: torch.Tensor, p: Dict, dilation: int) -> torch.Tensor:
    pad = 3 * dilation
    h = snake_filtered_reference(x, p["act1"]["alpha"], p["act1"]["beta"])
    h = conv1d(h, p["conv1"]["w"], p["conv1"]["b"], padding=pad, dilation=dilation)
    h = snake_filtered_reference(h, p["act2"]["alpha"], p["act2"]["beta"])
    h = conv1d(h, p["conv2"]["w"], p["conv2"]["b"])
    return x + h


@lru_cache(maxsize=None)
def pick_tile(t_len: int, c: int, dilation: int) -> int:
    """Output rows per block: the most useful rows per conv row computed
    (tile / (RT * ceil((tile + 12) / RT))) that fit in shared memory."""
    smem = kernels.library("residual_unit").residual_unit_smem_bytes
    best, best_eff = 0, -1.0
    for tile in range(1, min(128, max(t_len, 1)) + 1):
        if smem(c, dilation, tile) > SMEM_LIMIT:
            break
        eff = tile / (_RT * -(-(tile + 12) // _RT))
        if eff > best_eff + 1e-9:
            best, best_eff = tile, eff
    if best == 0:
        raise ValueError(f"residual_unit kernel: C={c}, d={dilation} does not fit in shared memory")
    return best


def residual_unit_cuda(x: torch.Tensor, p: Dict, dilation: int) -> torch.Tensor:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    b, t, c = x.shape
    d = int(dilation)
    if c % 32:
        raise ValueError(f"residual_unit kernel needs C % 32 == 0, got C={c}")
    kernels.require(x, "x")
    for name in ("act1", "act2"):
        kernels.require(p[name]["alpha"], f"{name}.alpha", (c,))
        kernels.require(p[name]["beta"], f"{name}.beta", (c,))
    kernels.require(p["conv1"]["w"], "conv1.w", (c, c, 7))
    kernels.require(p["conv1"]["b"], "conv1.b", (c,))
    kernels.require(p["conv2"]["w"], "conv2.w", (c, c, 1))
    kernels.require(p["conv2"]["b"], "conv2.b", (c,))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # the kernel reads weights as [k][ci][co] so a warp's loads coalesce
    # over output channels
    w1t = p["conv1"]["w"].permute(2, 1, 0).contiguous()
    w2t = p["conv2"]["w"][:, :, 0].t().contiguous()
    tile = pick_tile(min(t, 128), c, d)
    fn = kernels.library("residual_unit").residual_unit_launch
    err = fn(
        x.data_ptr(),
        p["act1"]["alpha"].data_ptr(), p["act1"]["beta"].data_ptr(),
        w1t.data_ptr(), p["conv1"]["b"].data_ptr(),
        p["act2"]["alpha"].data_ptr(), p["act2"]["beta"].data_ptr(),
        w2t.data_ptr(), p["conv2"]["b"].data_ptr(),
        out.data_ptr(), b, t, c, d, tile, kernels.stream_handle(x),
    )
    kernels.check(err, "residual_unit")
    kernels.launches["residual_unit"] += 1
    return out


def residual_unit(x: torch.Tensor, p: Dict, dilation: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return residual_unit_reference(x, p, dilation)
    return residual_unit_cuda(x, p, dilation)


def residual_stack(x: torch.Tensor, units, dilations=(1, 3, 9)) -> torch.Tensor:
    """A block's three residual units, one K2 launch each."""
    for p, d in zip(units, dilations):
        x = residual_unit(x, p, int(d))
    return x
