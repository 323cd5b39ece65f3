"""K2 and K3: the FaCodec residual unit and a block's stack of three as CUDA
kernels (csrc/residual_unit.cu, csrc/residual_stack.cu):

    unit(x)  = x + conv1(snake2(conv7_d(snake1(x))))
    stack(x) = unit_9(unit_3(unit_1(x)))

``residual_unit_reference`` / ``residual_stack_reference`` are their plain
versions (the separate-op chain); ``residual_unit`` and ``residual_stack``
run the kernels for a CUDA tensor and the plain chain for a CPU tensor.

The io type is that of ``x`` (float32 or bfloat16) and the conv weights and
biases must have it too.  Sums are float32; in bfloat16 a value is rounded
where the kernels round it: after each snake, each conv sum before its bias
is added, and the bias and residual adds are bfloat16 adds.

Unit params ``p``: act1/act2 {"alpha", "beta"} (C,) log-scale,
conv1 {"w": (C, C, 7), "b": (C,)}, conv2 {"w": (C, C, 1), "b": (C,)}.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence

import torch

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.ops.conv1d import conv1d
from flamed_tts_tpu_torch.ops.resample import snake_filtered_reference

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper (SMEM_LIMIT in resunit.cuh)
SNAKE_SCRATCH_BYTES = (2 * 32 + 10) * 32 * 4  # SNAKE_SCRATCH_FLOATS in snake.cuh
_RT = 8  # rows per conv work item in the kernels (RT in resunit.cuh)
STACK_DILATIONS = (1, 3, 9)
STACK_MAX_TILE = 256  # more rows per block would leave the card's 132 SMs short of blocks
STACK_MIN_TILE = 64   # below this the halo rows (150 a block) cost more than they save


def residual_unit_reference(x: torch.Tensor, p: Dict, dilation: int) -> torch.Tensor:
    io, work = x.dtype, torch.promote_types(x.dtype, torch.float32)
    h = snake_filtered_reference(x, p["act1"]["alpha"], p["act1"]["beta"])
    h = conv1d(h.to(work), p["conv1"]["w"].to(work), padding=3 * dilation, dilation=dilation)
    h = h.to(io) + p["conv1"]["b"].to(io)
    h = snake_filtered_reference(h, p["act2"]["alpha"], p["act2"]["beta"])
    h = conv1d(h.to(work), p["conv2"]["w"].to(work)).to(io) + p["conv2"]["b"].to(io)
    return x + h


def residual_stack_reference(x: torch.Tensor, units, dilations: Sequence[int] = STACK_DILATIONS) -> torch.Tensor:
    for p, d in zip(units, dilations):
        x = residual_unit_reference(x, p, int(d))
    return x


@lru_cache(maxsize=None)
def pick_tile(t_len: int, c: int, dilation: int, itemsize: int = 4) -> int:
    """K2's output rows per block: the most useful rows per conv row
    computed (tile / (RT * ceil((tile + 12) / RT))) that fit in shared
    memory."""
    smem = kernels.library("residual_unit").residual_unit_smem_bytes
    best, best_eff = 0, -1.0
    for tile in range(1, min(128, max(t_len, 1)) + 1):
        if smem(c, dilation, tile, itemsize) > SMEM_LIMIT:
            break
        eff = tile / (_RT * -(-(tile + 12) // _RT))
        if eff > best_eff + 1e-9:
            best, best_eff = tile, eff
    if best == 0:
        raise ValueError(f"residual_unit kernel: C={c}, d={dilation} does not fit in shared memory")
    return best


def stack_smem_bytes(c: int, tile: int, itemsize: int, dilations: Sequence[int] = STACK_DILATIONS) -> int:
    """Shared memory of one K3 block (residual_stack_smem_bytes in
    residual_stack.cu): the buffers Y, H1 and H2 and the snake scratch."""
    d1, d2, d3 = dilations
    n3 = tile
    n2 = n3 + 2 * (3 * d3 + 12)
    n1 = n2 + 2 * (3 * d2 + 12)
    h1 = max(n + 6 * d + 12 for n, d in ((n1, d1), (n2, d2), (n3, d3)))
    return (n1 + h1 + n1 + 12) * c * itemsize + SNAKE_SCRATCH_BYTES


def stack_tile(c: int, dtype: torch.dtype) -> Optional[int]:
    """K3's output rows per block at width ``c`` and io type ``dtype``, or
    None where the block's three units go to K2 one by one.  A function of
    (c, dtype) alone: the largest multiple of 8 up to 256 whose three
    buffers fit in a block's shared memory, and None below 64 rows (or for
    a width or type the kernels do not take)."""
    if dtype not in kernels.IO_DTYPES or c <= 0 or c % 32:
        return None
    itemsize = 2 if dtype == torch.bfloat16 else 4
    tile = STACK_MAX_TILE
    while tile >= STACK_MIN_TILE and stack_smem_bytes(c, tile, itemsize) > SMEM_LIMIT:
        tile -= _RT
    return tile if tile >= STACK_MIN_TILE else None


def _unit_operands(x: torch.Tensor, p: Dict, c: int, prefix: str = "") -> list:
    """Checks one unit's parameters against ``x`` and returns the eight
    tensors the kernels take, in the order of UnitParams (resunit.cuh):
    the snakes' log alpha / beta as float32, the conv weights laid out
    [k][ci][co] so that a warp's loads coalesce over output channels."""
    ops = []
    for act, conv, k in (("act1", "conv1", 7), ("act2", "conv2", 1)):
        la, lb = p[act]["alpha"].float(), p[act]["beta"].float()
        kernels.require(la, f"{prefix}{act}.alpha", (c,))
        kernels.require(lb, f"{prefix}{act}.beta", (c,))
        kernels.require(p[conv]["w"], f"{prefix}{conv}.w", (c, c, k), x.dtype)
        kernels.require(p[conv]["b"], f"{prefix}{conv}.b", (c,), x.dtype)
        ops += [la, lb, p[conv]["w"].permute(2, 1, 0).contiguous(), p[conv]["b"]]
    return ops


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    if x.shape[2] % 32:
        raise ValueError(f"{what} kernel needs C % 32 == 0, got C={x.shape[2]}")
    kernels.require(x, "x")


def residual_unit_cuda(x: torch.Tensor, p: Dict, dilation: int) -> torch.Tensor:
    _check_x(x, "residual_unit")
    b, t, c = x.shape
    d = int(dilation)
    ops = _unit_operands(x, p, c)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tile = pick_tile(min(t, 128), c, d, x.element_size())
    fn = kernels.library("residual_unit").residual_unit_launch
    err = fn(x.data_ptr(), kernels.pointers(ops), out.data_ptr(), b, t, c, d, tile,
             int(x.dtype == torch.bfloat16), kernels.stream_handle(x))
    kernels.check(err, "residual_unit")
    kernels.launches["residual_unit"] += 1
    return out


def residual_stack_cuda(x: torch.Tensor, units, dilations: Sequence[int] = STACK_DILATIONS) -> torch.Tensor:
    """One K3 launch; raises where ``stack_tile`` admits no tile."""
    _check_x(x, "residual_stack")
    b, t, c = x.shape
    dil = tuple(int(d) for d in dilations)
    if len(units) != 3 or dil != STACK_DILATIONS:
        raise ValueError(f"residual_stack kernel takes three units at dilations {STACK_DILATIONS}, got {dil}")
    tile = stack_tile(c, x.dtype)
    if tile is None:
        raise ValueError(f"residual_stack kernel: C={c}, {x.dtype} does not fit in shared memory")
    ops = [op for i, p in enumerate(units) for op in _unit_operands(x, p, c, f"units[{i}].")]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = kernels.library("residual_stack").residual_stack_launch
    err = fn(x.data_ptr(), kernels.pointers(ops), out.data_ptr(), b, t, c, tile, *dil,
             int(x.dtype == torch.bfloat16), kernels.stream_handle(x))
    kernels.check(err, "residual_stack")
    kernels.launches["residual_stack"] += 1
    return out


def residual_unit(x: torch.Tensor, p: Dict, dilation: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return residual_unit_reference(x, p, dilation)
    return residual_unit_cuda(x, p, dilation)


def residual_stack(x: torch.Tensor, units, dilations: Sequence[int] = STACK_DILATIONS,
                   fuse: bool = False) -> torch.Tensor:
    """A block's three residual units.  With ``fuse`` and where
    ``stack_tile(C, dtype)`` admits a tile they are one K3 launch, else
    one K2 launch each; a CPU tensor takes the plain chain either way
    (both kernels compute exactly what it computes unit by unit)."""
    if x.device.type == "cpu":
        return residual_stack_reference(x, units, dilations)
    if (fuse and len(units) == 3 and tuple(int(d) for d in dilations) == STACK_DILATIONS
            and stack_tile(x.shape[2], x.dtype) is not None):
        return residual_stack_cuda(x, units, dilations)
    for p, d in zip(units, dilations):
        x = residual_unit_cuda(x, p, int(d))
    return x
