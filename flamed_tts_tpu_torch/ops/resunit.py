"""K2 and K3: the FaCodec residual unit and a block's stack of three as CUDA
kernels (csrc/residual_unit.cu, csrc/residual_stack.cu):

    unit(x)  = x + conv1(snake2(conv7_d(snake1(x))))
    stack(x) = unit_9(unit_3(unit_1(x)))

``residual_unit_reference`` / ``residual_stack_reference`` are their plain
versions (the separate-op chain); ``residual_unit`` and ``residual_stack``
run the kernels for a CUDA tensor and the plain chain for a CPU tensor.

The kernels' convs are tensor-core products (``mma.sync``) in both io
types: bfloat16 operands in bfloat16, and in float32 three TF32 products of
operands split into two TF32 halves each, which keep float32's digits.  What
bounds a launch then is shared memory (at C = 512 a float32 block holds 96
rows: 20 output rows at d <= 3, 4 at d = 9), the weights every block streams
whole, and the two snakes (csrc/resunit.cuh says more).  The weights are
packed into the order of the mma B fragments (``pack_mma_weights``);
``prepare_unit`` packs both convs of a unit, so that a caller who keeps its
parameters (``FaCodec``) lays them out once and not on every launch.

Under grad the kernels run inside ``ResidualUnit`` / ``ResidualStack``,
whose backward is the plain chain's VJP (``kernels.plain_vjp``); they read
the live conv weights then (``prepared`` must be None), so the gradient
reaches the weights the forward used.

K2 takes every width that is a multiple of 16 up to 640 (``MMA_MAX_C``, the
FaCodec redecoder's first block at its reference width).  The kernel itself
takes multiples of 32; a width of 16 mod 32 (the redecoder's last block,
C = 80) is zero-padded here to the next multiple of 32: x, the snakes' log
alpha / beta and the conv weights and biases get zero channels, which the
snakes map to exact zeros and the convs multiply by zero weights, so the
real channels' sums are those of the unpadded conv and the pad is cut off
the output.  Past 512 channels in float32 the kernel splits the dilated
conv's reduction over input channels into passes (``unit_passes``; its
weights packed pass by pass, ``pack_mma_weights(w, passes)``).

The io type is that of ``x`` (float32 or bfloat16) and the conv weights and
biases must have it too.  Sums are float32; in bfloat16 a value is rounded
where the kernels round it: after each snake, each conv sum before its bias
is added, and the bias and residual adds are bfloat16 adds.

Unit params ``p``: act1/act2 {"alpha", "beta"} (C,) log-scale,
conv1 {"w": (C, C, 7), "b": (C,)}, conv2 {"w": (C, C, 1), "b": (C,)}.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.ops import costs
from flamed_tts_tpu_torch.ops.conv1d import conv1d
from flamed_tts_tpu_torch.ops.resample import snake_filtered_reference

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper (SMEM_LIMIT in resunit.cuh)
MMA_M = 16  # rows of one mma.sync tile: the convs compute rows in multiples of it
MMA_PAD_BYTES = 16  # added to a shared-memory row (MMA_PAD_BYTES in resunit.cuh)
MMA_STEP_BYTES = 32  # of an activation row that one K step multiplies: 16 bfloat16 or 8 float32 channels
MMA_STAGE_BYTES = 16384  # one weight stage (MMA_STAGE_BYTES in resunit.cuh)
MMA_STAGES = 2  # weight stages of the convs (MMA_STAGES in resunit.cuh)
MMA_MAX_C = 640  # widest conv the kernels take (MMA_MAX_C in resunit.cuh)
MMA_PASS_BYTES = 2048  # widest slice of h1 one pass of the dilated conv holds (resunit.cuh)
KERNEL_C_MULTIPLE = 32  # the kernels' widths; K2's wrapper zero-pads a width of 16 mod 32 to it
UNIT_C_MULTIPLE = 16  # the widths K2's wrapper takes
MMA_LONG_TILE = 100  # K2's tile for a long input: the fastest of the bfloat16 sweep at every long shape
MMA_SHORT_TILES = (20, 4)  # for an input too short to give the SMs a block each at a larger one: the first that fits
ONE_BLOCK_ROW_BYTES = 512  # from rows this long on the kernels run 512 threads a block, one block an SM
N_SMS = 132  # streaming multiprocessors of an H100
SM_SMEM_BYTES = 233472  # shared memory of one SM (228 KB); a resident block takes 1 KB more than it asks for
STACK_DILATIONS = (1, 3, 9)
STACK_MAX_TILE = 256  # more rows per block would leave the card's 132 SMs short of blocks
STACK_MIN_TILE = 64   # below this the halo rows (150 a block) cost more than they save
UNIT_LEAVES = (("act1", "alpha"), ("act1", "beta"), ("conv1", "w"), ("conv1", "b"),
               ("act2", "alpha"), ("act2", "beta"), ("conv2", "w"), ("conv2", "b"))


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


def pack_mma_weights(w: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """Conv weights (C_out, C_in, K) -> (K * C_in / S, C_out / 16, 32, V), the
    order in which the kernels read them.  S = 16 (bfloat16) or 8 (float32)
    input channels make one K step of the mma, and a lane's V = 8 or 4 values
    are 16 bytes, one shared-memory load: its B fragments of the S x 16 block
    (ci, co) of tap k, for the two n8 tiles h = 0, 1 of the block's output
    channels, co % 16 = 8 h + l // 4.  Each fragment is two 32-bit registers
    reg = 0, 1 of R = 2 bfloat16 values or 1 float32 value (which the kernel
    splits into TF32 halves): ci % S = S / 2 * reg + R * (l % 4) + {0 .. R - 1},
    that is 2 (l % 4) + {0, 1, 8, 9} for m16n8k16 and l % 4 + {0, 4} for
    m16n8k8.  A permutation of the values; ``unpack_mma_weights`` is its
    inverse.  With ``passes`` > 1 the input channels are cut into that many
    equal slices, each packed so, one after the other: the order in which
    the dilated conv reads them when it reduces in passes."""
    c_out, c_in, k = w.shape
    if w.dtype not in kernels.IO_DTYPES:
        raise ValueError(f"pack_mma_weights takes float32 or bfloat16, got {w.dtype}")
    if c_out % 16 or c_in % (16 * passes):
        raise ValueError(f"pack_mma_weights needs widths that are multiples of 16 "
                         f"(a slice's too), got {tuple(w.shape)} in {passes} passes")
    if passes > 1:
        return torch.cat([pack_mma_weights(part) for part in w.chunk(passes, dim=1)])
    r = 4 // w.element_size()
    # [k][ci][co] with ci = 8 r cib + 4 r reg + r q + half and co = 16 n16 + 8 h + g
    t = w.permute(2, 1, 0).reshape(k, c_in // (8 * r), 2, 4, r, c_out // 16, 2, 8)
    # -> [k][cib][n16][g][q][h][reg][half]: lane = 4 g + q, value = 2 r h + r reg + half
    return t.permute(0, 1, 5, 7, 3, 6, 2, 4).reshape(k * (c_in // (8 * r)), c_out // 16, 32, 4 * r).contiguous()


def unpack_mma_weights(packed: torch.Tensor, k: int, passes: int = 1) -> torch.Tensor:
    """The inverse of ``pack_mma_weights``: back to (C_out, C_in, K)."""
    if passes > 1:
        return torch.cat([unpack_mma_weights(part, k) for part in packed.chunk(passes)], dim=1)
    slabs, n16 = packed.shape[:2]
    cib, r = slabs // k, 4 // packed.element_size()
    t = packed.reshape(k, cib, n16, 8, 4, 2, 2, r).permute(0, 1, 6, 4, 7, 2, 5, 3)
    return t.reshape(k, cib * 8 * r, n16 * 16).permute(2, 1, 0).contiguous()


def packed_shape(c: int, k: int, dtype: torch.dtype) -> tuple:
    """Shape of ``pack_mma_weights`` of a (c, c, k) weight of ``dtype``."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    return (k * c * itemsize // MMA_STEP_BYTES, c // 16, 32, 16 // itemsize)


def unit_passes(c: int, itemsize: int) -> int:
    """Passes of K2's dilated-conv reduction over input channels at width
    ``c`` (unit_passes in resunit.cuh): 1 up to MMA_PASS_BYTES of values a
    row (float32 C <= 512, bfloat16 C <= 1024), else 2."""
    return -(-c * itemsize // MMA_PASS_BYTES)


def kernel_width(c: int) -> int:
    """The width K2 launches at for a unit of width ``c``: ``c`` rounded up
    to a multiple of 32.  Raises for a width K2 does not take."""
    if c <= 0 or c % UNIT_C_MULTIPLE or c > MMA_MAX_C:
        raise ValueError(f"residual_unit kernel takes C a multiple of {UNIT_C_MULTIPLE} "
                         f"up to {MMA_MAX_C}, got C={c}")
    return -(-c // KERNEL_C_MULTIPLE) * KERNEL_C_MULTIPLE


def pad_unit(p: Dict, c_pad: int) -> Dict:
    """A unit's parameters zero-padded from width C to ``c_pad`` channels:
    the snakes' log alpha / beta, both convs' weights (input and output
    channels) and biases."""
    c = p["conv1"]["w"].shape[0]
    if c_pad == c:
        return p
    n = c_pad - c
    out: Dict = {}
    for act in ("act1", "act2"):
        out[act] = {k: F.pad(p[act][k], (0, n)) for k in ("alpha", "beta")}
    for conv in ("conv1", "conv2"):
        out[conv] = {"w": F.pad(p[conv]["w"], (0, 0, 0, n, 0, n)), "b": F.pad(p[conv]["b"], (0, n))}
    return out


def prepare_unit(p: Dict) -> Optional[Dict]:
    """The kernel-layout weights of one unit, {"w1", "w2"}, to hand to
    ``residual_unit`` / ``residual_stack`` as ``prepared`` beside ``p``: at
    ``kernel_width``, zero-padded where that is wider, the dilated conv's
    packed pass by pass.  None for a width K2 does not take."""
    c = p["conv1"]["w"].shape[0]
    try:
        c_pad = kernel_width(c)
    except ValueError:
        return None
    q = pad_unit(p, c_pad)
    passes = unit_passes(c_pad, q["conv1"]["w"].element_size())
    return {"w1": pack_mma_weights(q["conv1"]["w"], passes), "w2": pack_mma_weights(q["conv2"]["w"])}


def _row_bytes(c: int, itemsize: int) -> int:
    """Bytes from one shared-memory row to the next (smem_ld in resunit.cuh)."""
    return c * itemsize + MMA_PAD_BYTES


def unit_smem_bytes(c: int, dilation: int, tile: int, itemsize: int) -> int:
    """Shared memory of one K2 block (residual_unit_smem_bytes in
    residual_unit.cu): h1 (tile + 6 d + 12 rows of one pass's channels, or
    the tile's rows of h3 at full width where that is more), h2 (tile + 12
    rows) and the weight stages."""
    h1 = max((tile + 6 * dilation + 12) * _row_bytes(c // unit_passes(c, itemsize), itemsize),
             tile * _row_bytes(c, itemsize))
    return h1 + (tile + 12) * _row_bytes(c, itemsize) + MMA_STAGES * MMA_STAGE_BYTES


@lru_cache(maxsize=None)
def pick_tile(t_len: int, c: int, dilation: int, itemsize: int = 4) -> int:
    """K2's output rows per block for an input of ``t_len`` rows of
    ``itemsize`` bytes a value.

    tile + 12, the dilated conv's rows, is a multiple of the mma's 16 rows.
    Every block streams all the weights whatever its tile, so the tile is
    the largest of 100, 84, ..., 36 that still gives three quarters of the
    card's SMs a block each and, where rows are under 512 bytes (256 threads
    a block), lets an SM hold two blocks; where none does (a short input, or
    C = 512, whose tiles stop at 52-68 in bfloat16 and 20 in float32), 20
    rows spread the input over the most blocks, and where 20 do not fit
    (float32, C = 512, d = 9) 4 rows.  tools/torch_sweep_unit_tile.py times
    every tile beside this choice.  Past C = 512 in float32 the dilated conv
    holds half the channels at a time (``unit_passes``), which gives 20
    rows at C = 640 at every d."""
    if c > MMA_MAX_C or c % KERNEL_C_MULTIPLE or unit_smem_bytes(c, dilation, MMA_SHORT_TILES[-1], itemsize) > SMEM_LIMIT:
        raise ValueError(f"residual_unit kernel: C={c}, d={dilation} does not fit in shared memory")
    room = SMEM_LIMIT if c * itemsize >= ONE_BLOCK_ROW_BYTES else SM_SMEM_BYTES // 2 - 1024
    for tile in range(MMA_LONG_TILE, MMA_SHORT_TILES[0], -MMA_M):
        if (unit_smem_bytes(c, dilation, tile, itemsize) <= room
                and -(-t_len // tile) >= 3 * N_SMS // 4):
            return tile
    return next(tile for tile in MMA_SHORT_TILES
                if unit_smem_bytes(c, dilation, tile, itemsize) <= SMEM_LIMIT)


def stack_smem_bytes(c: int, tile: int, itemsize: int, dilations: Sequence[int] = STACK_DILATIONS) -> int:
    """Shared memory of one K3 block (residual_stack_smem_bytes in
    residual_stack.cu): the buffers Y, H1 and H2 and the weight stages."""
    d1, d2, d3 = dilations
    n3 = tile
    n2 = n3 + 2 * (3 * d3 + 12)
    n1 = n2 + 2 * (3 * d2 + 12)
    h1 = max(n + 6 * d + 12 for n, d in ((n1, d1), (n2, d2), (n3, d3)))
    return (n1 + h1 + n1 + 12) * _row_bytes(c, itemsize) + MMA_STAGES * MMA_STAGE_BYTES


def stack_tile(c: int, dtype: torch.dtype) -> Optional[int]:
    """K3's output rows per block at width ``c`` and io type ``dtype``, or
    None where the block's three units go to K2 one by one.  A function of
    (c, dtype) alone: the largest multiple of 16 (the mma's rows) up to 256
    whose buffers fit in a block's shared memory, and None below 64 rows (or
    for a width or type the kernels do not take).  That is 256 rows at
    C = 32, 112 at C = 64 and None from C = 128 on in float32; 256, 256, 112
    at C = 32, 64, 128 and None from C = 256 on in bfloat16."""
    if dtype not in kernels.IO_DTYPES or c <= 0 or c % KERNEL_C_MULTIPLE or c > MMA_MAX_C:
        return None
    itemsize = 2 if dtype == torch.bfloat16 else 4
    tile = STACK_MAX_TILE
    while tile >= STACK_MIN_TILE and stack_smem_bytes(c, tile, itemsize) > SMEM_LIMIT:
        tile -= MMA_M
    return tile if tile >= STACK_MIN_TILE else None


def _unit_operands(x: torch.Tensor, p: Dict, c: int, prepared: Optional[Dict] = None,
                   prefix: str = "") -> list:
    """Checks one unit's parameters against ``x`` and returns the eight
    tensors the kernels take, in the order of UnitParams (resunit.cuh):
    the snakes' log alpha / beta as float32, and the conv weights in the
    kernels' layout, taken from ``prepared`` (``prepare_unit(p)``) or laid
    out here."""
    ops = []
    for act, conv, k, key in (("act1", "conv1", 7, "w1"), ("act2", "conv2", 1, "w2")):
        la, lb = p[act]["alpha"].float(), p[act]["beta"].float()
        kernels.require(la, f"{prefix}{act}.alpha", (c,))
        kernels.require(lb, f"{prefix}{act}.beta", (c,))
        kernels.require(p[conv]["b"], f"{prefix}{conv}.b", (c,), x.dtype, aligned=True)
        if prepared is None:
            kernels.require(p[conv]["w"], f"{prefix}{conv}.w", (c, c, k), x.dtype)
            w = pack_mma_weights(p[conv]["w"], unit_passes(c, x.element_size()) if k == 7 else 1)
        else:
            w = prepared[key]
            kernels.require(w, f"{prefix}prepared {key}", packed_shape(c, k, x.dtype), x.dtype, aligned=True)
        ops += [la, lb, w, p[conv]["b"]]
    return ops


def _check_x(x: torch.Tensor, what: str, multiple: int = KERNEL_C_MULTIPLE) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    if x.shape[2] % multiple or x.shape[2] > MMA_MAX_C:
        raise ValueError(f"{what} kernel needs C % {multiple} == 0 and C <= {MMA_MAX_C}, "
                         f"got C={x.shape[2]}")
    kernels.require(x, "x", aligned=True)


def _unit_launch(x: torch.Tensor, p: Dict, dilation: int, prepared: Optional[Dict] = None) -> torch.Tensor:
    """One K2 launch at ``pick_tile``'s rows per block (the result has the
    same bits at any tile that fits), at ``kernel_width``: a width of 16 mod
    32 is zero-padded for the launch and cut back after it."""
    _check_x(x, "residual_unit", UNIT_C_MULTIPLE)
    c_real = x.shape[2]
    c = kernel_width(c_real)
    if c != c_real:
        return _unit_launch(F.pad(x, (0, c - c_real)), pad_unit(p, c), dilation,
                            prepared)[..., :c_real].contiguous()
    b, t, _ = x.shape
    d = int(dilation)
    ops = _unit_operands(x, p, c, prepared)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tile = pick_tile(t, c, d, x.element_size())
    fn = kernels.library("residual_unit").residual_unit_launch
    err = fn(x.data_ptr(), kernels.pointers(ops), out.data_ptr(), b, t, c, d, tile,
             int(x.dtype == torch.bfloat16), kernels.stream_handle(x))
    kernels.check(err, "residual_unit")
    kernels.launches["residual_unit"] += 1
    return out


def _stack_launch(x: torch.Tensor, units, dilations: Sequence[int] = STACK_DILATIONS,
                  prepared: Optional[List[Dict]] = None) -> torch.Tensor:
    """One K3 launch; raises where ``stack_tile`` admits no tile."""
    _check_x(x, "residual_stack")
    b, t, c = x.shape
    dil = tuple(int(d) for d in dilations)
    if len(units) != 3 or dil != STACK_DILATIONS:
        raise ValueError(f"residual_stack kernel takes three units at dilations {STACK_DILATIONS}, got {dil}")
    tile = stack_tile(c, x.dtype)
    if tile is None:
        raise ValueError(f"residual_stack kernel: C={c}, {x.dtype} does not fit in shared memory")
    ops = [op for i, p in enumerate(units)
           for op in _unit_operands(x, p, c, prepared[i] if prepared else None, f"units[{i}].")]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = kernels.library("residual_stack").residual_stack_launch
    err = fn(x.data_ptr(), kernels.pointers(ops), out.data_ptr(), b, t, c, tile, *dil,
             int(x.dtype == torch.bfloat16), kernels.stream_handle(x))
    kernels.check(err, "residual_stack")
    kernels.launches["residual_stack"] += 1
    return out


def _leaves(p: Dict) -> List[torch.Tensor]:
    """A unit's eight parameters in the order of UNIT_LEAVES."""
    return [p[m][k] for m, k in UNIT_LEAVES]


def _units(leaves) -> List[Dict]:
    """The inverse of ``_leaves`` over one or more units."""
    units: List[Dict] = []
    for i in range(0, len(leaves), len(UNIT_LEAVES)):
        p: Dict = {}
        for (m, k), t in zip(UNIT_LEAVES, leaves[i:i + len(UNIT_LEAVES)]):
            p.setdefault(m, {})[k] = t
        units.append(p)
    return units


class ResidualUnit(torch.autograd.Function):
    """Forward: one K2 launch on the live weights.  Backward: the plain
    chain's VJP (``residual_unit_reference``) at the saved input, for x and
    each of the unit's eight parameters that requires grad."""

    @staticmethod
    def forward(ctx, x, dilation, *leaves):
        ctx.dilation = dilation
        ctx.save_for_backward(x, *leaves)
        return _unit_launch(x, _units(leaves)[0], dilation)

    @staticmethod
    def backward(ctx, grad_out):
        d = ctx.dilation
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[2:]
        grads = kernels.plain_vjp(lambda x, *leaves: residual_unit_reference(x, _units(leaves)[0], d),
                                  ctx.saved_tensors, grad_out, needs)
        return (grads[0], None) + grads[1:]


class ResidualStack(torch.autograd.Function):
    """Forward: one K3 launch on the live weights of three units at
    dilations 1, 3, 9.  Backward: the plain chain's VJP
    (``residual_stack_reference``) at the saved input."""

    @staticmethod
    def forward(ctx, x, *leaves):
        ctx.save_for_backward(x, *leaves)
        return _stack_launch(x, _units(leaves))

    @staticmethod
    def backward(ctx, grad_out):
        return kernels.plain_vjp(lambda x, *leaves: residual_stack_reference(x, _units(leaves)),
                                 ctx.saved_tensors, grad_out, ctx.needs_input_grad)


def _refuse_prepared(prepared) -> None:
    if prepared is not None and any(w is not None for w in
                                    (prepared if isinstance(prepared, list) else [prepared])):
        raise ValueError("prepared weights are a copy laid out once: under grad pass prepared=None, "
                         "so that the kernel reads the weights the gradient reaches")


def residual_unit_cuda(x: torch.Tensor, p: Dict, dilation: int, prepared: Optional[Dict] = None) -> torch.Tensor:
    """One K2 launch.  Under grad, with a float32 tensor that requires grad,
    the launch runs inside ``ResidualUnit`` on ``p``'s own weights, so the
    result carries the plain chain's gradient, and ``prepared`` must be
    None; a bfloat16 one is refused."""
    leaves = _leaves(p)
    if kernels.needs_grad(x, *leaves):
        _refuse_prepared(prepared)
        return ResidualUnit.apply(x, int(dilation), *leaves)
    return _unit_launch(x, p, dilation, prepared)


def residual_stack_cuda(x: torch.Tensor, units, dilations: Sequence[int] = STACK_DILATIONS,
                        prepared: Optional[List[Dict]] = None) -> torch.Tensor:
    """One K3 launch; raises where ``stack_tile`` admits no tile.  Under
    grad as ``residual_unit_cuda``, through ``ResidualStack``."""
    leaves = [t for p in units for t in _leaves(p)]
    if kernels.needs_grad(x, *leaves):
        _refuse_prepared(prepared)
        if len(units) != 3 or tuple(int(d) for d in dilations) != STACK_DILATIONS:
            raise ValueError(f"residual_stack kernel takes three units at dilations {STACK_DILATIONS}")
        return ResidualStack.apply(x, *leaves)
    return _stack_launch(x, units, dilations, prepared)


def residual_unit(x: torch.Tensor, p: Dict, dilation: int, prepared: Optional[Dict] = None) -> torch.Tensor:
    """K2 on a CUDA tensor, its plain version on a CPU one.  While a
    ``costs.CostCounter`` is active the call counts as one K2 launch."""
    if costs.counting():
        return costs.hand_kernels([("residual_unit", x.shape[0] * x.shape[1], x.shape[2])], x.dtype,
                                  lambda: residual_unit(x, p, dilation, prepared))
    if x.device.type == "cpu":
        return residual_unit_reference(x, p, dilation)
    return residual_unit_cuda(x, p, dilation, prepared)


def residual_stack(x: torch.Tensor, units, dilations: Sequence[int] = STACK_DILATIONS,
                   fuse: bool = False, prepared: Optional[List[Dict]] = None) -> torch.Tensor:
    """A block's three residual units.  With ``fuse`` and where
    ``stack_tile(C, dtype)`` admits a tile they are one K3 launch, else
    one K2 launch each; a CPU tensor takes the plain chain either way
    (both kernels compute exactly what it computes unit by unit).
    ``prepared`` is ``[prepare_unit(p) for p in units]`` where the caller
    keeps it; without it the weights are laid out on every launch.  While a
    ``costs.CostCounter`` is active the call counts as the launches the
    card makes for it, whichever device runs it."""
    stacked = (fuse and len(units) == 3 and tuple(int(d) for d in dilations) == STACK_DILATIONS
               and stack_tile(x.shape[2], x.dtype) is not None)
    if costs.counting():
        rows = x.shape[0] * x.shape[1]
        calls = ([("residual_stack", rows, x.shape[2])] if stacked
                 else [("residual_unit", rows, x.shape[2])] * len(units))
        return costs.hand_kernels(calls, x.dtype,
                                  lambda: residual_stack(x, units, dilations, fuse, prepared))
    if x.device.type == "cpu":
        return residual_stack_reference(x, units, dilations)
    if stacked:
        return residual_stack_cuda(x, units, dilations, prepared)
    for i, (p, d) in enumerate(zip(units, dilations)):
        x = residual_unit_cuda(x, p, int(d), prepared[i] if prepared else None)
    return x
