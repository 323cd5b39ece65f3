"""The denoiser step's chains between its GEMMs as CUDA kernels
(csrc/denoiser.cu), with their plain versions.

Each piece is the run of ops that one of ``ops/convnext.py``'s blocks
computes between two of its products:

* ``norm_modulate``: ``s = x + gate * (r1 + rb)`` or
  ``x + gate * (r1 + (r2 + rb))`` (``x + rb`` without ``r1``), then
  LayerNorm of ``s`` (affine or not) modulated by ``* (1 + scale) + shift``,
  zero on padded frames where a mask is given; for the final layer, its k3
  windows (``k3_windows``), the operand of the conv after it;
* ``conv_norm``: ConvNeXtBlock's depthwise k31 conv of its masked input and
  the masked per-channel norm after it (``masked_group_norm`` with a group a
  channel), affine, masked;
* ``activation``: GELU (erf) or SiLU of ``y + bias``.

The products between them run without their bias (``rb``, ``bias``): the
piece that reads a product adds it, as the JAX package's Dense adds its
bias to the dot (on the card it saves the copy of the bias into the
product's output that cuBLAS would launch first).

Each runs its kernel for a CUDA tensor and its plain version (``*_reference``,
the ops as the blocks ran them one by one) for a CPU tensor; there is no
other switch.  An output that feeds a product (``operand``) is that
product's operand: bfloat16 where ``precision`` takes bfloat16 operands, as
``precision.operand`` casts it.  Activations are float32 and stay so.

Under grad (a float32 input or parameter that requires grad) a kernel runs
inside a ``torch.autograd.Function`` whose backward is the plain version's
VJP (``kernels.plain_vjp``); its operand output is then float32, as
``precision.operand`` leaves a tensor that carries a gradient.  While a
``costs.CostCounter`` is active a call counts as one launch: the depthwise
conv's operations (2 K a value, as the counter counts the plain conv) and
the bytes the piece reads and writes once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from flamed_tts_tpu_torch import kernels, precision
from flamed_tts_tpu_torch.ops import costs
from flamed_tts_tpu_torch.ops.norms import layer_norm_noaffine, masked_group_norm

CONV_K = 31  # the depthwise conv's taps (CONV_K in denoiser.cu)
CONV_RUN = 7  # outputs a lane of conv_norm computes from one window (CONV_RUN in denoiser.cu)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper (SMEM_LIMIT in denoiser.cu)
ACTIVATIONS = {"gelu": (0, F.gelu), "silu": (1, F.silu)}  # denoiser.cu's ACT_GELU, ACT_SILU


def modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    return x * (1.0 + scale) + shift


def depthwise_conv1d(x: Tensor, weight: Tensor, bias: Tensor) -> Tensor:
    """Per-channel conv along time of channel-last x (B, T, C), weight
    (C, 1, K), zero padding that keeps the length; float32 under either
    precision (the JAX package's depthwise conv is a sum of shifted
    products, not a dot)."""
    return F.conv1d(x.transpose(1, 2), precision.widen(weight, x), precision.widen(bias, x),
                    padding=weight.shape[-1] // 2, groups=weight.shape[0]).transpose(1, 2)


def _operand(out: Tensor, operand: bool) -> Tensor:
    return precision.operand(out) if operand else out


# ----------------------------------------------------------------- plain versions


def add_bias(y: Tensor, bias: Optional[Tensor]) -> Tensor:
    """y + bias (a product's output and its bias, float32), y where None."""
    return y if bias is None else y + precision.widen(bias, y)


def k3_windows(z: Tensor) -> Tensor:
    """(B, T, C) -> (B, T, 3 C), tap-major: row t holds frame t + j - 1 at
    j C .. (j + 1) C (zero beyond the ends), the operand of a k3 conv as one
    product with its weight in the same order (``k3_weight``)."""
    t = z.shape[1]
    zp = F.pad(z, (0, 0, 1, 1))
    return torch.cat([zp[:, j:j + t] for j in range(3)], dim=-1)


def k3_weight(w: Tensor) -> Tensor:
    """A k3 conv's weight (out, C, 3) in ``k3_windows``' order: (out, 3 C)."""
    return w.transpose(1, 2).reshape(w.shape[0], -1)


def norm_modulate_reference(x: Tensor, gate: Optional[Tensor], r1: Optional[Tensor],
                            r2: Optional[Tensor], rb: Optional[Tensor], shift: Tensor,
                            scale: Tensor, weight: Optional[Tensor], bias: Optional[Tensor],
                            pad_mask: Optional[Tensor], eps: float, operand: bool,
                            windows: bool = False) -> Tuple[Tensor, Tensor]:
    """(s, out): s = x + gate * (r1 + rb), or x + gate * (r1 + (r2 + rb))
    where r2 is given, or x + rb where r1 is None (rb: a product's bias,
    none where None); out = LN(s) (with weight and bias where given) *
    (1 + scale) + shift, zero where pad_mask is True; its ``k3_windows``
    where ``windows``."""
    if r1 is None:
        x = add_bias(x, rb)
    else:
        x = x + gate * (add_bias(r1, rb) if r2 is None else r1 + add_bias(r2, rb))
    if weight is None:
        n = layer_norm_noaffine(x, eps)
    else:
        n = F.layer_norm(x, x.shape[-1:], precision.widen(weight, x), precision.widen(bias, x), eps)
    out = modulate(n, shift, scale)
    if pad_mask is not None:
        out = out.masked_fill(pad_mask[:, :, None], 0.0)
    if windows:
        out = k3_windows(out)
    return x, _operand(out, operand)


def conv_norm_reference(x: Tensor, conv_w: Tensor, conv_b: Tensor, norm_w: Tensor,
                        norm_b: Tensor, pad_mask: Optional[Tensor], eps: float,
                        operand: bool) -> Tensor:
    """The masked norm, a group a channel, of the depthwise conv of x with
    its padded frames zeroed."""
    h = x if pad_mask is None else x.masked_fill(pad_mask[:, :, None], 0.0)
    h = masked_group_norm(depthwise_conv1d(h, conv_w, conv_b), x.shape[-1], norm_w, norm_b,
                          pad_mask, eps)
    return _operand(h, operand)


def activation_reference(y: Tensor, bias: Optional[Tensor], kind: str, operand: bool) -> Tensor:
    return _operand(ACTIVATIONS[kind][1](add_bias(y, bias)), operand)


# ----------------------------------------------------------------- launches


def _out_dtype(x: Tensor, operand: bool) -> torch.dtype:
    """The type of an output: a bfloat16 operand where the products take
    one (``precision.bf16_operands``), else float32."""
    return torch.bfloat16 if operand and precision.bf16_operands(x) else torch.float32


def _require_f32(x: Tensor, what: str, shape) -> None:
    kernels.require(x, what, shape, dtype=torch.float32, aligned=True)


def _param(p: Tensor, x: Tensor, what: str, shape) -> Tensor:
    """A parameter as the kernels read it: float32 (``precision.widen``'s
    copy of a bfloat16 one), contiguous, of ``shape``."""
    p = precision.widen(p, x).reshape(shape)
    kernels.require(p, what, shape, dtype=torch.float32, aligned=True)
    return p


def _mask(pad_mask: Optional[Tensor], b: int, t: int) -> Optional[Tensor]:
    if pad_mask is None:
        return None
    if not pad_mask.is_cuda or pad_mask.dtype != torch.bool or tuple(pad_mask.shape) != (b, t) \
            or not pad_mask.is_contiguous():
        raise ValueError(f"pad_mask must be a contiguous CUDA bool tensor of shape {(b, t)}")
    return pad_mask


def _mod(m: Tensor, what: str, b: int, t: int, c: int) -> Tuple[Tensor, int, int]:
    """A modulation (a chunk of ``mods``: (B or 1, 1 or T, C), the channels
    contiguous) and its strides over batch rows and frames, 0 where one row
    serves all."""
    if m.dim() != 3 or not m.is_cuda or m.dtype != torch.float32:
        raise ValueError(f"{what} must be a float32 CUDA tensor (B, 1 or T, C)")
    e = m.expand(b, t, c)
    if e.stride(2) != 1 or m.data_ptr() % 16:
        raise ValueError(f"{what} must have contiguous channels aligned to 16 bytes")
    return m, e.stride(0), e.stride(1)


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _norm_modulate_launch(x, gate, r1, r2, rb, shift, scale, weight, bias, pad_mask, eps,
                          out_dtype, keep, windows) -> Tuple[Optional[Tensor], Tensor]:
    """One norm_modulate launch: (s, out), s None where the launch writes
    none (no residual nor bias, or not ``keep``)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    b, t, c = x.shape
    _require_f32(x, "x", None)
    if c % 4 or c > 1024:
        raise ValueError(f"norm_modulate kernel needs C % 4 == 0 and C <= 1024, got C={c}")
    shift, mod_sb, mod_st = _mod(shift, "shift", b, t, c)
    scale, sc_sb, sc_st = _mod(scale, "scale", b, t, c)
    if (sc_sb, sc_st) != (mod_sb, mod_st):
        raise ValueError("shift and scale must have the same strides (chunks of one mods tensor)")
    gate_sb = gate_st = 0
    if r1 is not None:
        _require_f32(r1, "r1", x.shape)
        if r2 is not None:
            _require_f32(r2, "r2", x.shape)
        gate, gate_sb, gate_st = _mod(gate, "gate", b, t, c)
    if rb is not None:
        rb = _param(rb, x, "rb", (c,))
    elif r1 is not None:  # the kernel adds a bias to a residual: here none
        rb = torch.zeros(c, device=x.device)
    if weight is not None:
        weight, bias = _param(weight, x, "weight", (c,)), _param(bias, x, "bias", (c,))
    pad_mask = _mask(pad_mask, b, t)
    s = torch.empty_like(x) if (r1 is not None or rb is not None) and keep else None
    out = torch.empty((b, t, 3 * c if windows else c), dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return s, out
    fn = kernels.library("denoiser").norm_modulate_launch
    err = fn(x.data_ptr(), _ptr(r1), _ptr(r2), _ptr(rb), _ptr(gate), gate_sb, gate_st, shift.data_ptr(),
             scale.data_ptr(), mod_sb, mod_st, _ptr(weight), _ptr(bias), _ptr(pad_mask), _ptr(s),
             out.data_ptr(), b, t, c, float(eps), int(windows), int(out_dtype == torch.bfloat16),
             kernels.stream_handle(x))
    kernels.check(err, "norm_modulate")
    kernels.launches["norm_modulate"] += 1
    return s, out


def conv_smem_bytes(t: int, ch: int) -> int:
    """Shared memory of a conv_norm block of ``ch`` channels over ``t``
    frames (conv_norm_smem_bytes in denoiser.cu)."""
    return 4 * (ch * (t + CONV_K - 1 + CONV_RUN) + 2 * ch) + t


def _conv_norm_launch(x, conv_w, conv_b, norm_w, norm_b, pad_mask, eps, out_dtype) -> Tensor:
    """One conv_norm launch."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    b, t, c = x.shape
    _require_f32(x, "x", None)
    if c % 8 or conv_w.shape != (c, 1, CONV_K):
        raise ValueError(f"conv_norm kernel needs C % 8 == 0 and a depthwise conv of {CONV_K} taps, "
                         f"got C={c}, weight {tuple(conv_w.shape)}")
    if conv_smem_bytes(t, 4) > SMEM_LIMIT:
        raise ValueError(f"conv_norm kernel: T={t} frames do not fit in shared memory")
    conv_w = _param(conv_w, x, "conv weight", (c, CONV_K))
    conv_b, norm_w, norm_b = (_param(p, x, what, (c,)) for p, what in
                              ((conv_b, "conv bias"), (norm_w, "norm weight"), (norm_b, "norm bias")))
    pad_mask = _mask(pad_mask, b, t)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    fn = kernels.library("denoiser").conv_norm_launch
    err = fn(x.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), norm_w.data_ptr(), norm_b.data_ptr(),
             _ptr(pad_mask), out.data_ptr(), b, t, c, float(eps),
             int(out_dtype == torch.bfloat16), kernels.stream_handle(x))
    kernels.check(err, "conv_norm")
    kernels.launches["conv_norm"] += 1
    return out


def _activation_launch(y: Tensor, bias: Optional[Tensor], kind: str, out_dtype) -> Tensor:
    """One act launch."""
    _require_f32(y, "y", None)
    n = y.shape[-1]
    if n % 4:
        raise ValueError(f"act kernel needs rows of a multiple of 4 values, got {n}")
    if bias is not None:
        bias = _param(bias, y, "bias", (n,))
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    if y.numel() == 0:
        return out
    fn = kernels.library("denoiser").act_launch
    err = fn(y.data_ptr(), _ptr(bias), out.data_ptr(), y.numel(), n, ACTIVATIONS[kind][0],
             int(out_dtype == torch.bfloat16), kernels.stream_handle(y))
    kernels.check(err, "act")
    kernels.launches["act"] += 1
    return out


# ----------------------------------------------------------------- under grad


class NormModulate(torch.autograd.Function):
    """Forward: one norm_modulate launch, float32 out.  Backward: the plain
    version's VJP at the saved inputs."""

    @staticmethod
    def forward(ctx, x, gate, r1, r2, rb, shift, scale, weight, bias, pad_mask, eps, windows):
        ctx.eps, ctx.windows = eps, windows
        ctx.save_for_backward(x, gate, r1, r2, rb, shift, scale, weight, bias, pad_mask)
        s, out = _norm_modulate_launch(x, gate, r1, r2, rb, shift, scale, weight, bias, pad_mask,
                                       eps, torch.float32, True, windows)
        return out if s is None else (s, out)

    @staticmethod
    def backward(ctx, *grads):
        eps, windows, has_s = ctx.eps, ctx.windows, len(grads) == 2

        def plain(*inputs):
            s, out = norm_modulate_reference(*inputs, eps, False, windows)
            return (s, out) if has_s else out

        return kernels.plain_vjp(plain, ctx.saved_tensors, grads if has_s else grads[0],
                                 ctx.needs_input_grad[:10]) + (None, None)


class ConvNorm(torch.autograd.Function):
    """Forward: one conv_norm launch, float32 out.  Backward: the plain
    version's VJP at the saved inputs."""

    @staticmethod
    def forward(ctx, x, conv_w, conv_b, norm_w, norm_b, pad_mask, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, conv_w, conv_b, norm_w, norm_b, pad_mask)
        return _conv_norm_launch(x, conv_w, conv_b, norm_w, norm_b, pad_mask, eps, torch.float32)

    @staticmethod
    def backward(ctx, grad_out):
        eps = ctx.eps
        return kernels.plain_vjp(lambda *inputs: conv_norm_reference(*inputs, eps, False),
                                 ctx.saved_tensors, grad_out, ctx.needs_input_grad[:6]) + (None,)


class Activation(torch.autograd.Function):
    """Forward: one act launch, float32 out.  Backward: the plain
    version's VJP at the saved input."""

    @staticmethod
    def forward(ctx, y, bias, kind):
        ctx.kind = kind
        ctx.save_for_backward(y, bias)
        return _activation_launch(y, bias, kind, torch.float32)

    @staticmethod
    def backward(ctx, grad_out):
        kind = ctx.kind
        return kernels.plain_vjp(lambda y, bias: activation_reference(y, bias, kind, False),
                                 ctx.saved_tensors, grad_out, ctx.needs_input_grad[:2]) + (None,)


# ----------------------------------------------------------------- wrappers


def norm_modulate_cuda(x, gate, r1, r2, rb, shift, scale, weight, bias, pad_mask, eps: float,
                       operand: bool = False, windows: bool = False,
                       keep: bool = True) -> Tuple[Optional[Tensor], Tensor]:
    """One norm_modulate launch: (s, out) as ``norm_modulate_reference``; s
    is None where ``keep`` is false (not written).  Under grad through
    ``NormModulate``; a bfloat16 tensor that requires grad is refused."""
    same = r1 is None and rb is None  # s is x
    if kernels.needs_grad(x, gate, r1, r2, rb, shift, scale, weight, bias):
        res = NormModulate.apply(x, gate, r1, r2, rb, shift, scale, weight, bias, pad_mask, eps,
                                 windows)
        return (x, res) if same else res
    s, out = _norm_modulate_launch(x, gate, r1, r2, rb, shift, scale, weight, bias, pad_mask, eps,
                                   _out_dtype(x, operand), keep, windows)
    return (x if same else s), out


def conv_norm_cuda(x, conv_w, conv_b, norm_w, norm_b, pad_mask, eps: float,
                   operand: bool = False) -> Tensor:
    """One conv_norm launch; under grad through ``ConvNorm``."""
    if kernels.needs_grad(x, conv_w, conv_b, norm_w, norm_b):
        return ConvNorm.apply(x, conv_w, conv_b, norm_w, norm_b, pad_mask, eps)
    return _conv_norm_launch(x, conv_w, conv_b, norm_w, norm_b, pad_mask, eps, _out_dtype(x, operand))


def activation_cuda(y: Tensor, bias: Optional[Tensor], kind: str, operand: bool = False) -> Tensor:
    """One act launch; under grad through ``Activation``."""
    if kernels.needs_grad(y, bias):
        return Activation.apply(y, bias, kind)
    return _activation_launch(y, bias, kind, _out_dtype(y, operand))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def norm_modulate(x: Tensor, shift: Tensor, scale: Tensor, weight: Optional[Tensor] = None,
                  bias: Optional[Tensor] = None, eps: float = 1e-6, gate: Optional[Tensor] = None,
                  r1: Optional[Tensor] = None, r2: Optional[Tensor] = None,
                  rb: Optional[Tensor] = None, pad_mask: Optional[Tensor] = None,
                  operand: bool = False, windows: bool = False,
                  keep: bool = True) -> Tuple[Optional[Tensor], Tensor]:
    """(s, out) of ``norm_modulate_reference``: the kernel on a CUDA tensor,
    the plain version on a CPU one.  ``operand``: out feeds a product;
    ``windows``: as its k3 windows.  ``keep`` false: the caller does not
    read s (the kernel does not write it)."""
    if costs.counting():
        c, item = x.shape[-1], _out_dtype(x, operand).itemsize
        writes_s = (r1 is not None or rb is not None) and keep
        nbytes = (_nbytes(x, r1, r2, gate, shift, scale, pad_mask)
                  + 4 * c * (2 * (weight is not None) + (rb is not None))
                  + x.numel() * (item * (3 if windows else 1) + 4 * writes_s))
        return costs.counted([("norm_modulate", 0, nbytes)], lambda: norm_modulate(
            x, shift, scale, weight, bias, eps, gate, r1, r2, rb, pad_mask, operand, windows, keep))
    if x.device.type == "cpu":
        return norm_modulate_reference(x, gate, r1, r2, rb, shift, scale, weight, bias, pad_mask,
                                       eps, operand, windows)
    return norm_modulate_cuda(x, gate, r1, r2, rb, shift, scale, weight, bias, pad_mask, eps,
                              operand, windows, keep)


def conv_norm(x: Tensor, conv_w: Tensor, conv_b: Tensor, norm_w: Tensor, norm_b: Tensor,
              pad_mask: Optional[Tensor] = None, eps: float = 1e-5, operand: bool = False) -> Tensor:
    """``conv_norm_reference``: the kernel on a CUDA tensor, the plain
    version on a CPU one."""
    if costs.counting():
        k = conv_w.shape[-1]
        nbytes = (_nbytes(x, pad_mask) + 4 * x.shape[-1] * (k + 3)
                  + x.numel() * _out_dtype(x, operand).itemsize)
        return costs.counted([("conv_norm", 2 * k * x.numel(), nbytes)], lambda: conv_norm(
            x, conv_w, conv_b, norm_w, norm_b, pad_mask, eps, operand))
    if x.device.type == "cpu":
        return conv_norm_reference(x, conv_w, conv_b, norm_w, norm_b, pad_mask, eps, operand)
    return conv_norm_cuda(x, conv_w, conv_b, norm_w, norm_b, pad_mask, eps, operand)


def activation(y: Tensor, kind: str, bias: Optional[Tensor] = None, operand: bool = False) -> Tensor:
    """GELU (``"gelu"``, erf) or SiLU (``"silu"``) of y + bias: the kernel
    on a CUDA tensor, the plain version on a CPU one."""
    if costs.counting():
        nbytes = y.numel() * (4 + _out_dtype(y, operand).itemsize) + 4 * y.shape[-1] * (bias is not None)
        return costs.counted([("act", 0, nbytes)], lambda: activation(y, kind, bias, operand))
    if y.device.type == "cpu":
        return activation_reference(y, bias, kind, operand)
    return activation_cuda(y, bias, kind, operand)
