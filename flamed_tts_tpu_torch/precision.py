"""Matmul precision of the prior and the denoiser: the port's counterpart of
JAX's ``jax_default_matmul_precision``.

Two settings, named as JAX names them:

* ``"default"``, what a process starts with.  On a CUDA tensor a matmul or
  a convolution of the prior or the denoiser takes bfloat16 operands and
  accumulates in float32 on the tensor cores, as a dot at the TPU's default
  precision does, and its result is float32 (cuBLAS writes it so; a
  convolution runs as one product over the input's windows).  On a CPU
  tensor it is float32, JAX's CPU default.
* ``"highest"``: float32 on every device; on the card with TF32 off for
  matmuls and cuDNN.

LayerNorm, softmax, the residual adds, the adaLN modulation, the depthwise
convolution (a sum of shifted products in the JAX package, not a dot) and
the Euler updates are float32 under either.  A parameter stored in
bfloat16 (``Flamed.cast_inference_params``) is widened to float32 where the
arithmetic is float32, as flax promotes a bfloat16 kernel against a float32
input: on the CPU a bfloat16-stored model computes exactly what the same
values in float32 storage compute.

The setting belongs to the process, as JAX's config does: the entry points
set it where the JAX scripts set theirs (``set_matmul_precision``), and a
caller scopes it with ``matmul_precision``.  ``bf16_on_cpu`` runs the
``"default"`` arithmetic on CPU tensors as well, forward and backward, with
the card's code and the same roundings (operands rounded to bfloat16,
products and sums in float32): what the card computes, up to the order of
the sums, for a machine without one.

The layers (``Linear``, ``Conv1d``, ``LayerNorm``, ``Embedding``) are
``torch.nn``'s with these rules in their forward; their parameters and
state-dict names are ``torch.nn``'s.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

PRECISIONS = ("default", "highest")
BF16 = torch.bfloat16
F32 = torch.float32

_state = {"precision": "default", "cpu": False}
# the largest parameter ``widen`` keeps a widened copy of: the norms' and
# biases' vectors and a depthwise conv's 31 x 1024 taps fit, the denoiser's
# weight matrices do not
CACHE_MAX_NUMEL = 1 << 16


def get_matmul_precision() -> str:
    return _state["precision"]


def set_matmul_precision(name: str) -> None:
    """Set the process's precision; ``"highest"`` also turns TF32 off."""
    if name not in PRECISIONS:
        raise ValueError(f"matmul precision must be one of {PRECISIONS}, got {name!r}")
    _state["precision"] = name
    if name == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def matmul_precision(name: str) -> Iterator[None]:
    """``set_matmul_precision`` for a block; the precision and the TF32
    switches are restored after it."""
    saved = (_state["precision"], torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    set_matmul_precision(name)
    try:
        yield
    finally:
        (_state["precision"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def bf16_on_cpu() -> Iterator[None]:
    """The ``"default"`` arithmetic on CPU tensors too, for a block."""
    saved = _state["cpu"]
    _state["cpu"] = True
    try:
        yield
    finally:
        _state["cpu"] = saved


def bf16_operands(x: Tensor) -> bool:
    """Whether a matmul or conv on ``x`` takes bfloat16 operands."""
    return _state["precision"] == "default" and (x.is_cuda or _state["cpu"])


def widen(p: Optional[Tensor], x: Tensor) -> Optional[Tensor]:
    """A parameter in ``x``'s type (a no-op where it already is).

    A small one (a norm's or a bias's vector, a depthwise conv's taps) that
    takes no gradient here is cast once and the copy kept on it while its
    storage and version stand, so that a serving loop does not launch a
    cast for each of them at every step."""
    if p is None or p.dtype == x.dtype:
        return p
    if p.numel() > CACHE_MAX_NUMEL or (torch.is_grad_enabled() and p.requires_grad):
        return p.to(x.dtype)
    key = (p.data_ptr(), p._version, x.dtype)
    cached = getattr(p, "_widened", None)
    if cached is None or cached[0] != key:
        cached = (key, p.detach().to(x.dtype))
        p._widened = cached
    return cached[1]


def _grad_needed(*ts: Optional[Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def operand(x: Tensor) -> Tensor:
    """``x`` cast to bfloat16 where the products take bfloat16 operands and
    no gradient flows back through ``x``, else ``x``: a tensor that feeds
    several products is then cast once (the products take it as it is)."""
    return x.to(BF16) if bf16_operands(x) and not _grad_needed(x) else x


def _mm(a: Tensor, b: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """a (n, k) @ b (k, m) [+ bias] of bfloat16 operands, a float32 result:
    on the card cuBLAS accumulates in float32; on the CPU the same products
    (exact in float32) are summed in float32."""
    if a.is_cuda:
        return (torch.mm(a, b, out_dtype=F32) if bias is None
                else torch.addmm(bias, a, b, out_dtype=F32))
    a, b = a.float(), b.float()
    return torch.mm(a, b) if bias is None else torch.addmm(widen(bias, a), a, b)


def _bmm(a: Tensor, b: Tensor) -> Tensor:
    """``_mm`` of two (N, m, k) @ (N, k, n) bfloat16 batches."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=F32)
    return torch.bmm(a.float(), b.float())


class _Bf16Linear(torch.autograd.Function):
    """x (N, in) @ weight.T + bias with bfloat16 operands and float32
    results, forward and backward (the transposed products at the same
    precision, as XLA differentiates a dot: the incoming gradient is an
    operand and is rounded, no product's result is)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xb, wb = x.to(BF16), weight.to(BF16)
        ctx.save_for_backward(xb, wb)
        ctx.weight_dtype = weight.dtype
        return _mm(xb, wb.t(), bias)

    @staticmethod
    def backward(ctx, grad):
        xb, wb = ctx.saved_tensors
        gb = grad.to(BF16)
        gx = _mm(gb, wb) if ctx.needs_input_grad[0] else None
        gw = _mm(gb.t(), xb).to(ctx.weight_dtype) if ctx.needs_input_grad[1] else None
        gbias = grad.sum(0) if ctx.needs_input_grad[2] else None
        return gx, gw, gbias


class _Bf16Bmm(torch.autograd.Function):
    """a (N, m, k) @ b (N, k, n) with bfloat16 operands, float32 results.
    The operands are kept for the backward as given and cast again there:
    the attention's probabilities, a (N, L, L) float32 tensor, are kept by
    its softmax already, where a bfloat16 copy would be a second one."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm(a.to(BF16), b.to(BF16))

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        ab, bb, gb = a.to(BF16), b.to(BF16), grad.to(BF16)
        ga = _bmm(gb, bb.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        gbb = _bmm(ab.transpose(1, 2), gb) if ctx.needs_input_grad[1] else None
        return ga, gbb


def _bf16_batch(t: Tensor) -> Tensor:
    """(..., m, k) as a contiguous (N, m, k) bfloat16 batch: the cast and
    the gather of a transposed view are one copy."""
    return t.to(BF16, memory_format=torch.contiguous_format).view(-1, *t.shape[-2:])


def linear(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """``F.linear`` at the process's precision (x float32, or bfloat16 from
    ``operand``; any leading axes)."""
    if not bf16_operands(x):
        return F.linear(x, widen(weight, x), widen(bias, x))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _grad_needed(x, weight, bias):
        y = _Bf16Linear.apply(x2, weight, bias)
    else:
        y = _mm(x2.to(BF16), weight.to(BF16).t(), bias)
    return y.view(*lead, y.shape[-1])


def matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` of two activations (..., m, k) @ (..., k, n) at the
    process's precision."""
    if not bf16_operands(a):
        return a @ b
    lead = a.shape[:-2]
    if _grad_needed(a, b):
        y = _Bf16Bmm.apply(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]))
    else:
        y = _bmm(_bf16_batch(a), _bf16_batch(b))
    return y.view(*lead, *y.shape[-2:])


def conv1d(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None, padding: int = 0) -> Tensor:
    """``F.conv1d`` over (B, C, L), stride 1, at the process's precision.

    With bfloat16 operands the conv is one product: the (B * L, C * k)
    windows of the zero-padded input times the (O, C * k) weight, with the
    bias added in float32; the result (B, O, L) is float32 (a view of a
    channel-last tensor).  The copy that gathers the windows casts them to
    bfloat16 too, unless a gradient flows back to ``x``: it then stays
    float32, so that the gradient the windows return is not rounded."""
    if not bf16_operands(x):
        return F.conv1d(x, widen(weight, x), widen(bias, x), padding=padding)
    xl = x.transpose(1, 2)
    if padding:
        xl = F.pad(xl, (0, 0, padding, padding))
    out_ch, in_ch, k = weight.shape
    cols = xl.unfold(1, k, 1)  # (B, L, C, k)
    if not _grad_needed(x):
        cols = cols.to(BF16, memory_format=torch.contiguous_format)
    y = linear(cols.reshape(*cols.shape[:2], in_ch * k), weight.reshape(out_ch, in_ch * k), bias)
    return y.transpose(1, 2)


class Linear(nn.Linear):
    def forward(self, x: Tensor) -> Tensor:
        return linear(x, self.weight, self.bias)


class Conv1d(nn.Conv1d):
    """A stride-1, undilated, ungrouped Conv1d over (B, C, L)."""

    def forward(self, x: Tensor) -> Tensor:
        return conv1d(x, self.weight, self.bias, self.padding[0])


class LayerNorm(nn.LayerNorm):
    def forward(self, x: Tensor) -> Tensor:
        return F.layer_norm(x, self.normalized_shape, widen(self.weight, x), widen(self.bias, x),
                            self.eps)


class Embedding(nn.Embedding):
    """Rows as float32 whatever the table's storage."""

    def forward(self, ids: Tensor) -> Tensor:
        out = super().forward(ids)
        return out if out.dtype == F32 else out.to(F32)
