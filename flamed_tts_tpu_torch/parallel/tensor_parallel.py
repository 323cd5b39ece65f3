"""The denoiser's forward with its parameters split over the model axis
(``sharding.py``), and the collectives it takes.

The residual stream x of ``SimpleMLPAdaLN`` is split on channels: rank r of
n holds channels [r C / n, (r + 1) C / n) (C_r of them).  Per block:

* LayerNorm (``ln_conv``, ``ln_mlp``, the final layer's plain norms) over
  split channels: the mean and the variance are sums over the model group
  (two all-reduces), then each rank normalizes its channels.
* the ConvNeXt conv: the depthwise conv and its per-channel norm are local;
  ``conv_2`` is row-parallel (its partial products summed over the group,
  the bias added once after the sum), ``conv_3`` column-parallel (this
  rank's output channels; its replicated bias sliced).
* the gated MLP: ``mlp_0`` column-parallel on the gathered input, ``mlp_2``
  row-parallel (summed, bias once), sliced back to this rank's channels.
* the modulations: ``time_embed`` (``mlp_0``, then ``mlp_2`` on the
  gathered hidden) and ``cond_embed`` are column-parallel, and ``y`` is
  gathered for the adaLN Linear, whose rows a rank holds are its channels
  of each modulation.
* the final layer's ``conv_out`` (replicated) runs on the gathered stream.

Gradients: every collective's backward is its adjoint (an all-reduce's an
all-reduce, an all-gather's a sum over the group of each rank's slice),
which is the gradient of the sum over the model ranks of each rank's copy
of the loss.  So a trainer divides the loss by n before its backward and
sums the replicated parameters' gradients over the model group (each rank
then holds the whole batch's gradient of them), and a split parameter's
gradient is this rank's part as it stands (``train/step.py``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor

from flamed_tts_tpu_torch.ops.convnext import modulate
from flamed_tts_tpu_torch.ops.embeddings import dit_timestep_embedding
from flamed_tts_tpu_torch.ops.norms import masked_group_norm


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    """Concatenates every rank's x on the last axis, in rank order."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.group, ctx.size, ctx.rank = group, size, rank
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        total = grad.contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        return total.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), None, None, None


def all_reduce(x: Tensor, tp) -> Tensor:
    return x if tp.size == 1 else _AllReduce.apply(x, tp.group)


def all_gather(x: Tensor, tp) -> Tensor:
    return x if tp.size == 1 else _AllGather.apply(x, tp.group, tp.size, tp.rank)


def own_channels(x: Tensor, tp) -> Tensor:
    """This rank's channels of a whole (replicated) last axis."""
    return x if tp.size == 1 else x.chunk(tp.size, dim=-1)[tp.rank]


def layer_norm(x: Tensor, tp, channels: int, weight: Optional[Tensor] = None,
               bias: Optional[Tensor] = None, eps: float = 1e-6) -> Tensor:
    """LayerNorm over the last axis split across the model group (``channels``
    in all): the mean, then the variance about it, summed over the group."""
    mean = all_reduce(x.sum(dim=-1, keepdim=True), tp) / channels
    xc = x - mean
    var = all_reduce((xc * xc).sum(dim=-1, keepdim=True), tp) / channels
    out = xc / torch.sqrt(var + eps)
    if weight is not None:
        out = out * weight + bias
    return out


def _linear_row(x: Tensor, layer, tp) -> Tensor:
    """A row-parallel Linear: this rank's input channels times its columns
    of the weight, summed over the group, then the (replicated) bias."""
    return all_reduce(F.linear(x, layer.weight), tp) + layer.bias


def _convnext(cb, x: Tensor, pad_mask: Optional[Tensor], tp) -> Tensor:
    h = x if pad_mask is None else x.masked_fill(pad_mask[:, :, None], 0.0)
    conv = cb.conv_1
    h = F.conv1d(h.transpose(1, 2), conv.weight, conv.bias, padding=conv.padding,
                 groups=conv.weight.shape[0]).transpose(1, 2)
    h = masked_group_norm(h, h.shape[-1], cb.ln_1.weight, cb.ln_1.bias, pad_mask, cb.ln_1.eps)
    h = F.gelu(_linear_row(h, cb.conv_2, tp))
    return x + F.linear(h, cb.conv_3.weight, own_channels(cb.conv_3.bias, tp))


def time_embed(den, t: Tensor) -> Tensor:
    """This rank's channels of ``den.time_embed(t)``."""
    te = den.time_embed
    h = F.silu(F.linear(dit_timestep_embedding(t, te.freq), te.mlp_0.weight, te.mlp_0.bias))
    return F.linear(all_gather(h, den.tp), te.mlp_2.weight, te.mlp_2.bias)


def cond_embed(den, spk: Tensor) -> Tensor:
    """This rank's channels of ``den.cond_embed(spk)``."""
    return F.linear(spk, den.cond_embed.weight, den.cond_embed.bias)


def mods(den, y: Tensor) -> List[Tensor]:
    """The adaLN modulations of every block and of the final layer from
    this rank's channels of ``y``: this rank's channels of each of them."""
    y_all = all_gather(F.silu(y), den.tp)
    return [F.linear(y_all, m.adaLN_modulation.weight, m.adaLN_modulation.bias)
            for m in [*den.blocks(), den.final_layer]]


def forward(den, x: Tensor, mods_: List[Tensor], pad_mask: Optional[Tensor] = None) -> Tensor:
    """``SimpleMLPAdaLN.forward`` with the parameters split: the same
    result (the velocity, whole on every rank)."""
    tp = den.tp
    c = den.proj_in.weight.shape[0] * tp.size  # the hidden width
    x = F.linear(x, den.proj_in.weight, den.proj_in.bias)
    for blk, m in zip(den.blocks(), mods_):
        shift_c, scale_c, gate_c, shift_m, scale_m, gate_m = m.chunk(6, dim=-1)
        h = layer_norm(x, tp, c, blk.ln_conv.weight, blk.ln_conv.bias, blk.ln_conv.eps)
        x = x + gate_c * _convnext(blk.conv_in, modulate(h, shift_c, scale_c), pad_mask, tp)
        h = modulate(layer_norm(x, tp, c, blk.ln_mlp.weight, blk.ln_mlp.bias, blk.ln_mlp.eps),
                     shift_m, scale_m)
        h = F.silu(F.linear(all_gather(h, tp), blk.mlp_0.weight, blk.mlp_0.bias))
        x = x + gate_m * own_channels(_linear_row(h, blk.mlp_2, tp), tp)
    fl = den.final_layer
    shift_c, scale_c, gate_c, shift_m, scale_m = mods_[-1].chunk(5, dim=-1)
    h = _convnext(fl.conv_in, modulate(layer_norm(x, tp, c), shift_c, scale_c), pad_mask, tp)
    x = modulate(layer_norm(x + gate_c * h, tp, c), shift_m, scale_m)
    if pad_mask is not None:
        x = x.masked_fill(pad_mask[:, :, None], 0.0)
    return fl.conv_out(all_gather(x, tp).transpose(1, 2)).transpose(1, 2)
