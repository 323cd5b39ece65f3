"""K1: the codec's alias-free SnakeBeta as one CUDA kernel
(csrc/snake_filtered.cu), with the plain chain of ops/resample.py as its
plain version.

``snake_filtered`` runs the kernel for a CUDA tensor and the plain chain
for a CPU tensor; there is no other switch.  Under grad the kernel runs
inside ``SnakeFiltered``, whose backward is the plain chain's VJP
(``kernels.plain_vjp``).
"""

from __future__ import annotations

import torch

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.ops import costs
from flamed_tts_tpu_torch.ops.resample import snake_filtered_reference


def _launch(x: torch.Tensor, log_alpha: torch.Tensor, log_beta: torch.Tensor) -> torch.Tensor:
    """One K1 launch."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    b, t, c = x.shape
    kernels.require(x, "x", aligned=c % 64 == 0)  # two channels a lane there
    log_alpha, log_beta = log_alpha.float(), log_beta.float()
    kernels.require(log_alpha, "log_alpha", (c,))
    kernels.require(log_beta, "log_beta", (c,))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = kernels.library("snake_filtered").snake_filtered_launch
    err = fn(x.data_ptr(), log_alpha.data_ptr(), log_beta.data_ptr(), out.data_ptr(),
             b, t, c, int(x.dtype == torch.bfloat16), kernels.stream_handle(x))
    kernels.check(err, "snake_filtered")
    kernels.launches["snake_filtered"] += 1
    return out


class SnakeFiltered(torch.autograd.Function):
    """Forward: one K1 launch.  Backward: the plain chain's VJP at the
    saved input, for x, log_alpha and log_beta."""

    @staticmethod
    def forward(ctx, x, log_alpha, log_beta):
        ctx.save_for_backward(x, log_alpha, log_beta)
        return _launch(x, log_alpha, log_beta)

    @staticmethod
    def backward(ctx, grad_out):
        return kernels.plain_vjp(snake_filtered_reference, ctx.saved_tensors, grad_out,
                                 ctx.needs_input_grad)


def snake_filtered_cuda(x: torch.Tensor, log_alpha: torch.Tensor, log_beta: torch.Tensor) -> torch.Tensor:
    """x (B, T, C) float32 or bfloat16 on the card; log_alpha, log_beta
    (C,), read as float32 (a bfloat16 pair is upcast first).  Under grad,
    with a float32 tensor that requires grad, the result carries the
    plain chain's gradient (``SnakeFiltered``); a bfloat16 one is refused."""
    if kernels.needs_grad(x, log_alpha, log_beta):
        return SnakeFiltered.apply(x, log_alpha, log_beta)
    return _launch(x, log_alpha, log_beta)


def snake_filtered(x: torch.Tensor, log_alpha: torch.Tensor, log_beta: torch.Tensor) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU one.  While a
    ``costs.CostCounter`` is active the call counts as one K1 launch."""
    if costs.counting():
        return costs.hand_kernels([("snake_filtered", x.shape[0] * x.shape[1], x.shape[2])], x.dtype,
                                  lambda: snake_filtered(x, log_alpha, log_beta))
    if x.device.type == "cpu":
        return snake_filtered_reference(x, log_alpha, log_beta)
    return snake_filtered_cuda(x, log_alpha, log_beta)
