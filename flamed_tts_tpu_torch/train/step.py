"""AdamW with a warmup-cosine schedule, and one training step.

The update equals ``optax.adamw`` over the warmup-cosine schedule of the
JAX package (``flamed_tts_tpu/train/step.py``): p <- p - lr(n) (m_hat /
(sqrt(v_hat) + eps) + wd p), with the decay on every parameter (biases,
norm scales and embeddings too) and lr(n) taken at the count before the
update, so the first update of a warmup has lr = 0.  With
``torch.optim.AdamW`` that needs one parameter group with no decay mask,
``scheduler.step()`` after ``optimizer.step()``, and a gradient (zero
where the loss does not reach a parameter) for every parameter.

Mesh placement (data and tensor parallel) is not here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from flamed_tts_tpu_torch.ops.dropout import set_dropout_generator
from flamed_tts_tpu_torch.train.losses import compute_losses


def warmup_cosine_schedule(lr: float, warmup_steps: int, max_steps: int) -> Callable[[int], float]:
    """step -> learning rate: linear from 0 over ``warmup_steps``, then a
    half cosine to 0 at ``max_steps`` (transformers'
    get_cosine_schedule_with_warmup)."""
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, max_steps - warmup_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * min(max(progress, 0.0), 1.0)))

    return schedule


def make_optimizer(params, optimizer_cfg: Dict) -> Tuple[torch.optim.AdamW,
                                                         torch.optim.lr_scheduler.LambdaLR]:
    """AdamW and its schedule from the optimizer config (lr, betas, eps,
    weight_decay, warmup_steps, max_steps)."""
    lr = float(optimizer_cfg["lr"])
    betas = tuple(float(b) for b in optimizer_cfg["betas"])
    optimizer = torch.optim.AdamW(params, lr=lr, betas=betas, eps=float(optimizer_cfg["eps"]),
                                  weight_decay=float(optimizer_cfg["weight_decay"]))
    schedule = warmup_cosine_schedule(1.0, int(optimizer_cfg["warmup_steps"]),
                                      int(optimizer_cfg["max_steps"]))
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)


@dataclass
class TrainState:
    """What a step changes: the two generators' parameters, the optimizer
    and its schedule, the step count and the generator that the step's
    times, noises and dropout masks come from (on the step's device)."""
    prior: nn.Module
    prob: nn.Module
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    generator: torch.Generator
    step: int = 0

    def parameters(self):
        return [*self.prior.parameters(), *self.prob.parameters()]


def init_train_state(prior: nn.Module, prob: nn.Module, optimizer_cfg: Dict,
                     seed: int = 0) -> TrainState:
    device = next(prior.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    set_dropout_generator(prior, generator)
    set_dropout_generator(prob, generator)
    optimizer, scheduler = make_optimizer([*prior.parameters(), *prob.parameters()], optimizer_cfg)
    return TrainState(prior, prob, optimizer, scheduler, generator)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    """A collated numpy batch -> tensors on ``device``: integers as int64,
    floats as float32."""
    out = {}
    for key, value in batch.items():
        value = np.asarray(value)
        dtype = torch.long if np.issubdtype(value.dtype, np.integer) else torch.float32
        out[key] = torch.as_tensor(value).to(device=device, dtype=dtype, non_blocking=True)
    return out


def train_step(state: TrainState, batch: Dict[str, Tensor],
               draws: Optional[Dict[str, Tensor]] = None, sigma_min_pva: float = 1e-4,
               sigma_min_prob: float = 1e-6, loss_norm: str = "masked") -> Dict[str, Tensor]:
    """One AdamW step on ``batch`` (tensors on the state's device), dropout
    on.  Returns the losses and ``grad_norm`` (the gradients' global L2
    norm) as detached 0-d tensors; nothing is read back to the host."""
    params = state.parameters()
    state.prior.train()
    state.prob.train()
    state.optimizer.zero_grad(set_to_none=True)
    losses = compute_losses(state.prior, state.prob, batch, state.generator, draws,
                            sigma_min_pva, sigma_min_prob, loss_norm)
    losses["total_loss"].backward()
    for p in params:
        if p.grad is None:  # decayed like every other parameter, as optax does
            p.grad = torch.zeros_like(p)
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["grad_norm"] = torch.nn.utils.get_total_norm([p.grad for p in params])
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics


@torch.no_grad()
def eval_losses(state: TrainState, batch: Dict[str, Tensor], sigma_min_pva: float = 1e-4,
                sigma_min_prob: float = 1e-6, loss_norm: str = "masked") -> Dict[str, Tensor]:
    """The losses of ``batch`` with dropout off and no gradient; the
    flow-matching draws still come from the state's generator."""
    state.prior.eval()
    state.prob.eval()
    return compute_losses(state.prior, state.prob, batch, state.generator, None,
                          sigma_min_pva, sigma_min_prob, loss_norm)
