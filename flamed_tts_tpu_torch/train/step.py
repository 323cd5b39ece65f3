"""AdamW with a warmup-cosine schedule, and one training step.

The update equals ``optax.adamw`` over the warmup-cosine schedule of the
JAX package (``flamed_tts_tpu/train/step.py``): p <- p - lr(n) (m_hat /
(sqrt(v_hat) + eps) + wd p), with the decay on every parameter (biases,
norm scales and embeddings too) and lr(n) taken at the count before the
update, so the first update of a warmup has lr = 0.  With
``torch.optim.AdamW`` that needs one parameter group with no decay mask,
``scheduler.step()`` after ``optimizer.step()``, and a gradient (zero
where the loss does not reach a parameter) for every parameter.

On a mesh (``parallel/mesh.py``; the JAX package's ``place_train_state`` /
``shard_batch`` / ``jit_train_step_on_mesh``): ``place_train_state``
splits the denoiser's parameters over the model axis
(``parallel/sharding.py``) and Adam's moments with them, and a step takes
this rank's rows of the batch.  Its draws (flow-matching times and noises,
dropout masks) are the whole batch's, sliced (``ops.dropout.BatchRows``),
and each loss is this rank's numerator over the whole batch's denominator,
so the sum over the data group is the loss of one process on the whole
batch, however the valid positions fall across the ranks.  The gradients
are summed over the data group (and, for a replicated parameter, over the
model group too: ``parallel/tensor_parallel.py`` says why the loss is
divided by the model axis's size first), so every rank applies the update
of one process on the whole batch; ``grad_norm`` counts every split part
once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor, nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from flamed_tts_tpu_torch.ops.dropout import BatchRows, set_dropout_generator, set_dropout_rows
from flamed_tts_tpu_torch.parallel.mesh import axis_rank, axis_size, group_sum
from flamed_tts_tpu_torch.parallel.sharding import gather_tensor, shard_params, shard_tensor
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

    def named_parameters(self):
        """(module, name, parameter) in the order of ``parameters``."""
        return ([("prior", n, p) for n, p in self.prior.named_parameters()]
                + [("prob", n, p) for n, p in self.prob.named_parameters()])

    def split_specs(self) -> Dict[str, Optional[int]]:
        """The prob parameters' split axes where they are split over a
        mesh's model axis, else {}."""
        tp = self.prob.denoiser.tp
        return {} if tp is None else tp.specs


def init_train_state(prior: nn.Module, prob: nn.Module, optimizer_cfg: Dict,
                     seed: int = 0) -> TrainState:
    device = next(prior.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    set_dropout_generator(prior, generator)
    set_dropout_generator(prob, generator)
    optimizer, scheduler = make_optimizer([*prior.parameters(), *prob.parameters()], optimizer_cfg)
    return TrainState(prior, prob, optimizer, scheduler, generator)


def place_train_state(state: TrainState, mesh) -> TrainState:
    """Put ``state`` on the mesh in place: the denoiser's parameters split
    over the model axis, Adam's moments (if a step or a resume made them)
    with their parameters; everything else replicated as it is."""
    shard_params(state.prob, mesh)
    specs = state.split_specs()
    for module, name, p in state.named_parameters():
        if module != "prob":
            continue
        moments = state.optimizer.state.get(p, {})
        for key in ("exp_avg", "exp_avg_sq"):
            if key in moments:
                moments[key] = shard_tensor(name, moments[key], specs, mesh)
    return state


def full_optimizer_state(state: TrainState, mesh) -> Dict:
    """``state.optimizer.state_dict()`` with every split moment gathered
    whole (a collective over the model group): the single-process format."""
    sd = state.optimizer.state_dict()
    specs = state.split_specs()
    if not specs:
        return sd
    # state_dict() hands out the optimizer's own per-parameter dicts
    sd["state"] = {i: dict(entry) for i, entry in sd["state"].items()}
    for i, (module, name, _) in enumerate(state.named_parameters()):
        entry = sd["state"].get(i)
        if module == "prob" and entry is not None:
            for key in ("exp_avg", "exp_avg_sq"):
                entry[key] = gather_tensor(name, entry[key], specs, mesh)
    return sd


def mesh_rows(lo: int, hi: int, total: int, mesh) -> Optional[BatchRows]:
    """``BatchRows`` of rows [lo, hi) of ``total`` on the mesh's data axis,
    with its denominators summed over the data group; None without a mesh."""
    if mesh is None:
        return None
    return BatchRows(lo, hi, total, lambda t: group_sum(t, mesh, "data"))


def _set_rows(state: TrainState, rows: Optional[BatchRows]) -> None:
    set_dropout_rows(state.prior, rows)
    set_dropout_rows(state.prob, rows)


def _grads(state: TrainState) -> Tuple[list, list]:
    """(the replicated parameters' gradients, the split ones')."""
    specs = state.split_specs()
    whole, split = [], []
    for m, n, p in state.named_parameters():
        (split if m == "prob" and specs.get(n) is not None else whole).append(p.grad)
    return whole, split


def _reduce_grads(state: TrainState, mesh) -> None:
    """Sum the gradients over the data group, and a replicated parameter's
    over the model group too (the whole world), in one flat buffer each."""
    if dist.get_world_size() == 1:
        return
    whole, split = _grads(state)
    for grads, group in ((whole, None), (split, mesh["data"].get_group())):
        if not grads or (group is not None and mesh["data"].size() == 1):
            continue
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)


def _grad_norm(state: TrainState, mesh) -> Tensor:
    """The global L2 norm of the gradients, each split part counted once."""
    whole, split = _grads(state)
    sq = torch.nn.utils.get_total_norm(whole) ** 2
    if split:
        sq = sq + group_sum(torch.nn.utils.get_total_norm(split) ** 2, mesh, "model")
    return torch.sqrt(sq)


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
               sigma_min_prob: float = 1e-6, loss_norm: str = "masked",
               mesh=None) -> Dict[str, Tensor]:
    """One AdamW step on ``batch`` (tensors on the state's device), dropout
    on.  Returns the losses and ``grad_norm`` (the gradients' global L2
    norm) as detached 0-d tensors; nothing is read back to the host.

    On a ``mesh`` (after ``place_train_state``) ``batch`` is this rank's
    rows of the step's batch, which the data axis splits evenly, and
    ``draws`` where given are this rank's rows of the whole batch's; the
    losses returned are the whole batch's."""
    params = state.parameters()
    state.prior.train()
    state.prob.train()
    state.optimizer.zero_grad(set_to_none=True)
    rows = None
    if mesh is not None:
        b, n, r = batch["phonemes"].shape[0], axis_size(mesh, "data"), axis_rank(mesh, "data")
        rows = mesh_rows(r * b, (r + 1) * b, n * b, mesh)
    _set_rows(state, rows)
    losses = compute_losses(state.prior, state.prob, batch, state.generator, draws,
                            sigma_min_pva, sigma_min_prob, loss_norm, rows)
    (losses["total_loss"] / axis_size(mesh, "model")).backward()
    for p in params:
        if p.grad is None:  # decayed like every other parameter, as optax does
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        _reduce_grads(state, mesh)
    metrics = {k: group_sum(v.detach(), mesh, "data") for k, v in losses.items()}
    metrics["grad_norm"] = _grad_norm(state, mesh)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics


@torch.no_grad()
def eval_losses(state: TrainState, batch: Dict[str, Tensor], sigma_min_pva: float = 1e-4,
                sigma_min_prob: float = 1e-6, loss_norm: str = "masked",
                rows: Optional[BatchRows] = None, mesh=None) -> Dict[str, Tensor]:
    """The losses of ``batch`` with dropout off and no gradient; the
    flow-matching draws still come from the state's generator.  On a
    ``mesh``, ``batch`` is this rank's ``rows`` (``mesh_rows``; a validation
    batch may split unevenly, and a rank may hold none: it adds zero to
    the numerators and the denominators) and the losses are the whole
    batch's."""
    state.prior.eval()
    state.prob.eval()
    losses = compute_losses(state.prior, state.prob, batch, state.generator, None,
                            sigma_min_pva, sigma_min_prob, loss_norm, rows)
    return {k: group_sum(v, mesh, "data") for k, v in losses.items()}
