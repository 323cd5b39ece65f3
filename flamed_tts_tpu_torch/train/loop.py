"""The training loop: metrics to JSONL (and wandb where it is installed),
JAX-format .npz checkpoints (the last one and the best ``top_k`` by
validation loss), and a full-state file to resume from.

The .npz files hold ``{"prior": {"params": ...}, "prob": {"params": ...}}``
flax trees, which ``Flamed.from_pretrained`` here and the JAX package's
``load_pytree_npz`` read.  The full state (``train_state.pt``) is PyTorch's
own: both modules' state dicts, the optimizer's moments, the schedule, the
step count and the step generator's state, with whatever the caller adds
(the collator's random state).

On a mesh every rank runs the loop on its rows of each batch; the
checkpoints gather split parameters and moments whole on every rank (a
collective) and only a manager with ``write`` (rank 0) writes them, in the
single-process format.
"""

from __future__ import annotations

import json
import math
import os
import time
import traceback
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from flamed_tts_tpu_torch.convert import params_to_jax
from flamed_tts_tpu_torch.parallel.mesh import rows_of, shard_batch
from flamed_tts_tpu_torch.parallel.sharding import full_state_dict
from flamed_tts_tpu_torch.runtime.pytree_io import save_pytree_npz
from flamed_tts_tpu_torch.train.step import (TrainState, batch_to_device, eval_losses,
                                             full_optimizer_state, mesh_rows, train_step)


class MetricLogger:
    """One JSON object a line in ``log_dir/metrics.jsonl``; wandb too where
    asked for and importable."""

    def __init__(self, log_dir: str, use_wandb: bool = False, wandb_kwargs=None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", encoding="utf-8")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError as exc:
                print(f"[train] wandb unavailable ({exc}); JSONL only")
            else:
                wandb.init(**(wandb_kwargs or {}))
                self._wandb = wandb

    def log(self, metrics: Dict, step: int) -> None:
        payload = {"step": step, "time": time.time()}
        payload.update({k: float(v) for k, v in metrics.items() if np.ndim(v) == 0})
        self._fh.write(json.dumps(payload) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(payload, step=step)

    def close(self) -> None:
        self._fh.close()


def params_tree(state: TrainState) -> Dict:
    """The state's parameters as the JAX package's checkpoint tree, split
    parameters gathered whole (every rank of a mesh calls it)."""
    return {"prior": params_to_jax(state.prior.state_dict()),
            "prob": params_to_jax(full_state_dict(state.prob))}


class CheckpointManager:
    """``last.npz``, the ``top_k`` lowest-validation-loss ``.npz`` files and
    ``train_state.pt`` under ``ckpt_dir``.  Every rank of a mesh calls its
    save methods (they gather); only a manager with ``write`` writes."""

    def __init__(self, ckpt_dir: str, top_k: int = 10, write: bool = True, mesh=None):
        self.ckpt_dir = ckpt_dir
        self.top_k = top_k
        self.write = write
        self.mesh = mesh
        self.best: List[Tuple[float, str]] = []
        if write:
            os.makedirs(ckpt_dir, exist_ok=True)

    @property
    def full_state_path(self) -> str:
        return os.path.join(self.ckpt_dir, "train_state.pt")

    def save_last(self, state: TrainState) -> str:
        path = os.path.join(self.ckpt_dir, "last.npz")
        tree = params_tree(state)
        if self.write:
            save_pytree_npz(path, tree)
        return path

    def save_topk(self, state: TrainState, val_loss: float, step: int) -> str:
        path = os.path.join(self.ckpt_dir, f"step{step}-val{val_loss:.4f}.npz")
        tree = params_tree(state)
        if not self.write:
            return path
        save_pytree_npz(path, tree)
        self.best.append((val_loss, path))
        self.best.sort(key=lambda item: item[0])
        while len(self.best) > self.top_k:
            _, worst = self.best.pop()
            if os.path.exists(worst):
                os.remove(worst)
        return path

    def save_full_state(self, state: TrainState, extra: Optional[Dict] = None) -> str:
        payload = {
            "step": state.step,
            "prior": state.prior.state_dict(),
            "prob": full_state_dict(state.prob),
            "optimizer": full_optimizer_state(state, self.mesh),
            "scheduler": state.scheduler.state_dict(),
            "generator": state.generator.get_state(),
            "extra": extra or {},
        }
        if not self.write:
            return self.full_state_path
        tmp = f"{self.full_state_path}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.full_state_path)
        return self.full_state_path

    def load_full_state(self, state: TrainState) -> Dict:
        """Restore ``state`` in place from ``train_state.pt``; returns the
        ``extra`` dict saved with it.  On a mesh, before
        ``place_train_state``."""
        device = next(state.prior.parameters()).device
        payload = torch.load(self.full_state_path, map_location=device, weights_only=True)
        state.prior.load_state_dict(payload["prior"])
        state.prob.load_state_dict(payload["prob"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        state.generator.set_state(payload["generator"].cpu())
        state.step = int(payload["step"])
        return payload["extra"]


def run_training(state: TrainState, train_batches: Iterator[Dict[str, np.ndarray]],
                 make_val_batches: Optional[Callable[[], Iterator[Dict[str, np.ndarray]]]],
                 max_steps: int, log_every: int = 50, val_every: int = 1000,
                 logger: Optional[MetricLogger] = None, ckpt: Optional[CheckpointManager] = None,
                 audio_logger: Optional[Callable[[TrainState, int], Optional[Dict]]] = None,
                 full_state_extra: Optional[Callable[[], Dict]] = None,
                 loss_norm: str = "masked", mesh=None) -> TrainState:
    """Steps from ``state.step`` to ``max_steps`` over numpy batches.

    Every ``log_every`` steps the last step's losses, ``grad_norm`` and the
    rates since the previous log (steps, samples and valid frames per
    second) are logged: the only host reads of the step's results.  Every
    ``val_every`` steps: the mean validation ``total_loss_val``, a top-k
    checkpoint, ``last.npz``, the full state and the audio logger (whose
    returned scalars are logged), outside the timed intervals.

    On a ``mesh`` every rank gets the whole batches and steps on its rows
    (``shard_batch``; a validation batch's rows split as ``rows_of``
    cuts them); pass a ``logger`` on rank 0 alone.  The rates count the
    whole batch."""
    device = next(state.prior.parameters()).device
    first_step = True
    t_last = time.perf_counter()
    n_steps = n_samples = n_frames = 0
    for batch in train_batches:
        if state.step >= max_steps:
            break
        metrics = train_step(state, batch_to_device(shard_batch(batch, mesh), device),
                             loss_norm=loss_norm, mesh=mesh)
        step = state.step
        n_steps += 1
        n_samples += int(batch["phonemes"].shape[0])
        n_frames += int(np.sum(batch["y_len"]))

        if first_step:
            # a host read ends the first step: its time includes the kernels'
            # first use and the allocator's growth
            first_step = False
            float(metrics["total_loss"])
            first_s = time.perf_counter() - t_last
            print(f"[train] first step done in {first_s:.1f}s", flush=True)
            if logger is not None:
                logger.log({"first_step_s": first_s}, step)
            t_last = time.perf_counter()
            n_steps = n_samples = n_frames = 0

        if logger is not None and step % log_every == 0:
            values = {k: float(v) for k, v in metrics.items()}
            values["lr"] = state.scheduler.get_last_lr()[0]
            if n_steps:  # the rates over the steps since the last log
                dt = max(time.perf_counter() - t_last, 1e-9)
                values.update(steps_per_sec=n_steps / dt, samples_per_sec=n_samples / dt,
                              frames_per_sec=n_frames / dt)
            logger.log(values, step)
            t_last = time.perf_counter()
            n_steps = n_samples = n_frames = 0

        if step % val_every == 0:
            t_val = time.perf_counter()
            if make_val_batches is not None:
                losses = [float(_val_loss(state, b, device, loss_norm, mesh))
                          for b in make_val_batches()]
                val_loss = float(np.mean(losses)) if losses else float("nan")
                if logger is not None:
                    logger.log({"total_loss_val": val_loss}, step)
                if ckpt is not None and math.isfinite(val_loss):
                    ckpt.save_topk(state, val_loss, step)
            if ckpt is not None:
                ckpt.save_last(state)
                ckpt.save_full_state(state, full_state_extra() if full_state_extra else None)
            if audio_logger is not None:
                try:
                    info = audio_logger(state, step)
                except Exception:  # audio logging must never end a run
                    print("[train] validation audio logging failed:", flush=True)
                    traceback.print_exc()
                else:
                    if info and logger is not None:
                        logger.log(info, step)
            if logger is not None:
                logger.log({"val_s": time.perf_counter() - t_val}, step)
            t_last += time.perf_counter() - t_val
    if ckpt is not None:
        ckpt.save_last(state)
        ckpt.save_full_state(state, full_state_extra() if full_state_extra else None)
    return state


def _val_loss(state: TrainState, batch: Dict[str, np.ndarray], device, loss_norm: str, mesh):
    """One validation batch's ``total_loss``; on a mesh from this rank's
    rows of it (none, for a rank past a short batch's end)."""
    total = len(batch["phonemes"])
    lo, hi = rows_of(total, mesh)
    local = batch_to_device({k: v[lo:hi] for k, v in batch.items()}, device)
    return eval_losses(state, local, loss_norm=loss_norm, rows=mesh_rows(lo, hi, total, mesh),
                       mesh=mesh)["total_loss"]
