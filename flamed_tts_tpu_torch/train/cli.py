"""Training CLI of the PyTorch/CUDA port.

    python -m flamed_tts_tpu_torch.train --config-dir configs --exp-dir exp/run1 \\
        [--max-steps N] [--device cuda|cpu] [--resume ckpt.npz | --resume-full]
    torchrun --standalone --nproc-per-node N -m flamed_tts_tpu_torch.train \\
        --devices DATA,MODEL ...

The flags of the repository's root ``train.py``, with ``--device`` (``cuda``,
the default, or ``cpu``).  ``--devices data,model`` trains on a mesh of
that shape over the processes ``torchrun`` starts (data * model of them):
NCCL, each process on ``cuda:LOCAL_RANK``, or gloo with ``--device cpu``.
The batch is split over the data axis (``--batch-size`` must be a multiple
of it) and the denoiser's hidden width over the model axis
(``parallel/``); rank 0 alone writes the config, the metrics, the
checkpoints (gathered whole, the same files as one process writes) and
the validation audio.  Without ``--devices`` it trains in one process.  It
composes the five configs (``prior``, ``prob``, ``codec``, ``optimizer``,
``data``.yaml in ``--config-dir``), writes the merged ``config.yaml`` into
the experiment directory (the file the synthesis CLI reads), and trains
the prior and prob generators with AdamW on bucketed batches:

* ``exp_dir/metrics.jsonl``: losses, ``grad_norm``, steps / samples /
  frames per second every ``--log-every`` steps, ``total_loss_val`` every
  ``--val-every``;
* ``exp_dir/checkpoints/``: ``last.npz`` and the best validation
  checkpoints in the JAX package's .npz format, and ``train_state.pt`` for
  ``--resume-full``;
* ``exp_dir/val_audio/``: with ``--codec-dir``, from step
  ``--audio-log-after`` on, one validation utterance synthesized and its
  ground truth decoded at every validation.

Validation keeps a last partial batch (the JAX trainer drops it to save a
compile; eager PyTorch has none to save).  ``--resume-full`` restores the
parameters, the optimizer, the schedule, the step and the random states,
and starts the data order again from the first epoch, as the JAX trainer
does.  The trainer sets no matmul precision, as the root ``train.py`` sets
none: it runs the process's (``precision.py``; ``"default"`` unless the
caller set another), with float32 master weights and AdamW state.  On the
card that gives the prior's and the denoiser's matmuls and convs, forward
and backward, bfloat16 operands with float32 accumulation; on the CPU they
are float32.  The codec's float32 convolutions in the validation audio run
under PyTorch's own TF32 switches as the caller left them.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from flamed_tts_tpu_torch.config import compose_training_config, save_yaml
from flamed_tts_tpu_torch.data.dataset import (BucketedCollator, PrecomputedDataset,
                                               TextCodesDataset, batch_iterator)
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.parallel.mesh import axis_size, init_distributed, is_rank0, make_mesh
from flamed_tts_tpu_torch.train.loop import CheckpointManager, MetricLogger, run_training
from flamed_tts_tpu_torch.train.step import TrainState, init_train_state, place_train_state
from flamed_tts_tpu_torch.utils.audio import save_wav


def load_training_config(config_dir: str, overrides: Optional[Dict] = None) -> Dict:
    d = config_dir
    return compose_training_config(*(os.path.join(d, f"{n}.yaml")
                                     for n in ("prior", "prob", "codec", "optimizer", "data")),
                                   overrides=overrides)


def make_datasets(dataset_cfg: Dict):
    """(train set, validation set) from the data config."""
    common = dict(data_root=dataset_cfg["data_root"], dur_min=float(dataset_cfg["dur_min"]),
                  dur_max=float(dataset_cfg["dur_max"]),
                  n_words_min=int(dataset_cfg["n_words_min"]), seed=dataset_cfg.get("seed"))
    if dataset_cfg.get("use_precomputed", False):
        return tuple(PrecomputedDataset(manifest=dataset_cfg[m], **common)
                     for m in ("train_manifest", "valid_manifest"))
    common.update(cleaners=dataset_cfg["cleaners"],
                  sampling_rate=int(dataset_cfg["sampling_rate"]),
                  down_factors=dataset_cfg["down_factors"], sil_phones=dataset_cfg.get("sil_phones"))
    return tuple(TextCodesDataset(manifest=dataset_cfg[m], **common)
                 for m in ("train_manifest", "valid_manifest"))


def make_collator(dataset_cfg: Dict, seed: int) -> BucketedCollator:
    """The collator of the data config: its phoneme, frame and prompt
    buckets, prompts cropped to ``prompt_reduced_factor`` of at most
    ``prompt_dur_max`` seconds."""
    frames_per_s = int(dataset_cfg["sampling_rate"]) // int(np.prod(dataset_cfg["down_factors"]))
    return BucketedCollator(
        vocab_size=int(dataset_cfg["vocab_size"]),
        prompt_max_len=int(float(dataset_cfg["prompt_dur_max"]) * frames_per_s),
        prompt_reduced_factor=float(dataset_cfg["prompt_reduced_factor"]),
        phoneme_buckets=dataset_cfg.get("phoneme_buckets", (64, 128, 192, 256)),
        frame_buckets=dataset_cfg.get("frame_buckets", (256, 512, 768, 1024, 1408)),
        prompt_buckets=dataset_cfg.get("prompt_buckets"),
        seed=seed,
    )


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.train",
                                     description="Train Flamed-TTS's prior and prob generators on "
                                                 "one NVIDIA GPU (PyTorch/CUDA port).")
    parser.add_argument("--config-dir", type=str, default="configs")
    parser.add_argument("--exp-dir", type=str, required=True)
    parser.add_argument("--devices", type=str, default=None,
                        help="data,model mesh shape over the processes torchrun starts "
                             "(default: one process, no mesh).")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="Converted .npz params to resume from (weights only).")
    parser.add_argument("--resume-full", action="store_true",
                        help="Resume params, optimizer, schedule, step and generator states from "
                             "exp_dir/checkpoints/train_state.pt.")
    parser.add_argument("--val-every", type=int, default=1000)
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--codec-dir", type=str, default=None,
                        help="Converted codec checkpoints for validation audio ('random' ok).")
    parser.add_argument("--audio-log-after", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--loss-norm", choices=["masked", "reference"], default="masked",
                        help="Loss normalization: valid-position means (default) or the "
                             "reference's padded-buffer means.")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default) or cpu (the kernels' plain PyTorch versions).")
    return parser


def _audio_logger(args, cfg: Dict, model: Flamed, make_val_batches, write: bool = True):
    """Validation audio: one validation utterance synthesized by the model
    being trained, and its ground-truth latents decoded.  Returns the frame
    counts the codec decoded at, for the metrics.  On a mesh every rank
    samples (a split denoiser's collectives need them all) and only the
    one that ``write``s saves the wavs."""
    if args.codec_dir == "random":
        codec = FaCodec.random_init(torch.Generator().manual_seed(0), device=model.device,
                                    codec_cfg=cfg["codec_cfg"])
    else:
        codec = FaCodec.from_pretrained(args.codec_dir, cfg["codec_cfg"], device=model.device)
    out_dir = os.path.join(args.exp_dir, "val_audio")
    cache = []

    def log_audio(state: TrainState, step: int) -> None:
        if step < args.audio_log_after:
            return
        if not cache:
            cache.append(next(iter(make_val_batches()), None))
        val = cache[0]
        if val is None:
            return
        state.prior.eval()
        state.prob.eval()
        # staged: one decode, at the frame bucket the sampled length needs
        out = model.sample_batch(phonemes=val["phonemes"][:1], src_lens=val["x_len"][:1],
                                 prompts=val["prompts"][:1], timbres=val["spks"][:1],
                                 prompt_lens=val["prompt_lens"][:1], codec=codec, seed=step,
                                 nsteps_durgen=16, nsteps_denoiser=32, fused=False)
        n = int(out["tgt_len"][0]) * codec.hop
        m = int(val["y_len"][0])
        gt = codec.decode(torch.as_tensor(val["embs"][:1, :m], device=model.device),
                          torch.as_tensor(val["spks"][:1], device=model.device))
        if write:
            save_wav(os.path.join(out_dir, f"step{step}_synth.wav"), out["wav"][0, :n, 0])
            save_wav(os.path.join(out_dir, f"step{step}_gt.wav"), gt[0, :, 0].float().cpu().numpy())
        return {"val_audio_frame_bucket": int(out["frame_bucket"]), "val_audio_gt_frames": m}

    return log_audio


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    args = build_arg_parser().parse_args(argv)
    cfg = load_training_config(args.config_dir)
    device, mesh = args.device, None
    if args.devices:
        n_data, n_model = (int(x) for x in args.devices.split(","))
        device = init_distributed(args.device)
        mesh = make_mesh(n_data, n_model, device.type)
        print(f"Mesh: data={n_data} model={n_model}, rank {torch.distributed.get_rank()} on {device}")
    write = is_rank0(mesh)
    if write:
        os.makedirs(args.exp_dir, exist_ok=True)
        save_yaml(cfg, os.path.join(args.exp_dir, "config.yaml"))
    dataset_cfg, optimizer_cfg = cfg["dataset_cfg"], cfg["optimizer_cfg"]
    batch_size = args.batch_size or int(dataset_cfg["batch_size"])
    max_steps = args.max_steps or int(optimizer_cfg["max_steps"])
    if batch_size % axis_size(mesh, "data"):
        raise ValueError(f"a batch of {batch_size} does not split over {axis_size(mesh, 'data')} "
                         "data ranks")

    if mesh is not None and dataset_cfg.get("seed") is None:
        # the datasets shuffle with the data config's seed, a fresh one where
        # it is null: on a mesh every rank must hold the same order, so rank
        # 0 draws it for all
        shared = [random.SystemRandom().randrange(2 ** 31)]
        torch.distributed.broadcast_object_list(shared, src=0)
        dataset_cfg = dict(dataset_cfg, seed=shared[0])
    trainset, validset = make_datasets(dataset_cfg)
    if len(trainset) < batch_size:
        raise ValueError(f"{len(trainset)} training samples make no batch of {batch_size}")
    collator = make_collator(dataset_cfg, args.seed)

    # eager sampling: the validation audio is one call in many steps, and a
    # captured graph would hold its memory pool through the training
    if args.resume:
        model = Flamed.from_pretrained(cfg, args.resume, device=device, graphs=False)
        print(f"Resumed params from {args.resume}")
    else:
        model = Flamed(cfg, device=device, generator=torch.Generator().manual_seed(args.seed),
                       graphs=False)
    print(f"Parameters: {model.num_params() / 1e6:.2f} M on {model.device}")
    state = init_train_state(model.prior, model.prob, optimizer_cfg, args.seed)

    logger = (MetricLogger(args.exp_dir, use_wandb=args.wandb,
                           wandb_kwargs={"project": "flamed-tts-tpu"}) if write else None)
    ckpt = CheckpointManager(os.path.join(args.exp_dir, "checkpoints"), write=write, mesh=mesh)
    if args.resume_full:
        extra = ckpt.load_full_state(state)
        if "collator_rng" in extra:
            collator.rng.setstate(extra["collator_rng"])
        print(f"Resumed full train state at step {state.step}")
    if mesh is not None:
        place_train_state(state, mesh)

    def make_val_batches() -> Iterator[Dict[str, np.ndarray]]:
        return batch_iterator(validset, collator, batch_size, shuffle=False, drop_last=False)

    def epochs() -> Iterator[Dict[str, np.ndarray]]:
        epoch = 0
        while True:
            yield from batch_iterator(trainset, collator, batch_size, shuffle=True,
                                      seed=args.seed + epoch)
            epoch += 1

    audio_logger = (_audio_logger(args, cfg, model, make_val_batches, write)
                    if args.codec_dir else None)
    try:
        run_training(state, epochs(), make_val_batches, max_steps, log_every=args.log_every,
                     val_every=args.val_every, logger=logger, ckpt=ckpt, audio_logger=audio_logger,
                     full_state_extra=lambda: {"collator_rng": collator.rng.getstate()},
                     loss_norm=args.loss_norm, mesh=mesh)
    finally:
        if logger is not None:
            logger.close()
        if mesh is not None:
            torch.distributed.destroy_process_group()
    print(f"Training finished at step {state.step}")
    return state
