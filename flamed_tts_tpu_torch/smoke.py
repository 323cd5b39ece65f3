"""Smoke test of the model on made-up tensors, no codec and no data.

    python -m flamed_tts_tpu_torch.smoke [--device cuda|cpu] [--nsteps 4] [--seed 0] [--small]

The repository's root ``test.py`` for this package: builds the full model
from ``configs/`` (``--small`` cuts the layer counts, not the widths),
makes a deterministic batch in the training batch contract (the nine
tensors, phoneme and silence durations summing to each target length),
prints the parameter count, the losses in eval mode and the shapes that
sampling gives, and fails on a non-finite value.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from flamed_tts_tpu_torch.config import load_default_config
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.train.losses import compute_losses
from flamed_tts_tpu_torch.train.step import batch_to_device


def build_cfg(small: bool) -> Dict:
    cfg = load_default_config()
    if small:
        t = cfg["prior_generator"]["transformer"]
        t.update(encoder_layer=2, decoder_shared_layers=1, decoder_layers=[1, 1, 1, 1, 1, 1])
        cfg["prob_generator"]["n_layers"] = 2
    return cfg


def dummy_training_batch(rng: np.random.RandomState, cfg: Dict) -> Dict[str, np.ndarray]:
    """Two utterances of 24 and 18 phonemes, y_len the sum of the valid
    durations, codes and latents padded past it, a 40-frame prompt with its
    content quantizers masked."""
    b, l, p = 2, 24, 40
    n_q = cfg["prior_generator"]["codec"]["n_quantizers"]
    vocab = cfg["prior_generator"]["codec"]["vocab_size"]
    emb_dim = cfg["prob_generator"]["target_dim"]
    x_len = np.array([l, l - 6], dtype=np.int32)
    phonemes = rng.randint(1, 300, (b, l)).astype(np.int32)
    phone_dur = rng.randint(1, 6, (b, l)).astype(np.int32)
    sil_dur = rng.randint(0, 3, (b, l)).astype(np.int32)
    for i, n in enumerate(x_len):
        phonemes[i, n:] = phone_dur[i, n:] = sil_dur[i, n:] = 0
    y_len = (phone_dur.sum(axis=1) + sil_dur.sum(axis=1)).astype(np.int32)
    lf = int(y_len.max())
    codes = rng.randint(0, vocab, (b, n_q, lf)).astype(np.int32)
    embs = rng.randn(b, lf, emb_dim).astype(np.float32)
    for i, n in enumerate(y_len):
        codes[i, :, n:] = vocab
        embs[i, n:] = 0.0
    prompts = rng.randint(0, vocab, (b, n_q, p)).astype(np.int32)
    prompts[:, 1:3, :] = vocab
    spks = rng.randn(b, cfg["prob_generator"]["spk_dim"]).astype(np.float32)
    return {"phonemes": phonemes, "x_len": x_len, "codes": codes, "y_len": y_len,
            "phone_dur": phone_dur, "sil_dur": sil_dur, "embs": embs, "prompts": prompts,
            "spks": spks}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.smoke",
                                     description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--nsteps", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--small", action="store_true",
                        help="Cut the layer counts for a fast smoke run.")
    args = parser.parse_args(argv)

    cfg = build_cfg(args.small)
    t0 = time.time()
    model = Flamed(cfg, device=args.device, generator=torch.Generator().manual_seed(args.seed))
    print(f"Model built in {time.time() - t0:.1f}s")
    print(f"Parameter count: {model.num_params() / 1e6:.2f} M")
    batch = dummy_training_batch(np.random.RandomState(args.seed), cfg)

    print("\n--- loss path ---")
    t0 = time.time()
    with torch.no_grad():
        losses = compute_losses(model.prior, model.prob, batch_to_device(batch, model.device),
                                generator=torch.Generator(model.device).manual_seed(args.seed))
    losses = {k: float(v) for k, v in losses.items()}
    for key, value in sorted(losses.items()):
        print(f"  {key}: {value:.4f}")
    print(f"  ({time.time() - t0:.1f}s)")
    if not all(np.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"non-finite loss: {losses}")

    print("\n--- sampling path (no codec) ---")
    t0 = time.time()
    out = model.sample_batch(phonemes=batch["phonemes"], src_lens=batch["x_len"],
                             prompts=batch["prompts"], timbres=batch["spks"],
                             nsteps_durgen=args.nsteps, nsteps_denoiser=args.nsteps, seed=args.seed)
    for key in ("latents", "prior_embs", "prior_logits"):
        print(f"  {key}: {tuple(out[key].shape)}")
    print(f"  tgt_len: {out['tgt_len']}")
    print(f"  ({time.time() - t0:.1f}s)")
    if not torch.isfinite(out["latents"]).all():
        raise RuntimeError("non-finite latents")
    print("\nSMOKE TEST PASSED")
    return losses


if __name__ == "__main__":
    main()
