"""Train the FaCodec analysis-synthesis stack on a fabricated corpus.

    python -m flamed_tts_tpu_torch.train_codec --corpus DIR --out-dir DIR \
        [--steps 4000] [--batch 8] [--crop-frames 160] [--device cuda|cpu]

The flags, losses, optimizer and checkpoints are those of the JAX package's
``tools/train_codec.py``:

* reconstruction: waveform L1 + log-mel L1 at two scales, through the
  encoder, the RVQ training path (straight-through, commitment and codebook
  losses on the unit sphere, batch-statistics whitening, quantizer dropout:
  ``models/facodec/extras.py::analyze_train``) and the timbre-conditioned
  synthesis;
* phone cross-entropy on the content group's quantized sum, from the
  corpus's frame alignments; speaker cross-entropy on the pooled timbre;
  a pin of the latents' log-RMS;
* ``optax.apply_if_finite(chain(clip_by_global_norm(1.0), adam(warmup
  cosine decay to 0.05 lr)))`` (``FiniteAdam``), re-initialised after the
  data-dependent VQ initialisation;
* dead-code revival every ``--revive-every`` steps until ``steps - 200``;
* checkpoints with the whitening folded into each ``in_proj`` in float64
  (``ns3_facodec_{encoder,decoder}.npz``, ``train_heads.npz``), which both
  packages' ``FaCodec.from_pretrained`` read, and ``metrics.jsonl``.

The batches are cropped by ``np.random.RandomState(seed)`` in the JAX
tool's order, so both trainers see the same crops; the quantizer-dropout
draws come from a ``torch.Generator`` (the JAX tool draws them from
``jax.random``).  The corpus directory holds ``fab_manifest.txt`` and
``speakers.txt`` (``data/synthetic.py::fabricate_speaker_corpus`` writes
them).  On the card every Snake and residual unit of the encoder and
decoder is a hand kernel (K1, K2) whose backward is the plain chain's VJP.
The trainer runs in float32 under PyTorch's own TF32 switches.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from flamed_tts_tpu_torch import asr
from flamed_tts_tpu_torch.convert import params_to_jax
from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.models.facodec.decoder import init_decoder_params, synthesize
from flamed_tts_tpu_torch.models.facodec.encoder import encoder_forward, init_encoder_params
from flamed_tts_tpu_torch.models.facodec.extras import (_nearest, _whiten_sg, analyze_train,
                                                        quantizer_counts, whitening_fold)
from flamed_tts_tpu_torch.models.facodec.quantize import linear
from flamed_tts_tpu_torch.ops.melspec import mel_spectrogram
from flamed_tts_tpu_torch.runtime.pytree_io import save_pytree_npz
from flamed_tts_tpu_torch.utils.audio import load_wav
from flamed_tts_tpu_torch.utils.textgrid import get_tier

SR = 16000
HOP = 200
FPS = SR // HOP
MAX_SKIPS = 250  # consecutive non-finite updates before the run gives up
LOSS_WEIGHTS = ("mel", "wav", "commit", "phone", "spk", "latreg")


def load_corpus(corpus_dir: str, holdout: set):
    """-> (wavs [float32], frame labels [int32, ``asr`` classes], speaker
    ids, number of training speakers, number of held-out utterances)."""
    spk_of = {}
    with open(os.path.join(corpus_dir, "speakers.txt"), encoding="utf-8") as fin:
        for line in fin:
            if "|" in line:
                stem, s = line.strip().split("|", 1)
                spk_of[stem] = s
    train_speakers = sorted(set(spk_of.values()) - holdout)
    spk_ids = {s: i for i, s in enumerate(train_speakers)}
    wavs, labels, spks, n_held = [], [], [], 0
    with open(os.path.join(corpus_dir, "fab_manifest.txt"), encoding="utf-8") as fin:
        for line in fin:
            parts = line.strip().split("|")
            if len(parts) < 3:
                continue
            spk = spk_of.get(os.path.splitext(os.path.basename(parts[0]))[0])
            if spk in holdout:
                n_held += 1
                continue
            wav = load_wav(parts[0])
            n_frames = len(wav) // HOP
            lab = np.zeros(n_frames, np.int32)
            for iv in get_tier(parts[1], "phones"):
                a = int(round(iv.start_time * FPS))
                b = min(int(round(iv.end_time * FPS)), n_frames)
                lab[a:b] = asr.phone_label(iv.text)
            wavs.append(wav[: n_frames * HOP].astype(np.float32))
            labels.append(lab)
            spks.append(spk_ids[spk])
    return wavs, labels, np.asarray(spks, np.int32), len(train_speakers), n_held


def make_batch(rng_np: np.random.RandomState, wavs, labels, spks, batch: int, crop_frames: int):
    """Random utterances, each cropped at a random frame to ``crop_frames``
    (zero-padded where shorter): (wav (B, crop * 200, 1), labels (B, crop),
    speakers (B,)), drawn from ``rng_np`` in the JAX tool's order."""
    crop_t = crop_frames * HOP
    wav_b = np.zeros((batch, crop_t, 1), np.float32)
    lab_b = np.zeros((batch, crop_frames), np.int32)
    spk_b = np.zeros((batch,), np.int32)
    for i in range(batch):
        u = rng_np.randint(len(wavs))
        w, lab = wavs[u], labels[u]
        f0 = rng_np.randint(len(lab) - crop_frames) if len(lab) > crop_frames else 0
        seg_l = lab[f0: f0 + crop_frames]
        seg_w = w[f0 * HOP: (f0 + crop_frames) * HOP]
        wav_b[i, : len(seg_w), 0] = seg_w
        lab_b[i, : len(seg_l)] = seg_l
        spk_b[i] = spks[u]
    return wav_b, lab_b, spk_b


def init_params(generator: torch.Generator, n_speakers: int) -> Dict:
    """{"enc", "dec", "heads"}: the codec at the JAX tool's default widths
    and the two CE heads, random from ``generator`` (on the CPU)."""
    g = generator
    return {"enc": init_encoder_params(g), "dec": init_decoder_params(g),
            "heads": {"phone_w": torch.randn((256, asr.N_CLASSES), generator=g) * 0.05,
                      "phone_b": torch.zeros(asr.N_CLASSES),
                      "spk_w": torch.randn((256, n_speakers), generator=g) * 0.05,
                      "spk_b": torch.zeros(n_speakers)}}


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-6)


def _smoothed_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Cross-entropy against one-hot targets smoothed by 0.05."""
    logp = torch.log_softmax(logits, dim=-1)
    n = logits.shape[-1]
    onehot = F.one_hot(target.long(), n).to(logp.dtype)
    return -((0.95 * onehot + 0.05 / n) * logp).sum(-1).mean()


def loss_fn(p: Dict, wav: torch.Tensor, lab: torch.Tensor, spk: torch.Tensor,
            n_q: Optional[Sequence[torch.Tensor]], weights: Dict[str, float],
            bypass_vq: bool = False):
    """(total loss, metrics) of one batch; ``n_q`` holds the three groups'
    quantizer-dropout counts (``extras.quantizer_counts``).  The metrics
    are detached tensors: the terms, ``lat_rms``, the accuracies and the
    distinct codes per stream (``code_usage``)."""
    latents = encoder_forward(p["enc"], wav)
    q_sum, codes, commit, buf, timbre = analyze_train(p["dec"], latents, n_q, normalized_losses=True,
                                                      center=True)
    if bypass_vq:
        q_sum, buf = latents, [latents, latents, latents]
    recon = synthesize(p["dec"], q_sum, timbre)
    wav_l1 = (recon - wav).abs().mean()
    mel_l1 = (mel_spectrogram(recon[:, :, 0]) - mel_spectrogram(wav[:, :, 0])).abs().mean()
    fine = {"n_fft": 256, "num_mels": 40, "hop_size": 50, "win_size": 200}
    mel_l1 = mel_l1 + (mel_spectrogram(recon[:, :, 0], **fine)
                       - mel_spectrogram(wav[:, :, 0], **fine)).abs().mean()
    # scale-invariant CE heads: normalized features, a fixed logit scale
    tf = buf[1].shape[1]
    phone_logits = 8.0 * (_norm(buf[1]) @ _norm(p["heads"]["phone_w"].t()).t())
    phone_ce = _smoothed_ce(phone_logits, lab[:, :tf])
    spk_logits = 8.0 * (_norm(timbre) @ _norm(p["heads"]["spk_w"].t()).t())
    spk_ce = _smoothed_ce(spk_logits, spk)
    commit_loss = commit.sum()
    # the system is scale-invariant in the latents: pin their log-RMS
    lat_rms = torch.sqrt(torch.mean(latents ** 2) + 1e-12)
    lat_reg = torch.log(lat_rms) ** 2
    total = (weights["mel"] * mel_l1 + weights["wav"] * wav_l1 + weights["commit"] * commit_loss
             + weights["phone"] * phone_ce + weights["spk"] * spk_ce + weights["latreg"] * lat_reg)
    with torch.no_grad():
        usage = torch.stack([torch.bincount(c.reshape(-1).long(), minlength=1024).gt(0).sum()
                             for c in codes])
        metrics = {"mel_l1": mel_l1, "wav_l1": wav_l1, "commit": commit_loss, "phone_ce": phone_ce,
                   "spk_ce": spk_ce, "total": total, "lat_rms": lat_rms,
                   "phone_acc": (phone_logits.argmax(-1) == lab[:, :tf]).float().mean(),
                   "spk_acc": (spk_logits.argmax(-1) == spk).float().mean(), "code_usage": usage}
    return total, {k: v.detach() for k, v in metrics.items()}


def cosine_schedule(peak: float, warmup: int, steps: int, end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, steps,
    end_value): count -> learning rate."""
    decay = steps - warmup
    alpha = 0.0 if peak == 0.0 else end_value / peak

    def schedule(count: int) -> float:
        if count < warmup:
            return -peak * (1.0 - count / warmup) + peak
        c = min(count - warmup, decay)
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay)) + alpha)

    return schedule


def warmup_cosine_decay(lr: float, steps: int):
    """The codec trainer's schedule: warmup max(min(300, steps // 10), 1),
    then a cosine decay to 0.05 lr at ``steps``."""
    return cosine_schedule(lr, max(min(300, steps // 10), 1), steps, 0.05 * lr)


class FiniteAdam:
    """``optax.apply_if_finite(chain(clip_by_global_norm(max_norm),
    adamw(schedule, weight_decay=weight_decay)), max_consecutive_errors=inf)``
    over a list of tensors (``adam`` at weight_decay 0), updated in place: a
    step whose gradients hold a non-finite value changes nothing
    (parameters, moments, counts) and adds one to ``notfinite_count`` (reset
    by the next finite step).  The clip is optax's: g * max_norm / ||g||
    where ||g|| >= max_norm, no epsilon; the decay is optax's, lr * wd * p
    on every parameter.  With ``if_finite=False`` it is the chain alone
    (no ``apply_if_finite``): every step is applied, as ``tools/train_g2p.py``
    builds it."""

    def __init__(self, params: List[torch.Tensor], schedule, max_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 if_finite: bool = True):
        self.params, self.schedule, self.max_norm = params, schedule, max_norm
        self.if_finite = if_finite
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0  # applied updates
        self.notfinite_count = 0
        self.total_notfinite = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> bool:
        """Apply one update; False where it was skipped."""
        if self.if_finite and not bool(torch.stack([torch.isfinite(g).all() for g in grads]).all()):
            self.notfinite_count += 1
            self.total_notfinite += 1
            return False
        self.notfinite_count = 0
        g_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(g_norm < self.max_norm, torch.ones_like(g_norm), self.max_norm / g_norm)
        grads = torch._foreach_mul(grads, scale)
        torch._foreach_lerp_(self.mu, grads, 1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, 1.0 - self.b2)
        lr = self.schedule(self.count)
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        return True


def train_step(params: Dict, opt: FiniteAdam, wav, lab, spk, n_q, weights: Dict[str, float],
               bypass_vq: bool = False) -> Dict[str, torch.Tensor]:
    """One update (or a skipped one) on a batch on the parameters' device;
    returns ``loss_fn``'s metrics."""
    flat = leaves(params)
    total, metrics = loss_fn(params, wav, lab, spk, n_q, weights, bypass_vq)
    grads = torch.autograd.grad(total, flat, allow_unused=True)
    opt.step([torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)])
    return metrics


@torch.no_grad()
def layer_z_e(p: Dict, wav: torch.Tensor):
    """Each of the six FVQ layers' whitened z_e (6, B*T, 8) and the codes
    they select (6, B*T), through the RVQ groups as ``analyze_train``
    runs them: the pool dead-code revival samples from."""
    latents = encoder_forward(p["enc"], wav)
    zs, cs, buf = [], [], []
    for gi in range(3):
        residual = latents if gi < 2 else latents - buf[0] - buf[1]
        g_sum = 0.0
        for layer in p["dec"]["quantizers"][gi]:
            z_e = _whiten_sg(linear(residual, layer["in_proj"]))
            code, _ = _nearest(z_e, layer["codebook"])
            zs.append(z_e.reshape(-1, z_e.shape[-1]))
            cs.append(code.reshape(-1))
            q = linear(layer["codebook"][code.long()], layer["out_proj"])
            residual = residual - q
            g_sum = g_sum + q
        buf.append(g_sum)
    return torch.stack(zs), torch.stack(cs)


@torch.no_grad()
def revive_dead_codes(p: Dict, wav_b: np.ndarray, rng_np: np.random.RandomState) -> List[int]:
    """Codebook rows no frame of ``wav_b`` selects take random z_e samples
    of that batch, scaled to the live rows' mean norm (dead-code restart);
    returns the rows revived per layer.  Skipped (no draw) where the z_e
    pool is not finite."""
    dev = p["enc"]["stem"]["w"].device
    zs, cs = (t.cpu().numpy() for t in layer_z_e(p, torch.as_tensor(wav_b, device=dev)))
    if not np.isfinite(zs).all():
        print("  [revive] non-finite z_e pool; skipping this revival", flush=True)
        return [0] * 6
    n_revived = []
    for li, layer in enumerate(l for g in p["dec"]["quantizers"] for l in g):
        cb = layer["codebook"].detach().cpu().numpy().astype(np.float32)
        used = np.zeros(cb.shape[0], bool)
        used[cs[li]] = True
        dead = np.where(~used)[0]
        if len(dead) == 0:
            n_revived.append(0)
            continue
        pool = zs[li]
        pick = pool[rng_np.randint(len(pool), size=len(dead))]
        live_norm = float(np.linalg.norm(cb[used], axis=-1).mean()) if used.any() else 1.0
        pick_n = pick / (np.linalg.norm(pick, axis=-1, keepdims=True) + 1e-9)
        cb = cb.copy()
        cb[dead] = pick_n * live_norm + 0.01 * rng_np.randn(len(dead), cb.shape[1])
        layer["codebook"].copy_(torch.as_tensor(cb))
        n_revived.append(len(dead))
    return n_revived


def _probe_latents(p: Dict, batches) -> np.ndarray:
    dev = p["enc"]["stem"]["w"].device
    with torch.no_grad():
        lat = np.concatenate([encoder_forward(p["enc"], torch.as_tensor(b, device=dev)).cpu().numpy()
                              for b in batches])
    return lat.reshape(-1, lat.shape[-1]).astype(np.float64)


def _fold_layer(layer: Dict, residual: np.ndarray):
    """Fold the whitening of ``layer``'s z_e over ``residual`` into its
    in_proj (float64); returns (folded w, folded b, whitened z)."""
    w_in = layer["in_proj"]["w"].detach().cpu().numpy().astype(np.float64)
    b_in = layer["in_proj"]["b"].detach().cpu().numpy().astype(np.float64)
    w_in, b_in = whitening_fold(w_in, b_in, residual @ w_in.T + b_in)
    return w_in, b_in, residual @ w_in.T + b_in


def _cosine_codes(z: np.ndarray, cb: np.ndarray) -> np.ndarray:
    zn = z / np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), 1e-9)
    cn = cb / np.maximum(np.linalg.norm(cb, axis=-1, keepdims=True), 1e-9)
    return np.argmax(zn @ cn.T, axis=-1)


def _quantized(layer: Dict, cb: np.ndarray, codes: np.ndarray) -> np.ndarray:
    w_out = layer["out_proj"]["w"].detach().cpu().numpy().astype(np.float64)
    b_out = layer["out_proj"]["b"].detach().cpu().numpy().astype(np.float64)
    return cb[codes] @ w_out.T + b_out


@torch.no_grad()
def init_vq_from_data(p: Dict, batches, rng_np: np.random.RandomState) -> None:
    """Data-dependent VQ initialisation, through the RVQ groups in order:
    each layer's in_proj folds in the whitening of its z_e on the probe
    ``batches``' latents, and its codebook is seeded with whitened z_e
    samples (scaled to their mean norm), so that the whole codebook is live
    from the first step."""
    x = _probe_latents(p, batches)
    group_sums = []
    for gi, group in enumerate(p["dec"]["quantizers"]):
        residual = x if gi < 2 else x - (group_sums[0] + group_sums[1])
        gsum = 0.0
        for layer in group:
            w_in, b_in, z = _fold_layer(layer, residual)
            layer["in_proj"]["w"].copy_(torch.as_tensor(w_in.astype(np.float32)))
            layer["in_proj"]["b"].copy_(torch.as_tensor(b_in.astype(np.float32)))
            k = layer["codebook"].shape[0]
            pick = z[rng_np.permutation(len(z))[:k]]
            if len(pick) < k:
                pick = np.concatenate([pick, 0.1 * rng_np.randn(k - len(pick), z.shape[1])])
            norms = np.linalg.norm(pick, axis=-1, keepdims=True)
            pick = pick / np.maximum(norms, 1e-9) * max(float(norms.mean()), 1e-3)
            layer["codebook"].copy_(torch.as_tensor(pick.astype(np.float32)))
            codes = _cosine_codes(z, pick)
            q = _quantized(layer, pick, codes)
            residual = residual - q
            gsum = gsum + q
            print(f"  vq-init group {gi}: {len(np.unique(codes))} live codes "
                  f"on {len(codes)} probe frames", flush=True)
        group_sums.append(gsum)


def save(p: Dict, out_dir: str, batches) -> None:
    """Write the checkpoints with the training-time whitening folded into
    each in_proj (float64, through the RVQ groups in order, on the probe
    ``batches``' latents), so that the plain inference path
    (``quantize.fvq_encode``, no whitening) selects the same codes.  The
    live parameters are not changed."""
    host = params_to_jax(p)
    x = _probe_latents(p, batches)
    sums = []
    for gi, group in enumerate(p["dec"]["quantizers"]):
        residual = x if gi < 2 else x - (sums[0] + sums[1])
        gsum = 0.0
        for li, layer in enumerate(group):
            w_in, b_in, z = _fold_layer(layer, residual)
            host["dec"]["quantizers"][gi][li]["in_proj"] = {"w": w_in.astype(np.float32),
                                                            "b": b_in.astype(np.float32)}
            cb = layer["codebook"].detach().cpu().numpy().astype(np.float64)
            q = _quantized(layer, cb, _cosine_codes(z, cb))
            residual = residual - q
            gsum = gsum + q
        sums.append(gsum)
    save_pytree_npz(os.path.join(out_dir, "ns3_facodec_encoder.npz"), host["enc"])
    save_pytree_npz(os.path.join(out_dir, "ns3_facodec_decoder.npz"), host["dec"])
    save_pytree_npz(os.path.join(out_dir, "train_heads.npz"), host["heads"])


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--corpus", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--crop-frames", type=int, default=160,
                        help="Training crop length in code frames (static shape).")
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--save-every", type=int, default=1000)
    parser.add_argument("--quantizer-dropout", type=float, default=0.25)
    parser.add_argument("--revive-every", type=int, default=50, help="Dead-code revival interval (steps).")
    parser.add_argument("--bypass-vq", action="store_true",
                        help="Diagnostic: decoder reconstructs from raw latents (no quantization).")
    parser.add_argument("--holdout-speakers", default="",
                        help="Comma-separated speaker ids excluded from all codec training.")
    parser.add_argument("--w-mel", type=float, default=1.0)
    parser.add_argument("--w-wav", type=float, default=10.0)
    parser.add_argument("--w-commit", type=float, default=1.0)
    parser.add_argument("--w-phone", type=float, default=2.0)
    parser.add_argument("--w-spk", type=float, default=1.0)
    parser.add_argument("--w-latreg", type=float, default=1.0, help="latent log-RMS^2 scale pin")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Runs the trainer; returns {"params", "opt", "step_s" (wall seconds
    of each step, host clock, ending where the step's skip check reads the
    device)}.  Exits 1 where the parameters turn non-finite or
    ``MAX_SKIPS`` updates in a row are skipped."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    holdout = set(s for s in args.holdout_speakers.split(",") if s)
    t0 = time.time()
    wavs, labels, spks, n_speakers, n_held = load_corpus(args.corpus, holdout)
    total_s = sum(len(w) for w in wavs) / SR
    print(f"corpus: {len(wavs)} utterances ({total_s / 60:.1f} min), {n_speakers} train speakers, "
          f"{n_held} held-out utts excluded ({time.time() - t0:.0f}s)", flush=True)
    rng_np = np.random.RandomState(args.seed)

    def batch():
        return make_batch(rng_np, wavs, labels, spks, args.batch, args.crop_frames)

    params = tree_map(lambda t: t.to(device).requires_grad_(),
                      init_params(torch.Generator().manual_seed(args.seed), n_speakers))
    flat = leaves(params)
    print(f"codec params: {sum(t.numel() for t in flat) / 1e6:.1f} M", flush=True)
    init_vq_from_data(params, [batch()[0] for _ in range(4)], rng_np)
    # no weight decay: shrinking codebooks and Snake log-scales distorts
    # the VQ geometry; skipped non-finite updates are counted, and the run
    # stops after MAX_SKIPS in a row, with the parameters still finite
    opt = FiniteAdam(flat, warmup_cosine_decay(args.lr, args.steps))
    weights = {k: getattr(args, f"w_{k}") for k in LOSS_WEIGHTS}
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    n_layers = [len(g) for g in params["dec"]["quantizers"]]

    os.makedirs(args.out_dir, exist_ok=True)
    step_s: List[float] = []
    t0 = time.time()
    last_t, last_step = t0, 0
    with open(os.path.join(args.out_dir, "metrics.jsonl"), "a", encoding="utf-8") as mf:
        for step in range(1, args.steps + 1):
            t_step = time.perf_counter()
            wav_b, lab_b, spk_b = batch()
            n_q = [quantizer_counts(args.batch, n, args.quantizer_dropout, generator, device)
                   for n in n_layers]
            metrics = train_step(params, opt, torch.as_tensor(wav_b, device=device),
                                 torch.as_tensor(lab_b, device=device),
                                 torch.as_tensor(spk_b, device=device), n_q, weights, args.bypass_vq)
            step_s.append(time.perf_counter() - t_step)
            if step % args.log_every == 0 or step == 1:
                m = {k: v.cpu().numpy() for k, v in metrics.items()}
                if not np.isfinite(float(m["total"])):
                    bad = [i for i, t in enumerate(flat) if not bool(torch.isfinite(t).all())]
                    if bad:
                        print(f"[FATAL] non-finite loss at step {step}; non-finite params: "
                              f"{bad[:8]} (leaf indices)", flush=True)
                        sys.exit(1)
                    bad_terms = [k for k, v in m.items()
                                 if k != "code_usage" and not np.isfinite(float(np.asarray(v).sum()))]
                    nf = opt.notfinite_count
                    print(f"  [warn] non-finite loss terms at step {step} ({bad_terms}); params "
                          f"finite, update skipped (consecutive skips: {nf})", flush=True)
                    if nf >= MAX_SKIPS:
                        save(params, args.out_dir, [batch()[0] for _ in range(4)])
                        print(f"[FATAL] {nf} consecutive skipped updates — training cannot "
                              f"progress; params saved", flush=True)
                        sys.exit(1)
                    continue
                now = time.time()
                sps = (step - last_step) / max(now - last_t, 1e-9)
                last_t, last_step = now, step
                row = {k: round(float(v), 4) for k, v in m.items() if k != "code_usage"}
                row.update(step=step, steps_per_sec=round(sps, 2),
                           code_usage=[int(x) for x in m["code_usage"]])
                mf.write(json.dumps(row) + "\n")
                mf.flush()
                print(f"step {step}/{args.steps} total={row['total']:.3f} mel={row['mel_l1']:.3f} "
                      f"wav={row['wav_l1']:.4f} phone_acc={row['phone_acc']:.3f} "
                      f"spk_acc={row['spk_acc']:.3f} usage={row['code_usage']} ({sps:.2f} it/s)",
                      flush=True)
            if step % args.revive_every == 0 and step < args.steps - 200:
                n_rev = revive_dead_codes(params, wav_b, rng_np)
                if sum(n_rev) and step % args.log_every == 0:
                    print(f"  revived dead codes: {n_rev}", flush=True)
            if step % args.save_every == 0 or step == args.steps:
                save(params, args.out_dir, [batch()[0] for _ in range(4)])
    print(f"done in {(time.time() - t0) / 60:.1f} min -> {args.out_dir}", flush=True)
    return {"params": params, "opt": opt, "step_s": step_s}


if __name__ == "__main__":
    main()
