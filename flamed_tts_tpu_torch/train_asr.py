"""Train the framewise phone recognizer (``asr.py``) on a fabricated corpus.

    python -m flamed_tts_tpu_torch.train_asr --corpus corpus --out asr.npz \\
        [--epochs 30] [--batch 16] [--lr 2e-3] [--train-on clean|decoded] \\
        [--decoded-cache decoded | --codec-dir random|DIR] [--device cuda|cpu]

The supervision is the corpus's exact alignments (``fabricate_corpus``'s
TextGrids): each 80-fps log-mel frame gets the phone of its interval,
in chunks of CHUNK frames; the first tenth of the utterances (at least two)
is the validation set.  ``--train-on decoded`` adds each utterance's codec
round trip (from ``--decoded-cache``, written by ``dump_decoded``, or from a
codec in the process), the output domain of synthesis.

As the JAX package's ``tools/train_asr.py``: the loss (label smoothing
0.95 / 0.05 over N_CLASSES, masked to labelled frames, plus 0.5 x the
speaker head's cross-entropy on 8 x embedding @ spk_cls where the corpus
has speakers), optax's ``chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(0, lr, min(200, total // 10), total),
weight_decay=1e-4))`` (``train_codec.FiniteAdam``, which also skips a
non-finite update), the batch order from ``RandomState(seed + 1)``, the
validation frame accuracy, the speaker accuracy and the closing
free-decoding WER on the validation utterances.  ``--out`` has no default:
the trainer writes no weights into either package.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from flamed_tts_tpu_torch import asr
from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.ops.melspec import mel_spectrogram
from flamed_tts_tpu_torch.train_codec import FiniteAdam, cosine_schedule, leaves, tree_map

CHUNK = 512  # frames per training example (6.4 s)


def load_corpus(corpus_dir: str, holdout=()):
    """([(wav_path, spans, spk_id)], n_speakers) from fab_manifest.txt and,
    where the fabricator wrote it, speakers.txt (spk_id -1 otherwise).  The
    utterances of a speaker in ``holdout`` are left out."""
    from flamed_tts_tpu_torch.utils.textgrid import get_tier

    holdout = set(holdout)
    spk_of = {}
    spk_path = os.path.join(corpus_dir, "speakers.txt")
    if os.path.isfile(spk_path):
        with open(spk_path, encoding="utf-8") as fin:
            for line in fin:
                if "|" in line:
                    stem, s = line.strip().split("|", 1)
                    spk_of[stem] = s
    spk_ids = {s: i for i, s in enumerate(sorted(set(spk_of.values()) - holdout))}
    items = []
    with open(os.path.join(corpus_dir, "fab_manifest.txt"), encoding="utf-8") as fin:
        for line in fin:
            parts = line.strip().split("|")
            if len(parts) < 3:
                continue
            wav_path, tg_path = parts[0], parts[1]
            stem = os.path.splitext(os.path.basename(wav_path))[0]
            if spk_of.get(stem) in holdout:
                continue
            spans = [(int(round(iv.start_time * 80)), int(round(iv.end_time * 80)),
                      asr.phone_label(iv.text)) for iv in get_tier(tg_path, "phones")]
            items.append((wav_path, spans, spk_ids.get(spk_of.get(stem), -1)))
    return items, len(spk_ids)


def featurize(items, codec=None, decoded_cache: Optional[str] = None, log=print,
              device: Union[str, torch.device, None] = None):
    """-> (mels (N, CHUNK, 80), labels (N, CHUNK), spks (N,)) numpy chunks,
    the log-mel computed on ``device``; labels -1 past an utterance's end."""
    from flamed_tts_tpu_torch.utils.audio import load_wav

    device = resolve_device(device)
    mels, labels, spks = [], [], []
    for idx, (wav_path, spans, spk_id) in enumerate(items):
        wav = load_wav(wav_path)
        versions = [wav]
        if decoded_cache is not None:
            stem = os.path.splitext(os.path.basename(wav_path))[0]
            cached = os.path.join(decoded_cache, f"{stem}.wav")
            if os.path.isfile(cached):
                versions.append(load_wav(cached))
        elif codec is not None:
            versions.append(codec.round_trip(wav))
        n_frames = spans[-1][1]
        lab = np.zeros(n_frames, np.int32)
        for a, b, cid in spans:
            lab[a:b] = cid
        for v in versions:
            # a reflection to the whole-second grid, as the JAX trainer pads
            # (the recognizer pads with zeros: asr.py's docstring)
            v_pad = np.pad(v, (0, (-len(v)) % asr.SR), mode="reflect")
            mel = mel_spectrogram(torch.as_tensor(v_pad, device=device)[None])[0].T
            mel = mel[: len(v) // asr.HOP].cpu().numpy()
            t = min(mel.shape[0], n_frames)
            for start in range(0, t, CHUNK):
                seg_m, seg_l = mel[start: start + CHUNK], lab[start: start + CHUNK]
                if len(seg_m) < CHUNK // 4:
                    continue
                pad = CHUNK - len(seg_m)
                mels.append(np.pad(seg_m, ((0, pad), (0, 0))))
                labels.append(np.pad(seg_l, (0, pad), constant_values=-1))
                spks.append(spk_id)
        if idx % 50 == 49:
            log(f"  featurized {idx + 1}/{len(items)}")
    return (np.stack(mels).astype(np.float32), np.stack(labels).astype(np.int32),
            np.asarray(spks, np.int32))


def loss_fn(p: Dict, mel: torch.Tensor, lab: torch.Tensor, spk: torch.Tensor) -> torch.Tensor:
    """Label-smoothed frame cross-entropy over the labelled frames, plus
    0.5 x the speaker head's cross-entropy where ``p`` has the head.  The
    trunk runs once for both heads."""
    h = asr.trunk(p, mel)
    valid = (lab >= 0).float()
    logp = F.log_softmax(asr.phone_head(p, h), dim=-1)
    onehot = F.one_hot(lab.clamp(min=0).long(), asr.N_CLASSES).float()
    ce = -((0.95 * onehot + 0.05 / asr.N_CLASSES) * logp).sum(-1)
    loss = (ce * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    if "spk_w" in p:
        emb = asr.speaker_head(p, h, valid)
        slogp = F.log_softmax(8.0 * (emb @ p["spk_cls"]), dim=-1)
        ok = (spk >= 0).float()
        sce = -torch.gather(slogp, -1, spk.clamp(min=0).long()[:, None])[:, 0]
        loss = loss + 0.5 * (sce * ok).sum() / torch.clamp(ok.sum(), min=1.0)
    return loss


def make_optimizer(p: Dict, lr: float, total: int) -> FiniteAdam:
    """The JAX tool's chain over ``p``'s tensors (``leaves`` order)."""
    return FiniteAdam(leaves(p), cosine_schedule(lr, min(200, total // 10), total),
                      weight_decay=1e-4)


def train_step(p: Dict, opt: FiniteAdam, mel: torch.Tensor, lab: torch.Tensor,
               spk: torch.Tensor) -> torch.Tensor:
    """One update of ``p`` (tensors that require grad) in place; returns
    the loss before it."""
    loss = loss_fn(p, mel, lab, spk)
    opt.step(list(torch.autograd.grad(loss, opt.params)))
    return loss.detach()


@torch.no_grad()
def accuracy(p: Dict, mel: torch.Tensor, lab: torch.Tensor):
    """(frames right, labelled frames) of a batch."""
    pred = asr.forward(p, mel).argmax(-1)
    valid = lab >= 0
    return int(((pred == lab) & valid).sum()), int(valid.sum())


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--corpus", required=True)
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--valid-every", type=int, default=10)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--train-on", default="clean", choices=["clean", "decoded"])
    parser.add_argument("--codec-dir", default="random")
    parser.add_argument("--decoded-cache", default=None,
                        help="Dir of round-trip wavs (dump_decoded); used with --train-on "
                             "decoded instead of a codec in the process.")
    parser.add_argument("--holdout-speakers", default="",
                        help="Comma-separated speaker ids excluded from training entirely "
                             "(eval on unseen voices).")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", required=True, help="The weights file to write (.npz).")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Trains, saves and reports; returns {"params" (numpy), "epoch_loss"
    (mean loss of each epoch), "valid_acc" ([(epoch, frame accuracy)]),
    "valid_sil_share", "spk_acc", "wer", "step_s" (host seconds of each
    step, each ending in the optimizer's host read), "step_frames"
    (labelled frames of each step's batch)}."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    codec = None
    if args.train_on == "decoded" and not args.decoded_cache:
        from flamed_tts_tpu_torch.config import load_default_config
        from flamed_tts_tpu_torch.synthesize import get_codec

        codec = get_codec(load_default_config(), args.codec_dir, device)

    items, n_speakers = load_corpus(args.corpus,
                                    holdout=[s for s in args.holdout_speakers.split(",") if s])
    n_valid = max(len(items) // 10, 2)
    valid_items, train_items = items[:n_valid], items[n_valid:]
    print(f"corpus: {len(train_items)} train / {n_valid} valid utterances, {n_speakers} speakers")
    t0 = time.time()
    cache = args.decoded_cache if args.train_on == "decoded" else None
    mels, labels, spk_labels = featurize(train_items, codec, cache, device=device)
    vmels, vlabels, vspk = featurize(valid_items, codec, cache, device=device)
    print(f"features: train {mels.shape} valid {vmels.shape} ({time.time() - t0:.0f}s)")

    params = tree_map(lambda t: t.requires_grad_(), asr.to_tensors(
        asr.init_params(np.random.RandomState(args.seed),
                        n_speakers=n_speakers if n_speakers >= 2 else None), device))
    n = mels.shape[0]
    steps_per_epoch = max(n // args.batch, 1)
    total = steps_per_epoch * args.epochs
    opt = make_optimizer(params, args.lr, total)
    valid_sil = float((vlabels == asr.SIL).sum() / max((vlabels >= 0).sum(), 1))

    rng = np.random.RandomState(args.seed + 1)
    epoch_loss, valid_acc, step_s, step_frames = [], [], [], []
    for epoch in range(args.epochs):
        order = rng.permutation(n)
        losses = []
        for b in range(steps_per_epoch):
            idx = order[b * args.batch: (b + 1) * args.batch]
            if len(idx) < args.batch:
                idx = np.concatenate([idx, order[: args.batch - len(idx)]])
            t_step = time.perf_counter()
            losses.append(train_step(params, opt, torch.as_tensor(mels[idx], device=device),
                                     torch.as_tensor(labels[idx], device=device),
                                     torch.as_tensor(spk_labels[idx], device=device)))
            step_s.append(time.perf_counter() - t_step)
            step_frames.append(int((labels[idx] >= 0).sum()))
        epoch_loss.append(float(torch.stack(losses).mean()))
        if (epoch + 1) % args.valid_every == 0 or epoch in (0, args.epochs - 1):
            hits = tot = 0
            for b in range(0, len(vmels), args.batch):
                vm, vl = vmels[b: b + args.batch], vlabels[b: b + args.batch]
                if len(vm) < args.batch:  # the JAX tool's static shapes
                    pad = args.batch - len(vm)
                    vm = np.concatenate([vm, np.zeros_like(vm[:1]).repeat(pad, 0)])
                    vl = np.concatenate([vl, np.full_like(vl[:1], -1).repeat(pad, 0)])
                h, t = accuracy(params, torch.as_tensor(vm, device=device),
                                torch.as_tensor(vl, device=device))
                hits += h
                tot += t
            valid_acc.append((epoch + 1, hits / max(tot, 1)))
            print(f"epoch {epoch + 1}/{args.epochs} loss={epoch_loss[-1]:.4f} "
                  f"valid-frame-acc={hits / max(tot, 1):.4f} ({time.time() - t0:.0f}s)", flush=True)

    final = asr.to_numpy(params)
    asr.save_weights(final, args.out)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    print(f"valid frames: {100 * valid_sil:.1f} % silence (class {asr.SIL})")

    spk_acc = None
    if "spk_w" in final and len(vmels):
        with torch.no_grad():
            emb = asr.speaker_embed(params, torch.as_tensor(vmels, device=device),
                                    torch.as_tensor(vlabels >= 0, device=device))
            pred = (emb @ params["spk_cls"]).argmax(-1).cpu().numpy()
        ok = vspk >= 0
        spk_acc = float((pred[ok] == vspk[ok]).mean()) if ok.any() else float("nan")
        print(f"valid speaker-classification acc: {spk_acc:.4f} (n={int(ok.sum())}, "
              f"{n_speakers} speakers)")

    # free decoding of the validation utterances, words scored by class
    from flamed_tts_tpu_torch.evaluate import word_error_rate
    from flamed_tts_tpu_torch.utils.audio import load_wav

    rec = asr.PhonemeRecognizer(args.out, device=device)
    with open(os.path.join(args.corpus, "fab_manifest.txt"), encoding="utf-8") as fin:
        lines = [ln.strip().split("|") for ln in fin if ln.strip()]
    valid_wavs = {w for w, _, _ in valid_items}
    lines = [ln for ln in lines if ln[0] in valid_wavs]
    wers = []
    for wav_path, _, text in lines[:n_valid]:
        _, hyp = rec.transcribe(load_wav(wav_path))
        wers.append(word_error_rate(text, hyp, canon=rec.canon))
    print(f"valid free-decoding WER on clean audio: {np.mean(wers):.4f} (n={len(wers)})")
    return {"params": final, "epoch_loss": epoch_loss, "valid_acc": valid_acc,
            "valid_sil_share": valid_sil, "spk_acc": spk_acc, "wer": float(np.mean(wers)),
            "step_s": step_s, "step_frames": step_frames}


if __name__ == "__main__":
    main()
