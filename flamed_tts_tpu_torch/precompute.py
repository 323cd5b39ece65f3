"""Precompute a training set: wav + TextGrid -> per-utterance .npz.

    python -m flamed_tts_tpu_torch.precompute --manifest in.txt --out-dir data \\
        --codec-dir artifacts/codec_r5 [--device cuda|cpu]

For every manifest line ``wav_path|textgrid_path|transcript`` it runs the
FaCodec analysis (encoder -> RVQ codes -> summed code embeddings, and the
timbre), on the card through the Snake (K1) and residual-unit (K2)
kernels, reads the phone and silence durations from the TextGrid's
"phones" tier, and writes ``out_dir/<stem>.npz`` with

    phoneme (L,) int32, code (6, Lf) int32, emb (Lf, 256) float32,
    spk (256,) float32, phone_dur, sil_dur (L,) int32

and ``manifest.txt`` lines ``<stem>.npz|<seconds>|<transcript>``, split into
``valid_manifest.txt`` (the head) and ``train_manifest.txt``: what the
trainer reads with ``use_precomputed: true``.  The wav is padded to a
seconds bucket (up to 17 s) as a prompt is, so an utterance's codes equal
the serving path's for the same wav.  An utterance whose .npz exists is
kept as it is (an interrupted run resumes).  The same flags as the JAX
package's ``tools/precompute_dataset.py``, with ``--device cuda`` (the
default) or ``cpu`` (the kernels' plain versions).  It leaves PyTorch's
TF32 switches as the caller set them (by default cuDNN runs the codec's
plain fp32 convolutions in TF32).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from flamed_tts_tpu_torch.data.dataset import compute_alignment
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.facodec.decoder import vq2emb
from flamed_tts_tpu_torch.text import text_to_sequence
from flamed_tts_tpu_torch.utils.audio import load_wav
from flamed_tts_tpu_torch.utils.textgrid import get_tier


@torch.no_grad()
def analyze_utterance(codec: FaCodec, wav: np.ndarray) -> Dict[str, np.ndarray]:
    """wav (T,) -> {"code" (6, Lf) int32, "emb" (Lf, 256), "spk" (256,)}."""
    codes, timbre = codec.encode_prompt(wav)
    emb = vq2emb(codec.dec_params, torch.as_tensor(codes[:, None, :], device=codec.device))
    return {"code": codes.astype(np.int32), "emb": emb[0].float().cpu().numpy(),
            "spk": np.asarray(timbre, dtype=np.float32)}


def precompute(lines: Sequence[str], out_dir: str, codec: FaCodec, sampling_rate: int = 16000,
               down_factor: int = 200, cleaners: Sequence[str] = ("english_cleaners",),
               valid_n: int = 18) -> Dict:
    """Write the .npz files and the three manifests for ``lines``; returns
    {"done", "failed", "audio_s", "seconds", "n_valid"}.  A line whose files
    cannot be read or parsed is skipped and counted as failed; a failure of
    the codec itself raises."""
    os.makedirs(out_dir, exist_ok=True)
    manifest_out = []
    n_failed, audio_s = 0, 0.0
    t0 = time.perf_counter()
    for line in lines:
        try:
            wav_path, tg_path, transcript = line.split("|", 2)
            stem = os.path.splitext(os.path.basename(wav_path))[0]
            rel = f"{stem}.npz"
            wav = load_wav(wav_path, sr=sampling_rate)
            phones, phone_dur, sil_dur = compute_alignment(get_tier(tg_path, "phones"),
                                                           sampling_rate, down_factor)
        except (OSError, ValueError, KeyError) as exc:
            print(f"[WARN] skipped {line.split('|')[0]}: {exc}")
            n_failed += 1
            continue
        duration = len(wav) / sampling_rate
        audio_s += duration
        path = os.path.join(out_dir, rel)
        if not os.path.isfile(path):
            phonemes = np.asarray(text_to_sequence("{" + " ".join(phones) + "}", cleaners),
                                  dtype=np.int32)
            np.savez(path, phoneme=phonemes, **analyze_utterance(codec, wav),
                     phone_dur=np.asarray(phone_dur, dtype=np.int32),
                     sil_dur=np.asarray(sil_dur, dtype=np.int32))
        manifest_out.append(f"{rel}|{duration:.3f}|{transcript}")

    n_valid = max(1, min(valid_n, len(manifest_out) // 5))
    for name, part in (("manifest.txt", manifest_out), ("valid_manifest.txt", manifest_out[:n_valid]),
                       ("train_manifest.txt", manifest_out[n_valid:])):
        with open(os.path.join(out_dir, name), "w", encoding="utf-8") as fout:
            fout.write("\n".join(part) + "\n")
    return {"done": len(manifest_out), "failed": n_failed, "audio_s": audio_s,
            "seconds": time.perf_counter() - t0, "n_valid": n_valid}


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.precompute",
                                     description="wav + TextGrid -> per-utterance .npz training "
                                                 "samples (FaCodec analysis on one NVIDIA GPU).")
    parser.add_argument("--manifest", required=True, help="Lines: wav_path|textgrid_path|transcript")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--codec-dir", required=True,
                        help="Converted codec .npz directory ('random' for smoke runs).")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default) or cpu (the kernels' plain PyTorch versions).")
    parser.add_argument("--valid-n", type=int, default=18,
                        help="Utterances for valid_manifest.txt (head of the list).")
    parser.add_argument("--sampling-rate", type=int, default=16000)
    parser.add_argument("--down-factor", type=int, default=200)
    parser.add_argument("--cleaners", nargs="+", default=["english_cleaners"])
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_arg_parser().parse_args(argv)
    if args.codec_dir == "random":
        codec = FaCodec.random_init(torch.Generator().manual_seed(0), device=args.device)
    else:
        codec = FaCodec.from_pretrained(args.codec_dir, device=args.device)
    with open(args.manifest, encoding="utf-8") as fin:
        lines = [ln.strip() for ln in fin if ln.strip()]
    stats = precompute(lines, args.out_dir, codec, args.sampling_rate, args.down_factor,
                       args.cleaners, args.valid_n)
    print(f"Precomputed {stats['done']} utterances ({stats['failed']} failed, "
          f"{stats['audio_s']:.1f} s of audio in {stats['seconds']:.1f} s) -> {args.out_dir} "
          f"(train {stats['done'] - stats['n_valid']} / valid {stats['n_valid']})")
    return stats


if __name__ == "__main__":
    main()
