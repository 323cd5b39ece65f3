"""Throughput benchmark of the port: batched multi-prompt generation at the
high-fidelity operating point (nsteps-denoiser 128, nsteps-durgen 16).

    python -m flamed_tts_tpu_torch.bench_throughput [--device cuda|cpu]

Prints one JSON line with the keys of the repository's root
``bench_throughput.py``: ``{"metric": "rtf_batch{B}_nfe{N}", "value": R,
"unit": "rtf", "vs_baseline": 0.05 / R}``, R = mean time a batch / mean
audio seconds a batch (audio seconds = the sum of the batch's tgt_len / 80
frames a second).  ``BENCH_BATCH`` (default 4) utterances of eight fixed
texts go through ``Flamed.sample_batch`` with distinct sine prompts, each
encoded once by ``codec.encode_prompt`` (the prompt-feature cache of the
metadata mode); the model's parameters are rounded to bfloat16 and the
durations pinned as in ``bench.py``.  ``BENCH_NFE`` sets nsteps-denoiser
(default 128).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flamed_tts_tpu_torch import bench
from flamed_tts_tpu_torch.config import load_default_config
from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.flamed import Flamed

NSTEPS_DURGEN = 16  # the README's high-fidelity operating point
FRAMES_PER_SECOND = 80.0
TEXTS = [
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "A journey of a thousand miles begins with a single small step forward.",
    "Science is a way of thinking much more than it is a body of knowledge.",
    "In the middle of difficulty lies opportunity for those who seek it out.",
    "The committee will reconvene tomorrow morning to review the final draft.",
    "Bright autumn leaves drifted slowly across the quiet village square.",
    "Seventeen students volunteered to organize the charity concert this year.",
    "He carefully measured each ingredient before starting the experiment.",
]


def batch_texts(batch: int) -> List[str]:
    """``batch`` texts: the eight above, repeated as needed."""
    return (TEXTS * ((batch + len(TEXTS) - 1) // len(TEXTS)))[:batch]


def batch_phonemes(model: Flamed, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(phonemes (B, max L) zero-padded, src_lens (B,)) through the model's
    text frontend."""
    frontend = model._get_frontend()
    rows = [frontend(t)[0][0] for t in texts]
    src_lens = np.asarray([len(p) for p in rows], np.int64)
    phonemes = np.zeros((len(rows), int(src_lens.max())), np.int64)
    for i, p in enumerate(rows):
        phonemes[i, : len(p)] = p
    return phonemes, src_lens


def prompt_wavs(batch: int) -> List[np.ndarray]:
    """Distinct 3 s sines at 0.1 amplitude, 180 + 40 i Hz."""
    t_axis = np.arange(3 * 16000) / 16000.0
    return [(0.1 * np.sin(2 * np.pi * (180 + 40 * i) * t_axis)).astype(np.float32)
            for i in range(batch)]


def encode_prompts(codec: FaCodec, wavs: Sequence[np.ndarray], vocab_size: int):
    """Each prompt encoded once: (prompts (B, n_q, max P) padded with
    ``vocab_size``, prompt_lens (B,), timbres (B, 256))."""
    codes, timbres = zip(*(codec.encode_prompt(w) for w in wavs))
    p_lens = np.asarray([c.shape[-1] for c in codes], np.int64)
    prompts = np.full((len(codes), codes[0].shape[0], int(p_lens.max())), vocab_size, np.int64)
    for i, c in enumerate(codes):
        prompts[i, :, : c.shape[-1]] = c
    return prompts, p_lens, np.stack(timbres)


def audio_seconds(tgt_len) -> float:
    return sum(int(n) for n in tgt_len) / FRAMES_PER_SECOND


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Runs the benchmark and prints its line; returns {"report", "times",
    "seconds"}."""
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.bench_throughput",
                                     description="Batched RTF at nfe 128 (port).")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    batch = int(os.environ.get("BENCH_BATCH", "4"))
    nfe = int(os.environ.get("BENCH_NFE", "128"))
    metric = f"rtf_batch{batch}_nfe{nfe}"
    if args.device == "cuda":
        bench.probe_gpu(metric)
    device = resolve_device(args.device)

    # the root script rounds the model's parameters, not the codec's
    model, codec = bench.build(load_default_config(), "bf16", device, cast_codec=False)
    phonemes, src_lens = batch_phonemes(model, batch_texts(batch))
    prompts, p_lens, timbres = encode_prompts(codec, prompt_wavs(batch), model.vocab_size)

    def run(seed: int) -> Dict:
        return model.sample_batch(phonemes=phonemes, src_lens=src_lens, prompts=prompts,
                                  prompt_lens=p_lens, timbres=timbres, codec=codec,
                                  nsteps_durgen=NSTEPS_DURGEN, nsteps_denoiser=nfe, seed=seed)

    bench.warm(run)
    times, seconds = [], []
    for seed in range(1, 4):
        # sample_batch ends in host reads and a synchronize
        t0 = time.perf_counter()
        out = run(seed)
        times.append(time.perf_counter() - t0)
        seconds.append(audio_seconds(out["tgt_len"]))
    rtf = float(np.mean(times) / np.mean(seconds))
    print(f"[bench_throughput] batch={batch} audio/batch={np.mean(seconds):.2f}s "
          f"time/batch={np.mean(times):.3f}s (each {[round(t, 4) for t in times]})", file=sys.stderr)
    line = {"metric": metric, "value": round(rtf, 5), "unit": "rtf",
            "vs_baseline": round(bench.TARGET_RTF / rtf, 3)}
    print(json.dumps(line), flush=True)
    return {"report": line, "times": times, "seconds": seconds}


if __name__ == "__main__":
    main()
