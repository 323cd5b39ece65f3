"""A synthetic corpus in the layout the precompute step reads: voiced
16 kHz wavs, "phones" TextGrids whose phones come from the text frontend
and whose boundaries fall on whole code frames (200 samples), and a
``wav|textgrid|transcript`` manifest.  Made from a seed with numpy; for
smoke runs and tests, where no recorded corpus is at hand.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from flamed_tts_tpu_torch.utils.audio import save_wav
from flamed_tts_tpu_torch.utils.textgrid import write_textgrid

SR = 16000
HOP = 200
FPS = SR // HOP
SENTENCES = (
    "The quick brown fox jumps over the lazy dog.",
    "She sells sea shells by the sea shore every summer morning.",
    "A journey of a thousand miles begins with a single step.",
    "Bright stars were shining over the quiet mountain village tonight.",
)


def voiced_wav(n_samples: int, rng: np.random.RandomState, f0: float = 140.0) -> np.ndarray:
    """Five harmonics of a slowly moving f0 under a syllable-rate envelope,
    plus a little noise."""
    t = np.arange(n_samples) / SR
    f = f0 + 20.0 * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(f) / SR
    wav = sum(np.sin(k * phase) / k for k in range(1, 6)) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2)
    return (0.2 * wav + 0.01 * rng.randn(n_samples)).astype(np.float32)


def fabricate_corpus(out_dir: str, seconds: Sequence[float], seed: int = 0) -> str:
    """One utterance of about ``seconds[i]`` seconds each (at least 3
    words of ``SENTENCES``); returns the manifest's path."""
    from flamed_tts_tpu_torch.text.frontend import EnglishFrontend

    frontend = EnglishFrontend()
    words = [w.strip(".,").lower() for s in SENTENCES for w in s.split()]
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    manifest: List[str] = []
    for u, sec in enumerate(seconds):
        total = int(round(sec * FPS))
        lead, trail = int(rng.randint(4, 12)), int(rng.randint(4, 12))
        # words, cycling through the sentences from a random start, until
        # the phones average about 7 frames
        start, sent, phones = int(rng.randint(len(words))), [], []
        while len(sent) < 3 or len(phones) * 7 < total - lead - trail:
            word = words[(start + len(sent)) % len(words)]
            sent.append(word)
            phones += frontend.word_to_phones(word)
        phones = phones[: max(1, (total - lead - trail) // 2)]  # every phone >= 2 frames
        weights = rng.uniform(0.5, 1.5, len(phones))
        body = total - lead - trail
        dur = np.maximum(2, np.floor(weights / weights.sum() * body)).astype(int)
        dur[-1] += body - dur.sum()
        if dur[-1] < 2:  # rounding took too much from the last phone
            raise ValueError(f"utterance {u}: {len(phones)} phones do not fit {body} frames")
        intervals, frame = [], 0
        for label, n in [("sil", lead)] + list(zip(phones, dur.tolist())) + [("sil", trail)]:
            intervals.append((frame / FPS, (frame + n) / FPS, label))
            frame += n
        stem = f"utt{u:05d}"
        wav_path = os.path.join(out_dir, f"{stem}.wav")
        tg_path = os.path.join(out_dir, f"{stem}.TextGrid")
        write_textgrid(tg_path, intervals)
        save_wav(wav_path, voiced_wav(frame * HOP, rng, f0=float(rng.uniform(100.0, 220.0))))
        manifest.append(f"{wav_path}|{tg_path}|{' '.join(sent)}")
    path = os.path.join(out_dir, "manifest.txt")
    with open(path, "w", encoding="utf-8") as fout:
        fout.write("\n".join(manifest) + "\n")
    return path
