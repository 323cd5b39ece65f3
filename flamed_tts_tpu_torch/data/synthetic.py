"""A synthetic corpus in the layout the precompute step reads: voiced
16 kHz wavs, "phones" TextGrids whose phones come from the text frontend
and whose boundaries fall on whole code frames (200 samples), and a
``wav|textgrid|transcript`` manifest; or, for the codec trainer, a corpus
of several speakers told apart by f0 in the layout of the JAX package's
fabricator (``fab_manifest.txt``, ``speakers.txt``).  Made from a seed with
numpy; for smoke runs and tests, where no recorded corpus is at hand.
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


def _utterance(out_dir: str, stem: str, sec: float, rng: np.random.RandomState, frontend,
               words: List[str], f0_range: Sequence[float]) -> str:
    """Write ``stem``.wav / .TextGrid of about ``sec`` seconds (at least 3
    words), the voice's f0 drawn from ``f0_range``; returns the manifest
    line."""
    total = int(round(sec * FPS))
    lead, trail = int(rng.randint(4, 12)), int(rng.randint(4, 12))
    # words, cycling through the sentences from a random start, until the
    # phones average about 7 frames
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
        raise ValueError(f"{stem}: {len(phones)} phones do not fit {body} frames")
    intervals, frame = [], 0
    for label, n in [("sil", lead)] + list(zip(phones, dur.tolist())) + [("sil", trail)]:
        intervals.append((frame / FPS, (frame + n) / FPS, label))
        frame += n
    wav_path = os.path.join(out_dir, f"{stem}.wav")
    tg_path = os.path.join(out_dir, f"{stem}.TextGrid")
    write_textgrid(tg_path, intervals)
    save_wav(wav_path, voiced_wav(frame * HOP, rng, f0=float(rng.uniform(*f0_range))))
    return f"{wav_path}|{tg_path}|{' '.join(sent)}"


def _words() -> List[str]:
    return [w.strip(".,").lower() for s in SENTENCES for w in s.split()]


def fabricate_corpus(out_dir: str, seconds: Sequence[float], seed: int = 0) -> str:
    """One utterance of about ``seconds[i]`` seconds each (at least 3
    words of ``SENTENCES``), f0 100-220 Hz; returns the path of the
    ``wav|textgrid|transcript`` manifest (``manifest.txt``)."""
    from flamed_tts_tpu_torch.text.frontend import EnglishFrontend

    frontend, words = EnglishFrontend(), _words()
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    manifest = [_utterance(out_dir, f"utt{u:05d}", sec, rng, frontend, words, (100.0, 220.0))
                for u, sec in enumerate(seconds)]
    path = os.path.join(out_dir, "manifest.txt")
    with open(path, "w", encoding="utf-8") as fout:
        fout.write("\n".join(manifest) + "\n")
    return path


def speaker_f0_range(speaker: int, n_speakers: int) -> tuple:
    """Speaker ``speaker`` of ``n_speakers`` speaks at an f0 in its own
    band of 90-250 Hz (the bands do not overlap)."""
    width = 160.0 / n_speakers
    return 90.0 + width * speaker, 90.0 + width * (speaker + 1)


def fabricate_speaker_corpus(out_dir: str, seconds: Sequence[float], n_speakers: int,
                             seed: int = 0) -> str:
    """A multi-speaker corpus in the layout of the JAX package's
    ``tools/fabricate_corpus.py``: utterance u by speaker ``spk{u %
    n_speakers:03d}`` (f0 from ``speaker_f0_range``), ``fab_manifest.txt``
    (``wav|textgrid|transcript``) and ``speakers.txt`` (``stem|speaker``),
    which the codec trainer reads.  Returns ``out_dir``."""
    from flamed_tts_tpu_torch.text.frontend import EnglishFrontend

    frontend, words = EnglishFrontend(), _words()
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    manifest, spk_map = [], []
    for u, sec in enumerate(seconds):
        stem, spk = f"fab{u:05d}", u % n_speakers
        manifest.append(_utterance(out_dir, stem, sec, rng, frontend, words,
                                   speaker_f0_range(spk, n_speakers)))
        spk_map.append(f"{stem}|spk{spk:03d}")
    for name, lines in (("fab_manifest.txt", manifest), ("speakers.txt", spk_map)):
        with open(os.path.join(out_dir, name), "w", encoding="utf-8") as fout:
            fout.write("\n".join(lines) + "\n")
    return out_dir
