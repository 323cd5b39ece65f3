"""Fabricate a multi-speaker corpus of wav + MFA-style TextGrid pairs, the
corpus the evaluation tools read.

    python -m flamed_tts_tpu_torch.fabricate_corpus --out-dir corpus --n 300 [--seed 0]
        [--n-speakers 24] [--dur-max 15] [--prefix utt]

* transcripts: 5-40 words drawn from the built-in lexicon's word list
  (log-normal word counts around 14),
* phones from the English frontend; per-phone durations log-normal around
  6 code frames (80 a second), inter-word pauses ('sp'/'sil', p = 0.18) and
  leading and trailing silence; an utterance longer than ``--dur-max`` is
  drawn again (up to 20 times),
* a "phones" tier with boundaries on whole code frames,
* a 16 kHz wav of PHONE-DEPENDENT formant audio in one of N speaker voices
  (f0, vocal-tract scale, spectral tilt, vibrato): vowels and sonorants as
  harmonic stacks under two formants, fricatives as noise bands, stops as
  closure + burst.  A recognizer can learn phones from it and a speaker
  embedder can tell the voices apart,
* ``fab_manifest.txt`` (``wav|textgrid|transcript`` lines) and
  ``speakers.txt`` (``stem|spkNNN`` lines).

Numpy on the host; for the same flags the files equal the JAX package's
``tools/fabricate_corpus.py`` (the paths in the manifest aside).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from flamed_tts_tpu_torch.text.frontend import EnglishFrontend
from flamed_tts_tpu_torch.utils.audio import save_wav
from flamed_tts_tpu_torch.utils.textgrid import write_textgrid

SR = 16000
HOP = 200  # codec hop: 80 frames/s
FPS = SR // HOP

# (F1, F2) in Hz: American English vowel chart values.
_VOWEL_FORMANTS = {
    "IY": (270, 2290), "IH": (390, 1990), "EH": (530, 1840),
    "AE": (660, 1720), "AA": (730, 1090), "AO": (570, 840),
    "UH": (440, 1020), "UW": (300, 870), "AH": (640, 1190),
    "ER": (490, 1350), "EY": (400, 2100), "AY": (660, 1400),
    "AW": (680, 1100), "OY": (550, 960), "OW": (450, 950),
}
# voiced sonorant consonants: murmur-like formant pairs
_SONORANT_FORMANTS = {
    "W": (300, 700), "Y": (280, 2250), "R": (350, 1300), "L": (380, 1200),
    "M": (250, 1100), "N": (250, 1700), "NG": (250, 2000),
}
# fricatives: (band_lo, band_hi, voiced, amplitude)
_FRICATIVES = {
    "S": (5500, 7800, False, 0.10), "SH": (2500, 4500, False, 0.11),
    "Z": (5500, 7800, True, 0.08), "ZH": (2500, 4200, True, 0.08),
    "F": (4000, 6800, False, 0.07), "V": (3500, 5500, True, 0.07),
    "TH": (4500, 7200, False, 0.05), "DH": (4000, 6500, True, 0.06),
    "HH": (500, 2500, False, 0.05),
}
# stops: (burst_lo, burst_hi, voiced)
_STOPS = {
    "P": (600, 1500, False), "B": (600, 1500, True),
    "T": (4000, 7000, False), "D": (3000, 6000, True),
    "K": (1500, 3500, False), "G": (1200, 3000, True),
}
_AFFRICATES = {"CH": ("T", "SH"), "JH": ("D", "ZH")}


def make_speaker(spk_id: int) -> Dict[str, float]:
    """Deterministic speaker voice: f0 base, vocal-tract scale, tilt."""
    srng = np.random.RandomState(1000 + spk_id)
    return {
        "f0": float(np.exp(srng.uniform(np.log(90.0), np.log(260.0)))),
        "vt_scale": float(srng.uniform(0.85, 1.2)),   # formant/band scaling
        "tilt": float(srng.uniform(0.3, 1.1)),        # spectral slope exponent
        "vibrato": float(srng.uniform(0.1, 0.35)),
    }


def _band_noise(n, lo, hi, rng):
    """White noise band-limited to [lo, hi] Hz via rFFT masking."""
    noise = rng.randn(n)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    spec[(freqs < lo) | (freqs > hi)] = 0.0
    out = np.fft.irfft(spec, n)
    return out / (np.abs(out).max() + 1e-9)


def _voiced_segment(n, t0, spk, formants, rng):
    """Harmonic stack shaped by two formant resonances."""
    t = t0 + np.arange(n) / SR
    f0 = spk["f0"] * (1.0 + spk["vibrato"] * 0.05 * np.sin(2 * np.pi * 5.5 * t))
    phase0 = 2 * np.pi * np.cumsum(f0) / SR
    n_harm = max(int(4800 / spk["f0"]), 3)
    k = np.arange(1, n_harm + 1)[:, None]
    freqs = k * spk["f0"]
    f1, f2 = formants[0] * spk["vt_scale"], formants[1] * spk["vt_scale"]
    w = (
        np.exp(-0.5 * ((freqs - f1) / 120.0) ** 2)
        + 0.7 * np.exp(-0.5 * ((freqs - f2) / 180.0) ** 2)
        + 0.02
    ) / k ** spk["tilt"]
    seg = (w * np.sin(k * phase0[None, :])).sum(0)
    return seg / (np.abs(seg).max() + 1e-9)


def phone_audio(base, n, t0, spk, rng):
    """Waveform for one phone interval (n samples starting at t0 s)."""
    if base in ("sil", "sp", "spn", ""):
        return 0.0005 * rng.randn(n)
    if base in _AFFRICATES:
        stop, fric = _AFFRICATES[base]
        n1 = max(n // 3, 1)
        return np.concatenate([phone_audio(stop, n1, t0, spk, rng),
                               phone_audio(fric, n - n1, t0 + n1 / SR, spk, rng)])
    scale = spk["vt_scale"]
    if base in _VOWEL_FORMANTS:
        return 0.22 * _voiced_segment(n, t0, spk, _VOWEL_FORMANTS[base], rng)
    if base in _SONORANT_FORMANTS:
        return 0.13 * _voiced_segment(n, t0, spk, _SONORANT_FORMANTS[base], rng)
    if base in _FRICATIVES:
        lo, hi, voiced, amp = _FRICATIVES[base]
        seg = amp * _band_noise(n, lo * scale, min(hi * scale, 7900), rng)
        if voiced:
            seg = seg + 0.10 * _voiced_segment(n, t0, spk, (300, 1000), rng)
        return seg
    if base in _STOPS:
        lo, hi, voiced = _STOPS[base]
        closure = max(int(n * 0.55), 1)
        burst = n - closure
        seg = np.zeros(n)
        seg[:closure] = 0.0005 * rng.randn(closure)
        if voiced:
            seg[:closure] += 0.03 * _voiced_segment(closure, t0, spk, (200, 600), rng)
        if burst > 0:
            env = np.exp(-np.arange(burst) / (0.35 * burst + 1))
            seg[closure:] = 0.16 * env * _band_noise(burst, lo * scale, min(hi * scale, 7900), rng)
        return seg
    # unknown symbol: weak mid noise, still distinct from silence
    return 0.02 * _band_noise(n, 800, 2400, rng)


def wav_for(intervals, spk, rng: np.random.RandomState) -> np.ndarray:
    """Phone-dependent formant audio of ``intervals`` in the given voice."""
    n_total = int(round(intervals[-1][1] * SR))
    wav = np.zeros(n_total, dtype=np.float64)
    for a, b, text in intervals:
        i, j = int(round(a * SR)), min(int(round(b * SR)), n_total)
        if j <= i:
            continue
        seg = phone_audio(text.rstrip("012"), j - i, a, spk, rng)
        m = min(len(seg), j - i)
        ramp = min(32, m // 4)
        if ramp > 0:  # declick
            seg[:ramp] *= np.linspace(0, 1, ramp)
            seg[m - ramp: m] *= np.linspace(1, 0, ramp)
        wav[i: i + m] += seg[:m]
    wav += 0.0015 * rng.randn(n_total)
    return wav.astype(np.float32)


def fabricate(out_dir: str, n: int = 300, seed: int = 0, n_speakers: int = 24, dur_max: float = 15.0,
              prefix: str = "utt") -> List[float]:
    """Write ``n`` utterances, ``fab_manifest.txt`` and ``speakers.txt`` to
    ``out_dir``; returns the utterances' durations in seconds."""
    frontend = EnglishFrontend()
    words = sorted(frontend.lexicon.keys() or frontend.builtin.keys())
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    speakers = [make_speaker(s) for s in range(n_speakers)]
    manifest, spk_map, durations = [], [], []
    for u in range(n):
        spk_id = int(rng.randint(n_speakers))
        for _attempt in range(20):
            n_words = int(np.clip(rng.lognormal(np.log(14), 0.45), 5, 40))
            sent = [words[rng.randint(len(words))] for _ in range(n_words)]
            intervals = []  # (start_s, end_s, label)
            frame = 0

            def emit(label: str, n_frames: int):
                nonlocal frame
                intervals.append((frame / FPS, (frame + n_frames) / FPS, label))
                frame += n_frames

            emit("sil", int(rng.randint(4, 20)))  # leading silence
            for w_i, word in enumerate(sent):
                for ph in frontend.word_to_phones(word):
                    emit(ph, int(np.clip(rng.lognormal(np.log(6.0), 0.45), 2, 40)))
                if w_i < len(sent) - 1 and rng.rand() < 0.18:
                    emit("sp" if rng.rand() < 0.7 else "sil", int(rng.randint(3, 30)))
            emit("sil", int(rng.randint(4, 24)))  # trailing silence
            dur = frame / FPS
            if dur <= dur_max:
                break
        durations.append(dur)

        stem = f"{prefix}{u:05d}"
        tg = os.path.join(out_dir, f"{stem}.TextGrid")
        wv = os.path.join(out_dir, f"{stem}.wav")
        write_textgrid(tg, intervals)
        save_wav(wv, wav_for(intervals, speakers[spk_id], rng))
        manifest.append(f"{wv}|{tg}|{' '.join(sent)}")
        spk_map.append(f"{stem}|spk{spk_id:03d}")

    with open(os.path.join(out_dir, "fab_manifest.txt"), "w") as fout:
        fout.write("\n".join(manifest) + "\n")
    # utterance -> speaker (read by the evaluation tools, not by training)
    with open(os.path.join(out_dir, "speakers.txt"), "w") as fout:
        fout.write("\n".join(spk_map) + "\n")
    return durations


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--n", type=int, default=300)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n-speakers", type=int, default=24,
                        help="Speaker-pool size (voices: f0/tract-scale/tilt).")
    parser.add_argument("--dur-max", type=float, default=15.0,
                        help="Resample utterances whose draw exceeds this (s).")
    parser.add_argument("--prefix", default="utt",
                        help="Utterance stem prefix; distinct prefixes let independently "
                             "fabricated batches share one directory.")
    args = parser.parse_args(argv)
    d = np.asarray(fabricate(args.out_dir, args.n, args.seed, args.n_speakers, args.dur_max,
                             args.prefix))
    print(f"Fabricated {args.n} utterances -> {args.out_dir}\n"
          f"duration s: min {d.min():.1f} p50 {np.percentile(d, 50):.1f} "
          f"p95 {np.percentile(d, 95):.1f} max {d.max():.1f} total {d.sum()/60:.1f} min")


if __name__ == "__main__":
    main()
