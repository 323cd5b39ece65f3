"""Objective evaluation of synthesized audio.

    python -m flamed_tts_tpu_torch.evaluate --synth-dir out/nfe64-temp0.3 \\
        --metadata-file meta.txt --prompt-dir prompts/ [--ref-dir refs/] \\
        --codec-dir artifacts/codec_r5 [--asr-ckpt default | --asr-cmd CMD] [--device cuda|cpu]

* speaker similarity: the cosine between the FaCodec timbre embeddings of
  the prompt and the synthesized wav, and between their log-mel statistics
  (an embedder that shares no parameters with the model under test);
* log-mel RMS distance to a ground-truth wav (``--ref-dir``);
* duration of the synthesized wavs;
* WER: from ``--asr-cmd`` (a shell command template ``'{wav}'`` that prints
  a transcript), or from the phone recognizer (``--asr-ckpt``), which also
  gives the phone error rate against the frontend's phones of the text.

Prints one JSON report (the JAX package's ``tools/evaluate.py`` keys).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.ops.melspec import mel_spectrogram


def _levenshtein(a: List[str], b: List[str]) -> int:
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def word_error_rate(ref: str, hyp: str, canon: Optional[Callable[[str], str]] = None) -> float:
    """Edit distance over words / len(ref).  ``canon`` maps a word to its
    equivalence class (``PhonemeRecognizer.canon``: homophones together, as
    a lexicon-constrained decoder emits one spelling per pronunciation)."""
    ref_words = ref.lower().split()
    hyp_words = hyp.lower().split()
    if not ref_words:
        return 0.0
    if canon is not None:
        ref_words = [canon(w) for w in ref_words]
        hyp_words = [canon(w) for w in hyp_words]
    return _levenshtein(ref_words, hyp_words) / len(ref_words)


def log_mel(wav: np.ndarray, device: Union[str, torch.device, None] = None) -> np.ndarray:
    """wav (T,) -> (80, frames) log-mel on the host, computed on ``device``."""
    return mel_spectrogram(torch.as_tensor(np.asarray(wav, dtype=np.float32),
                                           device=resolve_device(device))[None])[0].cpu().numpy()


def mel_stats_embedding(wav: np.ndarray, device: Union[str, torch.device, None] = None) -> np.ndarray:
    """A speaker embedding independent of the codec: per-band mean and std
    of the log-mel and of its time difference (320-d)."""
    mel = log_mel(wav, device)
    delta = np.diff(mel, axis=1) if mel.shape[1] > 1 else np.zeros_like(mel)
    return np.concatenate([mel.mean(1), mel.std(1), delta.mean(1), delta.std(1)]).astype(np.float32)


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.dot(a, b) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-9))


def read_metadata(path: str) -> List[tuple]:
    """``target|prompt|text`` lines -> [(target, prompt, text)]."""
    entries = []
    with open(path, encoding="utf-8") as fin:
        for line in fin:
            line = line.strip()
            if line and line.count("|") >= 2:
                entries.append(tuple(line.split("|", 2)))
    return entries


def evaluate(entries, synth_dir: str, prompt_dir: str, codec, ref_dir: Optional[str] = None,
             asr_cmd: Optional[str] = None, recognizer=None, frontend=None) -> Dict:
    """The report over ``entries``; the mel statistics on the codec's
    device."""
    from flamed_tts_tpu_torch.utils.audio import load_wav

    device = codec.device
    sims, sims_mel, mel_l2s, wers, pers, durations = [], [], [], [], [], []
    n_missing = 0
    for target, prompt, text in entries:
        synth_path = os.path.join(synth_dir, target)
        if not os.path.isfile(synth_path):
            n_missing += 1
            continue
        synth = load_wav(synth_path)
        durations.append(len(synth) / 16000.0)

        prompt_path = prompt if os.path.isabs(prompt) else os.path.join(prompt_dir, prompt)
        if os.path.isfile(prompt_path):
            prompt_wav = load_wav(prompt_path)
            _, t_prompt = codec.encode_prompt(prompt_wav)
            _, t_synth = codec.encode_prompt(synth)
            sims.append(_cosine(t_prompt, t_synth))
            sims_mel.append(_cosine(mel_stats_embedding(prompt_wav, device),
                                    mel_stats_embedding(synth, device)))

        if ref_dir:
            ref_path = os.path.join(ref_dir, target)
            if os.path.isfile(ref_path):
                ref = load_wav(ref_path)
                n = min(len(ref), len(synth))
                mel_a, mel_b = log_mel(synth[:n], device), log_mel(ref[:n], device)
                mel_l2s.append(float(np.sqrt(((mel_a - mel_b) ** 2).mean())))

        if asr_cmd:
            hyp = subprocess.run(asr_cmd.format(wav=synth_path), shell=True, capture_output=True,
                                 text=True).stdout.strip()
            wers.append(word_error_rate(text, hyp))
        elif recognizer is not None:
            phones, hyp = recognizer.transcribe(synth)
            wers.append(word_error_rate(text, hyp))
            # phone error rate against the frontend's (stress-stripped)
            # phones of the text
            ref_phones = [p.rstrip("012") for w in text.split() for p in frontend.word_to_phones(w)]
            pers.append(_levenshtein(phones, ref_phones) / max(len(ref_phones), 1))

    def mean(vals):
        return round(float(np.mean(vals)), 4) if vals else None

    return {"n_evaluated": len(durations), "n_missing": n_missing,
            "avg_duration_sec": round(float(np.mean(durations)), 3) if durations else None,
            "speaker_similarity": mean(sims), "speaker_similarity_melstats": mean(sims_mel),
            "mel_l2": mean(mel_l2s), "wer": mean(wers), "per": mean(pers)}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--synth-dir", required=True)
    parser.add_argument("--metadata-file", required=True,
                        help="Lines target|prompt|text (the synthesis input).")
    parser.add_argument("--prompt-dir", required=True)
    parser.add_argument("--ref-dir", default=None,
                        help="Ground-truth wavs named like targets (for mel distance).")
    parser.add_argument("--codec-dir", default=None,
                        help="Converted codec .npz dir ('random' for random init).")
    parser.add_argument("--asr-cmd", default=None,
                        help="Shell command template '{wav}' -> transcript on stdout.")
    parser.add_argument("--asr-ckpt", default=None,
                        help="Weights of the in-process phone recognizer (asr.py); 'default' "
                             "uses the committed flamed_tts_tpu/lexicon/asr_weights.npz.")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from flamed_tts_tpu_torch.config import load_default_config
    from flamed_tts_tpu_torch.synthesize import get_codec

    codec = get_codec(load_default_config(), args.codec_dir, device)
    recognizer = frontend = None
    if args.asr_ckpt:
        from flamed_tts_tpu_torch.asr import PhonemeRecognizer
        from flamed_tts_tpu_torch.text.frontend import EnglishFrontend

        recognizer = PhonemeRecognizer(None if args.asr_ckpt == "default" else args.asr_ckpt,
                                       device=device)
        frontend = EnglishFrontend()
    report = evaluate(read_metadata(args.metadata_file), args.synth_dir, args.prompt_dir, codec,
                      args.ref_dir, args.asr_cmd, recognizer, frontend)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
