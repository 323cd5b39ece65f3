"""Matched/mismatched-prompt speaker-discrimination evaluation.

    python -m flamed_tts_tpu_torch.eval_discrimination --corpus corpus \\
        --codec-dir artifacts/codec_r5                                  # stage 1
    python -m flamed_tts_tpu_torch.eval_discrimination --corpus corpus \\
        --codec-dir artifacts/codec_r5 --ckpt model.npz --cfg configs   # + stage 2

Stage 1, the embedders on real audio (no TTS checkpoint): on a fabricated
corpus (``fabricate_corpus``), the speaker embeddings of centred 3 s crops
by the codec's timbre encoder, the log-mel statistics and (with trained
weights) the recognizer's speaker head; for each, mean cosine of
same-speaker pairs minus that of different-speaker pairs, and the sampled
pair-ranking accuracy.  A margin near 0 flags a saturated embedder.

Stage 2, speaker transfer (``--ckpt``, a Flamed ``.npz`` or reference
``.ckpt``): for each of ``--n-synth`` items, synthesize a text of speaker A
with a prompt of A, then compare sim(synth, prompt A) with sim(synth, audio
of another speaker B), and transcribe the synthesis (WER).  Item k's noise
comes from a ``torch.Generator`` seeded ``seed + k``.

Prints one JSON report line (the JAX package's
``tools/eval_discrimination.py`` keys) to stdout and a table to stderr.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.evaluate import _cosine, mel_stats_embedding, word_error_rate

SR = 16000


def read_corpus(corpus_dir: str) -> List[Tuple[str, str, str]]:
    """[(wav_path, transcript, speaker_id)] joining manifest + speakers."""
    spk = {}
    with open(os.path.join(corpus_dir, "speakers.txt"), encoding="utf-8") as fin:
        for line in fin:
            if "|" in line:
                stem, s = line.strip().split("|", 1)
                spk[stem] = s
    items = []
    with open(os.path.join(corpus_dir, "fab_manifest.txt"), encoding="utf-8") as fin:
        for line in fin:
            parts = line.strip().split("|")
            if len(parts) < 3:
                continue
            stem = os.path.splitext(os.path.basename(parts[0]))[0]
            if stem in spk:
                items.append((parts[0], parts[2], spk[stem]))
    return items


def trim_to_speech(wav: np.ndarray, seconds: float = 3.0) -> np.ndarray:
    """A centred window of ``seconds`` (past the fabricator's leading and
    trailing silence)."""
    n = int(seconds * SR)
    if len(wav) <= n:
        return wav
    start = (len(wav) - n) // 2
    return wav[start: start + n]


def pair_margins(embs: Dict[str, List[np.ndarray]]) -> Tuple[float, float, float, int, int]:
    """(same_mean, diff_mean, rank_acc, n_same, n_diff) over all pairs;
    rank_acc is the share of 20000 sampled (same pair, different pair)
    comparisons (``RandomState(0)``) where the same-speaker pair scores
    higher (0.5 = chance)."""
    same, diff = [], []
    speakers = sorted(embs.keys())
    for s in speakers:
        for a, b in itertools.combinations(embs[s], 2):
            same.append(_cosine(a, b))
    for s1, s2 in itertools.combinations(speakers, 2):
        for a in embs[s1]:
            for b in embs[s2]:
                diff.append(_cosine(a, b))
    if not same or not diff:
        return float("nan"), float("nan"), float("nan"), len(same), len(diff)
    same_a, diff_a = np.asarray(same), np.asarray(diff)
    rng = np.random.RandomState(0)
    k = min(20000, len(same_a) * len(diff_a))
    acc = float(np.mean(same_a[rng.randint(len(same_a), size=k)]
                        > diff_a[rng.randint(len(diff_a), size=k)]))
    return float(same_a.mean()), float(diff_a.mean()), acc, len(same), len(diff)


def load_recognizer(device=None):
    """The recognizer with the committed weights, shared by the speaker
    embedder and the transcriber, or None where the weights file is
    missing (any other failure propagates)."""
    from flamed_tts_tpu_torch.asr import PhonemeRecognizer

    try:
        return PhonemeRecognizer(device=device)
    except FileNotFoundError:
        return None


def asr_speaker_embedder(rec):
    """wav -> (64,) embedding from the recognizer's speaker head, or None
    where there is no recognizer or its weights have no head."""
    if rec is None or "spk_w" not in rec.params:
        return None
    return rec.speaker_embedding


def stage1(items, codec, n_utts: int, seed: int, rec=None) -> Dict:
    """The embedders' margins on the corpus's own audio."""
    from flamed_tts_tpu_torch.utils.audio import load_wav

    asr_embed = asr_speaker_embedder(rec)
    rng = np.random.RandomState(seed)
    by_spk: Dict[str, List[Tuple[str, str]]] = {}
    for wav_path, text, s in items:
        by_spk.setdefault(s, []).append((wav_path, text))
    speakers = sorted(s for s, lst in by_spk.items() if len(lst) >= 2)
    per_spk = max(2, n_utts // max(len(speakers), 1))

    embs_codec: Dict[str, List[np.ndarray]] = {}
    embs_mel: Dict[str, List[np.ndarray]] = {}
    embs_asr: Dict[str, List[np.ndarray]] = {}
    for s in speakers:
        lst = by_spk[s]
        for i in rng.permutation(len(lst))[:per_spk]:
            wav = trim_to_speech(load_wav(lst[i][0]))
            embs_codec.setdefault(s, []).append(codec.encode_prompt(wav)[1])
            embs_mel.setdefault(s, []).append(mel_stats_embedding(wav, codec.device))
            if asr_embed is not None:
                embs_asr.setdefault(s, []).append(asr_embed(wav))

    out = {}
    embedders = [("codec_timbre", embs_codec), ("melstats", embs_mel)]
    if asr_embed is not None:
        embedders.append(("asr_spk", embs_asr))
    for name, embs in embedders:
        same, diff, acc, n_s, n_d = pair_margins(embs)
        out[name] = {"same_mean": round(same, 4), "diff_mean": round(diff, 4),
                     "margin": round(same - diff, 4), "rank_acc": round(acc, 4),
                     "n_same_pairs": n_s, "n_diff_pairs": n_d}
        print(f"[stage1] {name:13s} same {same:.4f}  diff {diff:.4f}  margin {same - diff:+.4f}  "
              f"rank_acc {acc:.3f} ({n_s}/{n_d} pairs)", file=sys.stderr)
    out["n_speakers"] = len(speakers)
    return out


def score_synth(synth: np.ndarray, text: str, prompt_wav: np.ndarray, other_wav: np.ndarray,
                codec, rec=None) -> Dict:
    """One synthesized wav against its prompt (speaker A) and another
    speaker's audio (B): {"margin_codec", "margin_mel"} and, with a
    recognizer, "wer" (by pronunciation class) and "hyp", and with its
    speaker head "margin_asr"; unrounded."""
    _, t_synth = codec.encode_prompt(synth)
    _, t_prompt = codec.encode_prompt(prompt_wav)
    _, t_other = codec.encode_prompt(other_wav)
    e_synth = mel_stats_embedding(synth, codec.device)
    out = {"margin_codec": _cosine(t_synth, t_prompt) - _cosine(t_synth, t_other),
           "margin_mel": (_cosine(e_synth, mel_stats_embedding(prompt_wav, codec.device))
                          - _cosine(e_synth, mel_stats_embedding(other_wav, codec.device)))}
    if rec is not None:
        _, hyp = rec.transcribe(synth)
        out["wer"], out["hyp"] = word_error_rate(text, hyp, canon=rec.canon), hyp
    asr_embed = asr_speaker_embedder(rec)
    if asr_embed is not None:
        a_synth = asr_embed(synth)
        out["margin_asr"] = _cosine(a_synth, asr_embed(prompt_wav)) - _cosine(a_synth, asr_embed(other_wav))
    return out


def load_model(ckpt: str, cfg_dir: str, device):
    """Flamed from ``ckpt`` with the config of ``cfg_dir`` (a directory of
    the five yaml files, or one yaml file)."""
    from flamed_tts_tpu_torch.config import compose_training_config, load_yaml
    from flamed_tts_tpu_torch.models.flamed import Flamed

    if os.path.isdir(cfg_dir):
        cfg = compose_training_config(*(os.path.join(cfg_dir, f"{n}.yaml")
                                        for n in ("prior", "prob", "codec", "optimizer", "data")))
    else:
        cfg = load_yaml(cfg_dir)
    return Flamed.from_pretrained(cfg, ckpt, device=device)


def stage2(items, codec, model, n_synth: int, nsteps: int, seed: int, out_dir: Optional[str],
           rec=None) -> Dict:
    """Synthesize with matched prompts; the matched-vs-mismatched margins
    and the WER of the synthesized audio."""
    from flamed_tts_tpu_torch.utils.audio import load_wav, save_wav

    rng = np.random.RandomState(seed)
    by_spk: Dict[str, List[Tuple[str, str]]] = {}
    for wav_path, text, s in items:
        by_spk.setdefault(s, []).append((wav_path, text))
    speakers = sorted(s for s, lst in by_spk.items() if len(lst) >= 2)
    if len(speakers) < 2:
        raise SystemExit("need >= 2 speakers with >= 2 utterances for stage 2")

    margins = {"codec": [], "mel": [], "asr": []}
    wers, rows = [], []
    for k in range(n_synth):
        t0 = time.perf_counter()
        spk_a, spk_b = rng.choice(speakers, size=2, replace=False)
        # prompt and text from DIFFERENT utterances of speaker A
        p_idx, t_idx = rng.permutation(len(by_spk[spk_a]))[:2]
        prompt_wav = trim_to_speech(load_wav(by_spk[spk_a][p_idx][0]))
        text = " ".join(by_spk[spk_a][t_idx][1].split()[:8])  # bounds the synthesis length
        other_wav = trim_to_speech(load_wav(by_spk[spk_b][rng.randint(len(by_spk[spk_b]))][0]))
        synth = np.asarray(model.sample(text=text, prompt_raw=prompt_wav, codec=codec,
                                        nsteps_durgen=nsteps, nsteps_denoiser=nsteps,
                                        seed=seed + k)["wav"])
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            save_wav(os.path.join(out_dir, f"disc{k:03d}_{spk_a}.wav"), synth)
        sc = score_synth(synth, text, prompt_wav, other_wav, codec, rec)
        margins["codec"].append(sc["margin_codec"])
        margins["mel"].append(sc["margin_mel"])
        row = {"spk": spk_a, "vs": spk_b, "text": text, "dur_s": round(len(synth) / SR, 2),
               "margin_codec": round(sc["margin_codec"], 4), "margin_mel": round(sc["margin_mel"], 4)}
        if "wer" in sc:
            wers.append(sc["wer"])
            row["wer"], row["hyp"] = round(sc["wer"], 4), sc["hyp"]
        if "margin_asr" in sc:
            margins["asr"].append(sc["margin_asr"])
            row["margin_asr"] = round(sc["margin_asr"], 4)
        rows.append(row)
        print(f"[stage2] {k:2d} {spk_a}->vs {spk_b}: codec {sc['margin_codec']:+.4f} "
              f"mel {sc['margin_mel']:+.4f}"
              + (f" asr {sc['margin_asr']:+.4f}" if "margin_asr" in sc else "")
              + (f" wer {row['wer']:.2f}" if "wer" in row else "")
              + f" ({len(synth) / SR:.2f}s; {time.perf_counter() - t0:.2f} s wall)", file=sys.stderr)

    def _summ(vals):
        v = np.asarray(vals)
        return {"mean_margin": round(float(v.mean()), 4), "frac_positive": round(float((v > 0).mean()), 3)}

    out = {"n_synth": n_synth, "nfe": nsteps, "codec_timbre": _summ(margins["codec"]),
           "melstats": _summ(margins["mel"]), "items": rows}
    if margins["asr"]:
        out["asr_spk"] = _summ(margins["asr"])
    if wers:
        out["wer_synth"] = {"mean": round(float(np.mean(wers)), 4),
                            "median": round(float(np.median(wers)), 4), "n": len(wers)}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--corpus", required=True,
                        help="fabricated-corpus dir (fab_manifest.txt + speakers.txt)")
    parser.add_argument("--ckpt", default=None,
                        help="trained Flamed .npz (or .ckpt); omit (or 'random'/'none') to run "
                             "stage 1 only")
    parser.add_argument("--cfg", default="configs_demo")
    parser.add_argument("--codec-dir", default="random")
    parser.add_argument("--n-utts", type=int, default=48, help="stage-1 utterance budget across speakers")
    parser.add_argument("--n-synth", type=int, default=12)
    parser.add_argument("--nsteps", type=int, default=32)
    parser.add_argument("--out-dir", default=None, help="where to keep the stage-2 synthesized wavs")
    parser.add_argument("--out-json", default=None,
                        help="write the report here after EVERY stage (stdout still gets the "
                             "final JSON)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--holdout-speakers", default="",
                        help="Comma-separated speaker ids excluded from all training; adds "
                             "stage1_heldout/stage2_heldout reports restricted to them.")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from flamed_tts_tpu_torch.config import load_default_config
    from flamed_tts_tpu_torch.synthesize import get_codec

    codec = get_codec(load_default_config(), args.codec_dir, device)
    items = read_corpus(args.corpus)
    rec = load_recognizer(device)
    holdout = set(s for s in args.holdout_speakers.split(",") if s)
    held_items = [it for it in items if it[2] in holdout]
    report: Dict = {"corpus": args.corpus, "n_items": len(items)}

    def flush():
        # after every stage: a run cut short keeps the stages it finished
        if args.out_json:
            with open(args.out_json, "w", encoding="utf-8") as f:
                json.dump(report, f)

    report["stage1"] = stage1(items, codec, args.n_utts, args.seed, rec=rec)
    flush()
    if holdout:
        print(f"[stage1] held-out speakers only ({sorted(holdout)}):", file=sys.stderr)
        report["stage1_heldout"] = stage1(held_items, codec, args.n_utts, args.seed, rec=rec)
        flush()

    if args.ckpt and args.ckpt not in ("random", "none"):
        model = load_model(args.ckpt, args.cfg, device)
        report["stage2"] = stage2(items, codec, model, args.n_synth, args.nsteps, args.seed,
                                  args.out_dir, rec=rec)
        flush()
        if holdout:
            # prompts from speakers left out of all training
            print("[stage2] held-out-speaker prompts only:", file=sys.stderr)
            report["stage2_heldout"] = stage2(held_items, codec, model, args.n_synth, args.nsteps,
                                              args.seed, args.out_dir and args.out_dir + "_heldout",
                                              rec=rec)
            flush()

    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
