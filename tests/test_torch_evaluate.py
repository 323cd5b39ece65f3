"""The port's evaluation tools against the JAX package's on the CPU:
``evaluate`` (WER, log-mel statistics, speaker similarity through a narrow
random codec, the CLI with a stub ASR command), ``dump_decoded``,
``eval_discrimination`` (pair margins, stage 1, the scoring of one
synthesized wav, stage 2 end to end) and ``render_eval_report``."""

import json
import os
import sys

import numpy as np
import pytest

from flamed_tts_tpu import asr as jasr
from flamed_tts_tpu.models.codec_wrapper import FaCodec as JFaCodec
from tools import eval_discrimination as jdisc
from tools import evaluate as jeval
from tools import render_eval_report as jrender

from flamed_tts_tpu_torch import asr, dump_decoded, eval_discrimination, evaluate, render_eval_report
from flamed_tts_tpu_torch.fabricate_corpus import fabricate
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.utils.audio import load_wav, save_wav

from torch_parity_utils import narrow_codec_dir, prompt_wav, small_config
from torch_parity_utils import one_torch_thread  # noqa: F401  (autouse)

SIM_TOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A corpus of six utterances by two speakers, a narrow random codec in
    both packages (the same weights) and both recognizers."""
    root = tmp_path_factory.mktemp("eval")
    corpus, codec_dir = str(root / "corpus"), str(root / "codec")
    fabricate(corpus, n=6, seed=1, n_speakers=2, dur_max=3.5)  # 4 + 2 utterances
    enc, dec = narrow_codec_dir(codec_dir, seed=1)
    return {"root": root, "corpus": corpus, "codec_dir": codec_dir,
            "codec": FaCodec.from_pretrained(codec_dir, device="cpu"), "jcodec": JFaCodec(enc, dec),
            "rec": asr.PhonemeRecognizer(device="cpu"), "jrec": jasr.PhonemeRecognizer()}


@pytest.mark.parametrize("ref,hyp", [("the cat sat", "the cat sat"), ("the cat sat", "the dog sat"),
                                     ("a b c d", "a b d"), ("a b", "a x b y"),
                                     ("Hello World", "hello world"), ("", "anything here"),
                                     ("their dog", "there dog")])
def test_word_error_rate_equals_jax(ref, hyp):
    rec = asr.PhonemeRecognizer(device="cpu")
    assert evaluate.word_error_rate(ref, hyp) == jeval.word_error_rate(ref, hyp)
    assert evaluate.word_error_rate(ref, hyp, rec.canon) == jeval.word_error_rate(ref, hyp, rec.canon)
    assert evaluate._levenshtein(ref.split(), hyp.split()) == jeval._levenshtein(ref.split(), hyp.split())
    assert evaluate.word_error_rate("their dog", "there dog", rec.canon) == 0.0


def test_mel_stats_embedding_matches_jax():
    rng = np.random.RandomState(0)
    t = np.arange(16000) / 16000.0
    tone = (0.2 * np.sin(2 * np.pi * 220 * t) + 0.01 * rng.randn(16000)).astype(np.float32)
    for wav in (tone, prompt_wav(1.3, seed=1), (0.2 * rng.randn(8000)).astype(np.float32)):
        ours = evaluate.mel_stats_embedding(wav, "cpu")
        assert ours.shape == (320,) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, jeval.mel_stats_embedding(wav), atol=1e-4, rtol=0)


def test_speaker_similarity_matches_jax(setup):
    """The codec timbre's cosine of two 3 s wavs through the narrow codec:
    within 1e-5 of the JAX package's."""
    a, b = prompt_wav(2.7, seed=3), load_wav(os.path.join(setup["corpus"], "utt00001.wav"))[:44000]
    ours = evaluate._cosine(setup["codec"].encode_prompt(a)[1], setup["codec"].encode_prompt(b)[1])
    ref = jeval._cosine(setup["jcodec"].encode_prompt(a)[1], setup["jcodec"].encode_prompt(b)[1])
    assert abs(ours - ref) <= SIM_TOL and abs(ours) < 1.0


def test_evaluate_cli_with_a_stub_asr(tmp_path):
    """The CLI on the CPU with a random codec and a stub ASR command: the
    report that tests/test_evaluate.py expects of the JAX CLI."""
    t = np.arange(16000) / 16000.0
    for d, f0 in (("synth", 200), ("prompts", 210), ("refs", 205)):
        save_wav(str(tmp_path / d / ("p1.wav" if d == "prompts" else "utt1.wav")),
                 (0.2 * np.sin(2 * np.pi * f0 * t)).astype(np.float32))
    meta = tmp_path / "meta.txt"
    meta.write_text("utt1.wav|p1.wav|hello brave new world\nmissing.wav|p1.wav|a b\n")
    stub = f"{sys.executable} -c \"print('hello brave old world')\" # {{wav}}"
    report = evaluate.main(["--synth-dir", str(tmp_path / "synth"), "--metadata-file", str(meta),
                            "--prompt-dir", str(tmp_path / "prompts"), "--ref-dir", str(tmp_path / "refs"),
                            "--codec-dir", "random", "--asr-cmd", stub, "--device", "cpu"])
    assert sorted(report) == sorted(["n_evaluated", "n_missing", "avg_duration_sec", "speaker_similarity",
                                     "speaker_similarity_melstats", "mel_l2", "wer", "per"])
    assert report["n_evaluated"] == 1 and report["n_missing"] == 1
    assert report["wer"] == 0.25 and report["per"] is None
    assert report["avg_duration_sec"] == 1.0
    for key in ("speaker_similarity", "speaker_similarity_melstats", "mel_l2"):
        assert report[key] is not None and np.isfinite(report[key])


def test_evaluate_with_the_recognizer_matches_jax(setup, tmp_path):
    """evaluate() with the committed recognizer on two corpus wavs as the
    synthesized ones, each its own prompt and reference: the JAX tool's WER
    and PER (the same transcripts)."""
    from flamed_tts_tpu.text.frontend import EnglishFrontend as JFrontend

    from flamed_tts_tpu_torch.text.frontend import EnglishFrontend

    lines = [ln.split("|") for ln in open(os.path.join(setup["corpus"], "fab_manifest.txt")).read().split("\n") if ln]
    entries = [(os.path.basename(w), os.path.basename(w), text) for w, _, text in lines[1:3]]
    ours = evaluate.evaluate(entries, setup["corpus"], setup["corpus"], setup["codec"], setup["corpus"],
                             recognizer=setup["rec"], frontend=EnglishFrontend())
    # the JAX tool's loop, with its recognizer and frontend, on the same files
    jfront, wers, pers = JFrontend(), [], []
    for target, _, text in entries:
        phones, hyp = setup["jrec"].transcribe(load_wav(os.path.join(setup["corpus"], target)))
        wers.append(jeval.word_error_rate(text, hyp))
        ref_phones = [p.rstrip("012") for w in text.split() for p in jfront.word_to_phones(w)]
        pers.append(jeval._levenshtein(phones, ref_phones) / max(len(ref_phones), 1))
    assert ours["n_evaluated"] == 2 and ours["mel_l2"] == 0.0 and ours["speaker_similarity"] == 1.0
    assert ours["wer"] == round(float(np.mean(wers)), 4) and ours["per"] == round(float(np.mean(pers)), 4)


def test_dump_decoded_writes_the_round_trip_and_skips_existing(setup, tmp_path):
    out = str(tmp_path / "decoded")
    stats = dump_decoded.dump_decoded(setup["corpus"], setup["codec"], out, log=lambda *a: None)
    assert stats["decoded"] == 6 and stats["skipped"] == 0
    wav = load_wav(os.path.join(setup["corpus"], "utt00004.wav"))
    got = load_wav(os.path.join(out, "utt00004.wav"))
    ref = setup["codec"].round_trip(wav)
    assert got.shape == ref.shape == (len(wav) // 200 * 200,)
    # 16-bit PCM: x -> int(x * 32767) / 32768
    np.testing.assert_allclose(got, np.clip(ref, -1, 1), atol=2.0 / 32767, rtol=0)
    os.remove(os.path.join(out, "utt00002.wav"))
    stats = dump_decoded.dump_decoded(setup["corpus"], setup["codec"], out, log=lambda *a: None)
    assert stats["decoded"] == 1 and stats["skipped"] == 5


def test_pair_margins_equal_jax():
    rng = np.random.RandomState(0)
    embs = {f"spk{s}": [rng.randn(16) + 2.0 * s for _ in range(3 + s)] for s in range(3)}
    assert eval_discrimination.pair_margins(embs) == jdisc.pair_margins(embs)
    assert np.isnan(eval_discrimination.pair_margins({"a": [rng.randn(4)]})[0])


def _recorded(module, monkeypatch):
    """Record each raw pair_margins result of ``module`` (the reports round
    to 4 places)."""
    seen = []
    inner = module.pair_margins

    def record(embs):
        seen.append(inner(embs))
        return seen[-1]

    monkeypatch.setattr(module, "pair_margins", record)
    return seen


def test_stage1_matches_jax(setup, monkeypatch):
    """Stage 1 on the six-utterance corpus with the narrow codec and the
    committed recognizer: each embedder's same / different means within
    1e-5 of the JAX tool's, the same pair counts and rank accuracy."""
    items = eval_discrimination.read_corpus(setup["corpus"])
    assert items == jdisc.read_corpus(setup["corpus"]) and len(items) == 6
    ours_raw, ref_raw = _recorded(eval_discrimination, monkeypatch), _recorded(jdisc, monkeypatch)
    ours = eval_discrimination.stage1(items, setup["codec"], 4, 0, rec=setup["rec"])
    ref = jdisc.stage1(items, setup["jcodec"], 4, 0, rec=setup["jrec"])
    assert ours.keys() == ref.keys() == {"codec_timbre", "melstats", "asr_spk", "n_speakers"}
    assert len(ours_raw) == len(ref_raw) == 3
    for o, r in zip(ours_raw, ref_raw):
        np.testing.assert_allclose(o[:2], r[:2], atol=SIM_TOL, rtol=0)
        assert o[2:] == r[2:]


def test_score_synth_matches_jax(setup):
    """The scoring of one synthesized wav (margins, WER, transcript)
    against the JAX tool's stage-2 loop body on the same wav."""
    synth = load_wav(os.path.join(setup["corpus"], "utt00000.wav"))[:40000]
    prompt = eval_discrimination.trim_to_speech(load_wav(os.path.join(setup["corpus"], "utt00003.wav")))
    other = eval_discrimination.trim_to_speech(load_wav(os.path.join(setup["corpus"], "utt00005.wav")))
    text = "the quick brown fox"
    ours = eval_discrimination.score_synth(synth, text, prompt, other, setup["codec"], setup["rec"])
    jc, jrec = setup["jcodec"], setup["jrec"]
    t_synth, t_prompt, t_other = (jc.encode_prompt(w)[1] for w in (synth, prompt, other))
    e_synth = jeval.mel_stats_embedding(synth)
    _, hyp = jrec.transcribe(synth)
    a_synth = jrec.speaker_embedding(synth)
    ref = {"margin_codec": jeval._cosine(t_synth, t_prompt) - jeval._cosine(t_synth, t_other),
           "margin_mel": (jeval._cosine(e_synth, jeval.mel_stats_embedding(prompt))
                          - jeval._cosine(e_synth, jeval.mel_stats_embedding(other))),
           "wer": jeval.word_error_rate(text, hyp, canon=jrec.canon), "hyp": hyp,
           "margin_asr": (jeval._cosine(a_synth, jrec.speaker_embedding(prompt))
                          - jeval._cosine(a_synth, jrec.speaker_embedding(other)))}
    assert ours.keys() == ref.keys()
    assert (ours["wer"], ours["hyp"]) == (ref["wer"], ref["hyp"])
    for k in ("margin_codec", "margin_mel", "margin_asr"):
        assert abs(ours[k] - ref[k]) <= SIM_TOL, k


def test_stage2_end_to_end_on_cpu(setup, tmp_path):
    """The CLI's stage 2 with a tiny random Flamed saved as .npz: a finite
    row for every item, the JAX tool's keys, and the wavs kept."""
    from flamed_tts_tpu_torch.config import save_yaml
    from flamed_tts_tpu_torch.convert import params_to_jax
    from flamed_tts_tpu_torch.models.flamed import Flamed
    from flamed_tts_tpu_torch.runtime.pytree_io import flatten_pytree

    cfg = small_config()
    cfg["dataset_cfg"].update(phoneme_buckets=[32, 64, 128], prompt_buckets=[128, 256, 512])  # 8-word texts, 3 s prompts
    model = Flamed(cfg, device="cpu")
    ckpt, cfg_path = str(tmp_path / "model.npz"), str(tmp_path / "cfg.yaml")
    np.savez(ckpt, **flatten_pytree({"prior": params_to_jax(model.prior.state_dict()),
                                     "prob": params_to_jax(model.prob.state_dict())}))
    save_yaml(cfg, cfg_path)
    out_json = str(tmp_path / "report.json")
    report = eval_discrimination.main(["--corpus", setup["corpus"], "--codec-dir", setup["codec_dir"],
                                       "--ckpt", ckpt, "--cfg", cfg_path, "--n-utts", "4",
                                       "--n-synth", "2", "--nsteps", "2", "--out-dir", str(tmp_path / "wavs"),
                                       "--out-json", out_json, "--device", "cpu"])
    assert json.load(open(out_json)) == report
    s2 = report["stage2"]
    assert s2["n_synth"] == 2 and s2["nfe"] == 2 and len(s2["items"]) == 2
    assert {"codec_timbre", "melstats", "asr_spk", "wer_synth"} <= set(s2)
    for row in s2["items"]:
        assert set(row) == {"spk", "vs", "text", "dur_s", "margin_codec", "margin_mel", "wer", "hyp",
                            "margin_asr"}
        assert all(np.isfinite(row[k]) for k in ("dur_s", "margin_codec", "margin_mel", "wer", "margin_asr"))
        assert row["spk"] != row["vs"] and row["dur_s"] > 0
    assert len(os.listdir(tmp_path / "wavs")) == 2


def test_render_eval_report_equals_jax(tmp_path, capsys, monkeypatch):
    report = {"corpus": "c", "n_items": 6,
              "stage1": {"codec_timbre": {"same_mean": 0.91, "diff_mean": 0.9, "margin": 0.01, "rank_acc": 0.6,
                                          "n_same_pairs": 4, "n_diff_pairs": 6},
                         "melstats": {"same_mean": 0.99, "diff_mean": 0.98, "margin": 0.01, "rank_acc": 0.9,
                                      "n_same_pairs": 4, "n_diff_pairs": 6}, "n_speakers": 2},
              "stage2": {"n_synth": 2, "nfe": 8, "codec_timbre": {"mean_margin": -0.01, "frac_positive": 0.5},
                         "melstats": {"mean_margin": 0.02, "frac_positive": 1.0},
                         "asr_spk": {"mean_margin": 0.3, "frac_positive": 1.0},
                         "wer_synth": {"mean": 0.75, "median": 0.75, "n": 2}, "items": []}}
    path = tmp_path / "r.json"
    path.write_text(json.dumps(report))
    monkeypatch.setattr(sys, "argv", ["render_eval_report.py", str(path)])
    jrender.main()
    ref = capsys.readouterr().out
    render_eval_report.main([str(path)])
    assert capsys.readouterr().out == ref and "### stage2" in ref
