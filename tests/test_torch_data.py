"""The port's data layer against the JAX package's, array for array: the
alignment from TextGrid phones, the manifest filter, the datasets, the
bucketed collator and the batch iterator; the training config; the
synthetic corpus and the precompute step (CPU, a narrow random codec)."""

import json
import os

import numpy as np
import pytest
import torch

from flamed_tts_tpu.config import compose_training_config as j_compose_training_config
from flamed_tts_tpu.data import dataset as jds
from flamed_tts_tpu.utils.textgrid import get_tier as j_get_tier

from flamed_tts_tpu_torch.config import compose_training_config, load_yaml, save_yaml
from flamed_tts_tpu_torch.data import dataset as ds
from flamed_tts_tpu_torch.data.synthetic import FPS, HOP, SR, fabricate_corpus
from flamed_tts_tpu_torch.utils.textgrid import get_tier, write_textgrid

from torch_parity_utils import ROOT

CONFIG_NAMES = ("prior", "prob", "codec", "optimizer", "data")


def _item(rng, l, lf):
    return {"phoneme": rng.randint(1, 300, l).astype(np.int32),
            "code": rng.randint(0, 1024, (6, lf)).astype(np.int32),
            "emb": rng.randn(lf, 256).astype(np.float32),
            "spk": rng.randn(256).astype(np.float32),
            "phone_dur": rng.randint(1, 4, l).astype(np.int32),
            "sil_dur": rng.randint(0, 2, l).astype(np.int32)}


def _assert_batches_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


INTERVALS = [(0.0, 0.1, "sil"), (0.1, 0.2, "HH"), (0.2, 0.3375, "AH0"), (0.3375, 0.4, ""),
             (0.4, 0.55, "L"), (0.55, 0.6, "sp"), (0.6, 0.9, "OW1"), (0.9, 1.0, "sil")]


def test_textgrid_and_alignment_match(tmp_path):
    path = str(tmp_path / "a.TextGrid")
    write_textgrid(path, INTERVALS)
    ours, theirs = get_tier(path, "phones"), j_get_tier(path, "phones")
    assert [(i.start_time, i.end_time, i.text) for i in ours] == \
           [(i.start_time, i.end_time, i.text) for i in theirs]
    assert [i.text for i in ours] == [t for _, _, t in INTERVALS]
    assert ds.compute_alignment(ours, SR, HOP) == jds.compute_alignment(theirs, SR, HOP)
    with pytest.raises(KeyError, match="words"):
        get_tier(path, "words")


def test_filter_manifest_matches():
    lines = ["a.npz|2.0|one two three", "b.npz|0.2|one two three four", "c.npz|3.0|too short",
             "broken line", "d.npz|nan?|one two three", "e.npz|20.0|one two three four",
             "", "f.npz|5.5|five words are here now"]
    assert ds._filter_manifest(lines, 1.0, 16.6, 3) == jds._filter_manifest(lines, 1.0, 16.6, 3)


@pytest.mark.parametrize("prompt_buckets", [None, [16, 32, 64]])
def test_collator_and_iterator_match(prompt_buckets):
    """The same items and seed give the JAX collator's batches, crops
    included, over two shuffled epochs and an unshuffled pass that keeps a
    last partial batch."""
    rng = np.random.RandomState(0)
    items = [_item(rng, int(rng.randint(5, 40)), int(rng.randint(20, 150))) for _ in range(7)]
    kw = dict(vocab_size=1024, prompt_max_len=60, prompt_reduced_factor=0.8,
              phoneme_buckets=[16, 32, 64], frame_buckets=[64, 128, 256],
              prompt_buckets=prompt_buckets, seed=3)
    ours, theirs = ds.BucketedCollator(**kw), jds.BucketedCollator(**kw)
    n = 0
    for epoch in range(2):
        for a, b in zip(ds.batch_iterator(items, ours, 3, shuffle=True, seed=epoch),
                        jds.batch_iterator(items, theirs, 3, shuffle=True, seed=epoch)):
            _assert_batches_equal(a, b)
            n += 1
    pairs = list(zip(ds.batch_iterator(items, ours, 3, shuffle=False, drop_last=False),
                     jds.batch_iterator(items, theirs, 3, shuffle=False, drop_last=False)))
    for a, b in pairs:
        _assert_batches_equal(a, b)
    assert n == 4 and len(pairs) == 3 and pairs[-1][0]["phonemes"].shape[0] == 1
    assert np.all(pairs[0][0]["prompts"][:, 1:3] == 1024)  # content quantizers masked


def test_precomputed_dataset_matches(tmp_path):
    rng = np.random.RandomState(1)
    lines = []
    for i in range(4):
        np.savez(tmp_path / f"u{i}.npz", **_item(rng, 10 + i, 40 + i), extra=np.zeros(2))
        lines.append(f"u{i}.npz|{1.5 + i}|one two three")
    (tmp_path / "m.txt").write_text("\n".join(lines + ["u9.npz|0.1|filtered out"]) + "\n")
    kw = dict(data_root=str(tmp_path), manifest="m.txt", dur_min=1.0, dur_max=4.0,
              n_words_min=3, seed=5)
    ours, theirs = ds.PrecomputedDataset(**kw), jds.PrecomputedDataset(**kw)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        a, b = ours[i], theirs[i]
        assert list(a) == list(ds.REQUIRED_FIELDS)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    (tmp_path / "bad.txt").write_text("missing.npz|2.0|one two three\n")
    with pytest.raises(FileNotFoundError, match="Missing precomputed sample"):
        ds.PrecomputedDataset(**dict(kw, manifest="bad.txt"))


def test_text_codes_dataset_matches(tmp_path):
    rng = np.random.RandomState(2)
    lines = []
    for i in range(3):
        tg = str(tmp_path / f"u{i}.TextGrid")
        write_textgrid(tg, INTERVALS)
        lf = 80
        codes = str(tmp_path / f"u{i}.json")
        with open(codes, "w") as f:
            json.dump({"spkemb": rng.randn(256).tolist(),
                       "quantizers": rng.randint(0, 1024, (6, lf)).tolist(),
                       "vqemb": rng.randn(lf, 256).tolist()}, f)
        lines.append(f"u{i}|1.0|hello low one|x|{tg}|{codes}|y")
    (tmp_path / "m.txt").write_text("\n".join(lines) + "\n")
    kw = dict(data_root=str(tmp_path), manifest="m.txt", cleaners=["english_cleaners"],
              dur_min=0.5, dur_max=2.0, n_words_min=3, seed=1)
    ours, theirs = ds.TextCodesDataset(**kw), jds.TextCodesDataset(**kw)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        a, b = ours[i], theirs[i]
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert len(ours[0]["phoneme"]) == 5  # sp HH AH0 L OW1: the silences fold into durations


def test_training_config_matches(tmp_path):
    paths = [os.path.join(ROOT, "configs", f"{n}.yaml") for n in CONFIG_NAMES]
    overrides = {"optimizer_cfg": {"lr": 1e-3, "warmup_steps": 0},
                 "dataset_cfg": {"batch_size": 2}}
    ours = compose_training_config(*paths, overrides=overrides)
    theirs = j_compose_training_config(*paths, overrides=overrides).to_dict()
    assert ours == theirs
    assert ours["optimizer_cfg"]["lr"] == 1e-3 and ours["optimizer_cfg"]["max_steps"] == 500000
    save_yaml(ours, str(tmp_path / "config.yaml"))
    assert load_yaml(str(tmp_path / "config.yaml")) == ours


def test_synthetic_corpus_aligns_on_code_frames(tmp_path):
    seconds = [1.0, 2.5, 4.0]
    manifest = fabricate_corpus(str(tmp_path), seconds, seed=0)
    lines = open(manifest).read().split("\n")[:-1]
    assert len(lines) == 3
    for line, sec in zip(lines, seconds):
        wav_path, tg_path, transcript = line.split("|")
        assert len(transcript.split()) >= 3
        intervals = get_tier(tg_path, "phones")
        frames = round(intervals[-1].end_time * FPS)
        assert abs(frames - sec * FPS) <= 1
        from flamed_tts_tpu_torch.utils.audio import load_wav

        assert len(load_wav(wav_path)) == frames * HOP
        phones, phone_dur, sil_dur = ds.compute_alignment(intervals, SR, HOP)
        assert phones[0] == "sp" and min(phone_dur[1:]) >= 1
        # the boundaries fall on whole frames, up to a frame's floor at most
        assert frames - 1 <= sum(phone_dur) + sum(sil_dur) <= frames


def test_precompute_writes_the_training_set(tmp_path):
    """The precompute step on the CPU with a narrow random codec: one .npz a
    line with the codec's own codes and timbre, the three manifests, and a
    set the trainer's dataset reads."""
    from flamed_tts_tpu_torch.config import load_default_config
    from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
    from flamed_tts_tpu_torch.precompute import analyze_utterance, precompute
    from flamed_tts_tpu_torch.utils.audio import load_wav

    codec_cfg = load_default_config()["codec_cfg"]
    codec_cfg["encoder"]["ngf"] = 4  # encoder widths 8-64: the same code path, cheap on the CPU
    codec_cfg["decoder"]["upsample_initial_channel"] = 64
    codec = FaCodec.random_init(torch.Generator().manual_seed(0), device="cpu", codec_cfg=codec_cfg)
    manifest = fabricate_corpus(str(tmp_path / "corpus"), [1.2, 0.9, 1.5, 1.1, 1.3, 0.8], seed=1)
    lines = open(manifest).read().split("\n")[:-1]
    out = tmp_path / "npz"
    stats = precompute(lines + ["missing.wav|missing.TextGrid|a b c"], str(out), codec, valid_n=2)
    assert stats["done"] == 6 and stats["failed"] == 1 and stats["n_valid"] == 1
    train = open(out / "train_manifest.txt").read().split("\n")[:-1]
    valid = open(out / "valid_manifest.txt").read().split("\n")[:-1]
    assert len(train) == 5 and len(valid) == 1
    wav_path = lines[0].split("|")[0]
    sample = np.load(out / "utt00000.npz")
    ref = analyze_utterance(codec, load_wav(wav_path))
    codes, timbre = codec.encode_prompt(load_wav(wav_path))
    np.testing.assert_array_equal(sample["code"], codes)
    np.testing.assert_array_equal(sample["spk"], timbre)
    np.testing.assert_array_equal(sample["emb"], ref["emb"])
    assert sample["emb"].shape == (codes.shape[1], 256) and sample["code"].dtype == np.int32
    assert len(sample["phoneme"]) == len(sample["phone_dur"]) == len(sample["sil_dur"])
    dset = ds.PrecomputedDataset(str(out), "train_manifest.txt", dur_min=0.5, dur_max=2.0)
    assert len(dset) == 5 and set(dset[0]) == set(ds.REQUIRED_FIELDS)


def test_precompute_cli_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from flamed_tts_tpu_torch.precompute import main

    manifest = tmp_path / "m.txt"
    manifest.write_text("a.wav|a.TextGrid|a b c\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--manifest", str(manifest), "--out-dir", str(tmp_path / "o"), "--codec-dir", "random"])
