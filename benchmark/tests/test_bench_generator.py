"""The one generator: a seed fixes the requests, seeds differ in order and
content, not in the work they ask for."""

from __future__ import annotations

import numpy as np

from benchmark import generator
from benchmark.harness import ROOT
from benchmark.reference.frontend import read_words, text_to_ids

SERVE = {"phonemes": {"min": 50, "max": 126}, "prompt_seconds": 0.25}
CODEC = {"seconds": {"min": 1.0, "max": 16.6, "median": 5.0, "sigma": 0.6, "levels": 32}}


def test_every_mix_loads():
    for name in ("single_text_prompt_wav", "batch4_prompt_cache", "libritts_round_trip"):
        assert generator.load(ROOT, name)["driver"] in ("serve", "codec")


def test_same_seed_same_requests():
    a, b = generator.utterances(SERVE, 2**31 + 5, 30), generator.utterances(SERVE, 2**31 + 5, 30)
    assert [r["text"] for r in a] == [r["text"] for r in b]
    assert [r["seed"] for r in a] == [r["seed"] for r in b]
    assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(a, b))
    w1, w2 = generator.waves(CODEC, 3, 8), generator.waves(CODEC, 3, 8)
    assert all(np.array_equal(x["wav"], y["wav"]) for x, y in zip(w1, w2))


def test_seeds_differ_in_order_and_content_not_in_sizes():
    a, b = generator.utterances(SERVE, 11, 77), generator.utterances(SERVE, 12, 77)
    assert [r["text"] for r in a] != [r["text"] for r in b]
    assert sorted(r["n_ids"] for r in a) == sorted(r["n_ids"] for r in b) == list(range(50, 127))
    w1, w2 = generator.waves(CODEC, 1, 32), generator.waves(CODEC, 2, 32)
    assert sorted(r["seconds"] for r in w1) == sorted(r["seconds"] for r in w2)
    assert [r["seconds"] for r in w1] != [r["seconds"] for r in w2]


def test_texts_have_the_asked_phoneme_count():
    words = read_words()
    for r in generator.utterances(SERVE, 7, 40):
        assert len(text_to_ids(r["text"], words)) == r["n_ids"]


def test_codec_lengths_follow_the_truncated_lognormal():
    levels = generator.lognormal_levels(CODEC["seconds"])
    assert 1.0 <= min(levels) and max(levels) <= 16.6
    assert 4.0 <= float(np.median(levels)) <= 6.0
