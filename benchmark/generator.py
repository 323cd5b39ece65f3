"""The one generator of the benchmark's inputs: it reads a traffic mix
(``benchmark/traffic/<mix>.json``) and makes the requests from a seed.

Every seed gets the same multiset of sizes in another order (blocks of the
mix's sizes, each block shuffled), so a window of a given length does the
same work whatever the seed; the seed picks the order, the words, the
voices and the noise.

A mix names its ``driver`` (``benchmark/drivers/<driver>.py``, whose ``DRIVER`` is the loop
that feeds the program) and holds, as it needs:

* ``phonemes``: {"min", "max"}: every length from min to max once a block,
  counted as the served frontend counts them (a leading ``@sp`` and each
  word's phones);
* ``prompt_seconds``: each request's own voiced prompt wav;
* ``seconds``: {"min", "max", "median", "sigma", "levels"}: wav lengths at
  ``levels`` quantiles of a log-normal truncated to [min, max];
* ``batch``, ``speakers``, ``nfe``, ``temperature``, ``pool``.
"""

from __future__ import annotations

import functools
import json
import math
import os
from typing import Dict, List, Sequence

import numpy as np

from benchmark.reference.frontend import read_words

SR = 16000
MAX_PHONES_A_WORD = 15


def load(root: str, name: str) -> Dict:
    with open(os.path.join(root, "benchmark", "traffic", name + ".json"), encoding="utf-8") as f:
        return json.load(f)


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for request ``keys`` of run ``seed``."""
    state = np.random.SeedSequence([abs(int(seed)), *keys]).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([abs(int(seed)), *keys]))


def sizes(values: Sequence, count: int, seed: int, stream: int) -> List:
    """``count`` sizes: blocks of ``values``, each shuffled from the seed."""
    r, out = rng(seed, stream), []
    while len(out) < count:
        block = list(values)
        r.shuffle(block)
        out += block
    return out[:count]


@functools.lru_cache(maxsize=1)
def _words_by_length():
    words = read_words()
    by_len: Dict[int, List[str]] = {}
    for w, ph in sorted(words.items()):
        by_len.setdefault(len(ph), []).append(w)
    return by_len


def text(n_ids: int, r: np.random.Generator) -> str:
    """Lexicon words whose phones, after the leading ``@sp``, number
    ``n_ids - 1``."""
    by_len = _words_by_length()
    left, out = n_ids - 1, []
    while left > 0:
        if left <= MAX_PHONES_A_WORD and by_len.get(left) and (left <= 8 or r.random() < 0.5):
            n = left
        else:
            n = int(r.integers(2, min(8, left - 1) + 1)) if left > 2 else left
        pool = by_len[n]
        out.append(pool[int(r.integers(len(pool)))])
        left -= n
    return " ".join(out)


def voiced_wav(n_samples: int, r: np.random.Generator) -> np.ndarray:
    """Five harmonics of a slowly moving f0 (drawn per voice) under a
    syllable-rate envelope, plus a little noise."""
    t = np.arange(n_samples) / SR
    f0 = float(r.uniform(90.0, 260.0))
    f = f0 + 0.15 * f0 * np.sin(2 * np.pi * float(r.uniform(0.8, 2.5)) * t)
    phase = 2 * np.pi * np.cumsum(f) / SR
    env = 0.5 + 0.5 * np.sin(2 * np.pi * float(r.uniform(2.0, 5.0)) * t + float(r.uniform(0, 6.3))) ** 2
    wav = sum(np.sin(k * phase) / k for k in range(1, 6)) * env
    return (0.2 * wav + 0.01 * r.standard_normal(n_samples)).astype(np.float32)


def lognormal_levels(spec: Dict) -> List[float]:
    """``levels`` quantiles of a log-normal (median, sigma) cut to [min, max]."""
    from statistics import NormalDist

    nd = NormalDist(math.log(spec["median"]), spec["sigma"])
    lo, hi = nd.cdf(math.log(spec["min"])), nd.cdf(math.log(spec["max"]))
    n = spec["levels"]
    return [round(math.exp(nd.inv_cdf(lo + (hi - lo) * (k + 0.5) / n)), 3) for k in range(n)]


def utterances(mix: Dict, seed: int, count: int, stream: int = 0) -> List[Dict]:
    """Serving requests: {"text", "n_ids", "prompt" (wav), "seed"}; stream 0
    is the window's, others are warm-up's."""
    lo, hi = mix["phonemes"]["min"], mix["phonemes"]["max"]
    out = []
    for i, n in enumerate(sizes(range(lo, hi + 1), count, seed, 2 * stream)):
        r = rng(seed, 2 * stream + 1, i)
        req = {"n_ids": int(n), "text": text(int(n), r), "seed": sub_seed(seed, 2 * stream + 1, i)}
        if mix.get("prompt_seconds"):
            req["prompt"] = voiced_wav(int(mix["prompt_seconds"] * SR), r)
        out.append(req)
    return out


def speakers(mix: Dict, seed: int) -> List[np.ndarray]:
    """The prompt cache's voices."""
    return [voiced_wav(int(mix["prompt_seconds"] * SR), rng(seed, 101, k)) for k in range(mix["speakers"])]


def waves(mix: Dict, seed: int, count: int, stream: int = 0) -> List[Dict]:
    """Codec requests: {"wav", "seconds"}."""
    out = []
    for i, s in enumerate(sizes(lognormal_levels(mix["seconds"]), count, seed, 2 * stream)):
        out.append({"seconds": s, "wav": voiced_wav(int(round(s * SR)), rng(seed, 2 * stream + 1, i))})
    return out
