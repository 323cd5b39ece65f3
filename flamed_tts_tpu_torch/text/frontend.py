"""English text -> phoneme-id preprocessing (host side).

Strip trailing punctuation, split on punctuation/whitespace, look each word up in a pronouncing lexicon with a
G2P fallback, wrap as "{sp ...}", and run through ``text_to_sequence``.
"""

from __future__ import annotations

import os
import re
from string import punctuation
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flamed_tts_tpu_torch.text import text_to_sequence
from flamed_tts_tpu_torch.text.g2p_fallback import rule_g2p
from flamed_tts_tpu_torch.text.neural_g2p import DEFAULT_LEXICON_DIR, try_load_neural_g2p
from flamed_tts_tpu_torch.text.numbers_norm import normalize_numbers

_WORD_SPLIT_RE = re.compile(r"([,;.\-\?\!\s+])")
_EMPTY_BRACE_RE = re.compile(r"\{[^\w\s]?\}")

# The lexicons are data files of the JAX package, read in place (15 MB;
# not copied): a user lexicon in the LibriSpeech format, the built-in core
# lexicon (CMUdict conventions) and its morphological closure (~200k
# derived entries), and the neural G2P's weights.
_DEFAULT_LEXICON = "librispeech-lexicon.txt"
_BUILTIN_LEXICON = "english-core.txt"
_EXPANDED_LEXICON = "english-expanded.txt"
_G2P_WEIGHTS = "g2p_weights.npz"


def read_lexicon(path: str) -> Dict[str, List[str]]:
    """Parse a whitespace-separated word -> phones lexicon file.

    First occurrence of each (lowercased) word wins.  A missing file yields
    an empty lexicon (the G2P fallback then handles every word).
    """
    lexicon: Dict[str, List[str]] = {}
    if not os.path.isfile(path):
        return lexicon
    with open(path, encoding="utf-8") as fin:
        for line in fin:
            fields = re.split(r"\s+", line.strip("\n"))
            if not fields or not fields[0]:
                continue
            word, phones = fields[0], fields[1:]
            key = word.lower()
            if key not in lexicon:
                lexicon[key] = phones
    return lexicon


# --- morphological inflection over lexicon stems -----------------------
# English inflectional suffixes are phonologically regular: deriving
# "walked" from the verified lexicon entry for "walk" is more reliable
# than sending the whole surface form through any G2P.

_VOICELESS = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}
_SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}
_VOWELS = {
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
}


def _base(phone: str) -> str:
    return phone.rstrip("012")


def _plural_phones(phones: List[str]) -> List[str]:
    last = _base(phones[-1])
    if last in _SIBILANT:
        return phones + ["IH0", "Z"]
    if last in _VOICELESS:
        return phones + ["S"]
    return phones + ["Z"]


def _past_phones(phones: List[str]) -> List[str]:
    last = _base(phones[-1])
    if last in ("T", "D"):
        return phones + ["IH0", "D"]
    if last in _VOICELESS:
        return phones + ["T"]
    return phones + ["D"]


_SUFFIX_PHONES = {
    "ing": ["IH0", "NG"],
    "er": ["ER0"],
    "est": ["AH0", "S", "T"],
    "ly": ["L", "IY0"],
    "ness": ["N", "AH0", "S"],
    "ful": ["F", "AH0", "L"],
    "less": ["L", "AH0", "S"],
    "ment": ["M", "AH0", "N", "T"],
    "y": ["IY0"],
}


def _stem_candidates(word: str, suffix: str) -> List[str]:
    """Plausible dictionary stems for word = stem-variant + suffix."""
    stem = word[: len(word) - len(suffix)]
    cands = [stem]
    if len(stem) >= 2 and stem[-1] == stem[-2]:  # stopped -> stop
        cands.append(stem[:-1])
    if stem and stem[-1] != "e":  # making -> make
        cands.append(stem + "e")
    if stem.endswith("i"):  # carried -> carry, stories -> story
        cands.append(stem[:-1] + "y")
    return cands


def inflect_oov(word: str, lookup) -> Optional[List[str]]:
    """Derive phones for an inflected form whose stem ``lookup`` knows.

    ``lookup(stem) -> Optional[List[str]]``.  Returns None when no
    (suffix, stem) decomposition hits the lexicon.
    """
    w = word.lower()
    # Possessives: 's voices like the plural suffix; bare trailing
    # apostrophe (plural possessive) adds nothing to an -s form.
    if w.endswith("'s") and len(w) > 2:
        phones = lookup(w[:-2]) or inflect_oov(w[:-2], lookup)
        if phones:
            return _plural_phones(list(phones))
    if w.endswith("'") and len(w) > 1:
        phones = lookup(w[:-1]) or inflect_oov(w[:-1], lookup)
        if phones:
            return list(phones)
    # Order matters: longest suffixes first so "-iness"/"-ingly" style
    # stacks resolve greedily from the end.
    # cries/carried: the stem restores -y; resolve those eagerly so a
    # spurious shorter stem ("store" for "stories") can't shadow them.
    for sfx, kind in (("ies", "s"), ("ied", "ed")):
        if w.endswith(sfx) and len(w) > 4:
            phones = lookup(w[: -len(sfx)] + "y")
            if phones:
                return (
                    _plural_phones(list(phones))
                    if kind == "s"
                    else _past_phones(list(phones))
                )
    trials: List[Tuple[str, str]] = []
    if w.endswith("es") and len(w) > 3:
        trials.append(("es", "s"))
    if w.endswith("s") and not w.endswith("ss") and len(w) > 2:
        trials.append(("s", "s"))
    if w.endswith("ed") and len(w) > 3:
        trials.append(("ed", "ed"))
    if w.endswith("d") and len(w) > 2:
        trials.append(("d", "ed"))
    for sfx in ("ing", "ness", "ment", "less", "ful", "est", "er", "ly", "y"):
        if w.endswith(sfx) and len(w) > len(sfx) + 1:
            trials.append((sfx, sfx))
    for spelling, kind in trials:
        for stem in _stem_candidates(w, spelling):
            phones = lookup(stem)
            if not phones:
                continue
            if kind == "s":
                return _plural_phones(list(phones))
            if kind == "ed":
                return _past_phones(list(phones))
            return list(phones) + _SUFFIX_PHONES[kind]
    return None


def _load_optional_g2p():
    try:  # pragma: no cover - exercised only when g2p_en is installed
        from g2p_en import G2p

        return G2p()
    except Exception:
        return None


class EnglishFrontend:
    """Stateful frontend bundling the lexicon and the G2P fallback."""

    def __init__(
        self,
        lexicon_path: Optional[str] = None,
        cleaners: Sequence[str] = ("english_cleaners",),
        use_builtin_lexicon: bool = True,
        lexicon_dir: str = DEFAULT_LEXICON_DIR,
    ):
        """``lexicon_dir`` holds the built-in lexicons and the neural G2P's
        weights; its default is the JAX package's ``lexicon/`` directory,
        whose files are read where they are."""
        self.lexicon_dir = lexicon_dir
        self.lexicon = read_lexicon(lexicon_path or os.path.join(lexicon_dir, _DEFAULT_LEXICON))
        # Built-in core entries fill behind the user lexicon (user wins);
        # the expanded morphological closure sits behind both.
        self.builtin = self.expanded = {}
        if use_builtin_lexicon:
            self.builtin = read_lexicon(os.path.join(lexicon_dir, _BUILTIN_LEXICON))
            self.expanded = read_lexicon(os.path.join(lexicon_dir, _EXPANDED_LEXICON))
        self.cleaners = list(cleaners)
        self._g2p = _load_optional_g2p()
        self._neural = None
        self._neural_tried = False

    def _lookup(self, word: str) -> Optional[List[str]]:
        key = word.lower()
        hit = (self.lexicon.get(key) or self.builtin.get(key)
               or self.expanded.get(key))
        return list(hit) if hit else None

    def _neural_g2p(self):
        """Lazy-load the trained neural G2P (None if weights absent)."""
        if not self._neural_tried:
            self._neural_tried = True
            self._neural = try_load_neural_g2p(os.path.join(self.lexicon_dir, _G2P_WEIGHTS))
        return self._neural

    def word_to_phones(self, word: str) -> List[str]:
        hit = self._lookup(word)
        if hit is not None:
            return hit
        derived = inflect_oov(word, self._lookup)
        if derived is not None:
            return derived
        # OOV fallback chain, best model first: g2p_en when installed, then
        # the repo-trained neural G2P, then letter-to-sound rules.
        if self._g2p is not None:
            return [p for p in self._g2p(word) if p != " "]
        neural = self._neural_g2p()
        if neural is not None:
            phones = neural(word)
            if phones:
                return phones
        return rule_g2p(word)

    def text_to_phone_string(self, text: str) -> str:
        # g2p_en normalizes digits internally; the rule fallback does not,
        # so expand numbers up front.
        text = normalize_numbers(text)
        text = text.rstrip(punctuation)
        phones: List[str] = []
        for word in _WORD_SPLIT_RE.split(text):
            if not word:
                continue
            phones.extend(self.word_to_phones(word))
        phone_string = "{sp " + " ".join(phones) + "}"
        phone_string = _EMPTY_BRACE_RE.sub("{sp}", phone_string)
        return phone_string.replace("}{", " ")

    def __call__(self, text: str) -> Tuple[np.ndarray, str, str]:
        """Return (phoneme ids int32 [1, L], original text, phone string)."""
        phone_string = self.text_to_phone_string(text)
        sequence = np.asarray(
            text_to_sequence(phone_string, self.cleaners), dtype=np.int32
        )
        return sequence[None, :], text, phone_string
