"""The morphological closure of the core lexicon, as the JAX package's
``tools/expand_lexicon.py`` writes it:

    python -m flamed_tts_tpu_torch.expand_lexicon --out english-expanded.txt \
        [--lexicon-dir DIR]

Every verified stem of ``english-core.txt`` (read in place from the lexicon
directory, by default the JAX package's ``flamed_tts_tpu/lexicon/``) is
inflected and derived by the regular suffix and prefix rules of the
frontend (``text/frontend.py``: plurals, past, -ing, -er/-est, -ly, -ness,
-ment, -ful, -less, nine prefixes), and every word not already in the core
lexicon is written as ``WORD<TAB>PH ON EH0 Z``, sorted: the same file, byte
for byte, as the JAX tool's.  ``--out`` is required: the JAX default writes
into the lexicon directory, which belongs to the JAX package.  Host-only;
no device.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

from flamed_tts_tpu_torch.text.frontend import (_BUILTIN_LEXICON, _SUFFIX_PHONES, _past_phones,
                                                _plural_phones, read_lexicon)
from flamed_tts_tpu_torch.text.neural_g2p import DEFAULT_LEXICON_DIR

_VOWELS = "aeiou"


def plural_spelling(w: str) -> str:
    if w.endswith(("s", "x", "z", "ch", "sh")):
        return w + "es"
    if len(w) > 2 and w.endswith("y") and w[-2] not in _VOWELS:
        return w[:-1] + "ies"
    return w + "s"


def past_spelling(w: str) -> str:
    if w.endswith("e"):
        return w + "d"
    if len(w) > 2 and w.endswith("y") and w[-2] not in _VOWELS:
        return w[:-1] + "ied"
    return w + "ed"


def ing_spelling(w: str) -> str:
    if w.endswith("e") and not w.endswith(("ee", "oe", "ye")):
        return w[:-1] + "ing"
    return w + "ing"


def er_spelling(w: str, sfx: str) -> str:  # sfx in ("er", "est")
    if w.endswith("e"):
        return w + sfx[1:]
    if len(w) > 2 and w.endswith("y") and w[-2] not in _VOWELS:
        return w[:-1] + "i" + sfx
    return w + sfx


def ly_spelling(w: str) -> Optional[str]:
    if w.endswith("ly"):
        return None
    if len(w) > 2 and w.endswith("y") and w[-2] not in _VOWELS:
        return w[:-1] + "ily"
    if w.endswith("le"):
        return w[:-1] + "y"  # simple -> simply
    return w + "ly"


def ness_spelling(w: str) -> str:
    if len(w) > 2 and w.endswith("y") and w[-2] not in _VOWELS:
        return w[:-1] + "iness"
    return w + "ness"


_PREFIXES: List[Tuple[str, List[str]]] = [
    ("un", ["AH0", "N"]),
    ("re", ["R", "IY0"]),
    ("dis", ["D", "IH0", "S"]),
    ("mis", ["M", "IH0", "S"]),
    ("non", ["N", "AA1", "N"]),
    ("pre", ["P", "R", "IY0"]),
    ("over", ["OW1", "V", "ER0"]),
    ("out", ["AW1", "T"]),
    ("under", ["AH1", "N", "D", "ER0"]),
]


def _ily_phones(phones: List[str]) -> List[str]:
    # happy (HH AE1 P IY0) -> happily (HH AE1 P AH0 L IY0)
    if phones and phones[-1].rstrip("012") == "IY":
        return phones[:-1] + ["AH0", "L", "IY0"]
    return phones + _SUFFIX_PHONES["ly"]


def expand(core: Dict[str, List[str]]) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}

    def add(word: Optional[str], phones: List[str]):
        if not word or word in core:
            return
        out.setdefault(word, phones)

    for w, ph in core.items():
        if not w.isalpha() or len(w) < 2:
            continue
        ph = list(ph)
        pl = _plural_phones(ph)
        pa = _past_phones(ph)
        add(plural_spelling(w), pl)
        add(past_spelling(w), pa)
        add(ing_spelling(w), ph + _SUFFIX_PHONES["ing"])
        add(ing_spelling(w) + "s", _plural_phones(ph + _SUFFIX_PHONES["ing"]))
        er = er_spelling(w, "er")
        add(er, ph + _SUFFIX_PHONES["er"])
        add(plural_spelling(er), _plural_phones(ph + _SUFFIX_PHONES["er"]))
        add(er_spelling(w, "est"), ph + _SUFFIX_PHONES["est"])
        ly = ly_spelling(w)
        if ly:
            add(ly, _ily_phones(ph))
        add(ness_spelling(w), ph + _SUFFIX_PHONES["ness"])
        add(w + "ment", ph + _SUFFIX_PHONES["ment"])
        add(w + "ful", ph + _SUFFIX_PHONES["ful"])
        add(w + "less", ph + _SUFFIX_PHONES["less"])
        for pre, pre_ph in _PREFIXES:
            if not w.startswith(pre):
                add(pre + w, pre_ph + ph)
    return out


def write_expanded(out: str, lexicon_dir: str = DEFAULT_LEXICON_DIR) -> Tuple[int, int]:
    """Writes the closure of ``lexicon_dir``'s core lexicon to ``out``;
    returns (core stems, expanded entries)."""
    core = read_lexicon(os.path.join(lexicon_dir, _BUILTIN_LEXICON))
    expanded = expand(core)
    with open(out, "w", encoding="utf-8") as fout:
        for w in sorted(expanded):
            fout.write(f"{w.upper()}\t{' '.join(expanded[w])}\n")
    return len(core), len(expanded)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.expand_lexicon",
                                     description="Write the morphological closure of the core lexicon.")
    parser.add_argument("--out", required=True)
    parser.add_argument("--lexicon-dir", default=DEFAULT_LEXICON_DIR,
                        help="Directory of english-core.txt (default: the JAX package's lexicon/).")
    args = parser.parse_args(argv)
    n_core, n_exp = write_expanded(args.out, args.lexicon_dir)
    print(f"core {n_core} stems -> {n_exp} expanded entries ({n_core + n_exp} total) -> {args.out}")


if __name__ == "__main__":
    main()
