"""Rule-based English grapheme-to-phoneme fallback.

The last resort for words missing from the lexicons: a compact
letter-to-sound rule engine producing ARPAbet.  ``g2p_en`` (when it is
importable) and the neural G2P are tried first (see frontend.py).

This is intentionally simple: the LibriSpeech lexicon covers the vast
majority of words; the fallback only needs to produce pronounceable,
deterministic output for the tail.
"""

from __future__ import annotations

import re
from typing import List

# Ordered rules: (pattern at current position, phones, chars consumed).
# Longest-match-first within each leading letter.  Vowel phones carry no
# stress here; stress is assigned afterwards (primary on first vowel).
_RULES = [
    # multi-letter consonant clusters / digraphs
    ("tion", ["SH", "AH0", "N"]), ("sion", ["ZH", "AH0", "N"]),
    ("ough", ["AO", "F"]), ("augh", ["AE", "F"]),
    ("igh", ["AY"]), ("tch", ["CH"]), ("dge", ["JH"]),
    ("sch", ["S", "K"]), ("chr", ["K", "R"]),
    ("ck", ["K"]), ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]),
    ("ph", ["F"]), ("wh", ["W"]), ("gh", ["G"]), ("ng", ["NG"]),
    ("qu", ["K", "W"]), ("wr", ["R"]), ("kn", ["N"]), ("gn", ["N"]),
    ("ps", ["S"]), ("mb$", ["M"]), ("cc", ["K", "S"]),
    # vowel teams
    ("eau", ["OW"]), ("iou", ["IY", "AH0"]),
    ("ai", ["EY"]), ("ay", ["EY"]), ("ea", ["IY"]), ("ee", ["IY"]),
    ("ei", ["EY"]), ("ey", ["IY"]), ("ie", ["IY"]), ("oa", ["OW"]),
    ("oe", ["OW"]), ("oi", ["OY"]), ("oy", ["OY"]), ("oo", ["UW"]),
    ("ou", ["AW"]), ("ow", ["OW"]), ("ue", ["UW"]), ("ui", ["UW"]),
    ("au", ["AO"]), ("aw", ["AO"]), ("eu", ["UW"]), ("ew", ["UW"]),
    # r-controlled vowels
    ("ar", ["AA", "R"]), ("er", ["ER"]), ("ir", ["ER"]),
    ("or", ["AO", "R"]), ("ur", ["ER"]),
    # single letters
    ("a", ["AE"]), ("b", ["B"]), ("c", ["K"]), ("d", ["D"]),
    ("e", ["EH"]), ("f", ["F"]), ("g", ["G"]), ("h", ["HH"]),
    ("i", ["IH"]), ("j", ["JH"]), ("k", ["K"]), ("l", ["L"]),
    ("m", ["M"]), ("n", ["N"]), ("o", ["AA"]), ("p", ["P"]),
    ("r", ["R"]), ("s", ["S"]), ("t", ["T"]), ("u", ["AH"]),
    ("v", ["V"]), ("w", ["W"]), ("x", ["K", "S"]), ("y", ["IY"]),
    ("z", ["Z"]),
]

_VOWEL_PHONES = {
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
}

_SOFT_C_E = re.compile(r"^c[eiy]")
_SOFT_G_E = re.compile(r"^g[eiy]")

# Tiny built-in lexicon of the most frequent English words whose
# pronunciations letter-to-sound rules get wrong (function words and
# irregulars).  These dominate running text, so fixing them lifts
# lexicon-less output quality substantially.
_COMMON_WORDS = {
    "the": "DH AH0", "a": "AH0", "an": "AE1 N", "of": "AH1 V",
    "to": "T UW1", "and": "AE1 N D", "in": "IH1 N", "is": "IH1 Z",
    "was": "W AA1 Z", "he": "HH IY1", "she": "SH IY1", "be": "B IY1",
    "we": "W IY1", "me": "M IY1", "are": "AA1 R", "were": "W ER1",
    "you": "Y UW1", "your": "Y AO1 R", "they": "DH EY1",
    "their": "DH EH1 R", "there": "DH EH1 R", "this": "DH IH1 S",
    "that": "DH AE1 T", "these": "DH IY1 Z", "those": "DH OW1 Z",
    "have": "HH AE1 V", "has": "HH AE1 Z", "had": "HH AE1 D",
    "do": "D UW1", "does": "D AH1 Z", "done": "D AH1 N",
    "one": "W AH1 N", "once": "W AH1 N S", "two": "T UW1",
    "who": "HH UW1", "what": "W AH1 T", "where": "W EH1 R",
    "why": "W AY1", "how": "HH AW1", "when": "W EH1 N",
    "would": "W UH1 D", "could": "K UH1 D", "should": "SH UH1 D",
    "said": "S EH1 D", "says": "S EH1 Z", "some": "S AH1 M",
    "come": "K AH1 M", "comes": "K AH1 M Z", "from": "F R AH1 M",
    "my": "M AY1", "by": "B AY1", "i": "AY1", "eye": "AY1",
    "here": "HH IY1 R", "very": "V EH1 R IY0", "any": "EH1 N IY0",
    "many": "M EH1 N IY0", "only": "OW1 N L IY0", "people": "P IY1 P AH0 L",
    "water": "W AO1 T ER0", "because": "B IH0 K AO1 Z",
    "through": "TH R UW1", "though": "DH OW1", "thought": "TH AO1 T",
    "again": "AH0 G EH1 N", "against": "AH0 G EH1 N S T",
    "world": "W ER1 L D", "work": "W ER1 K", "word": "W ER1 D",
    "one's": "W AH1 N Z", "its": "IH1 T S", "it's": "IH1 T S",
    "it": "IH1 T", "as": "AE1 Z", "at": "AE1 T", "or": "AO1 R",
    "for": "F AO1 R", "nor": "N AO1 R", "so": "S OW1", "no": "N OW1",
    "go": "G OW1", "goes": "G OW1 Z", "gone": "G AO1 N",
    "been": "B IH1 N", "being": "B IY1 IH0 NG", "into": "IH1 N T UW0",
    "over": "OW1 V ER0", "under": "AH1 N D ER0", "other": "AH1 DH ER0",
    "another": "AH0 N AH1 DH ER0", "mother": "M AH1 DH ER0",
    "father": "F AA1 DH ER0", "brother": "B R AH1 DH ER0",
    "love": "L AH1 V", "move": "M UW1 V", "lose": "L UW1 Z",
    "whose": "HH UW1 Z", "both": "B OW1 TH", "most": "M OW1 S T",
    "old": "OW1 L D", "cold": "K OW1 L D", "don't": "D OW1 N T",
    "won't": "W OW1 N T", "can't": "K AE1 N T", "says's": "S EH1 Z",
    "early": "ER1 L IY0", "heart": "HH AA1 R T", "great": "G R EY1 T",
    "above": "AH0 B AH1 V", "among": "AH0 M AH1 NG",
}


def _apply_rules(word: str) -> List[str]:
    phones: List[str] = []
    i = 0
    n = len(word)
    while i < n:
        rest = word[i:]
        # Context-sensitive softenings.
        if _SOFT_C_E.match(rest):
            phones.append("S")
            i += 1
            continue
        if _SOFT_G_E.match(rest):
            phones.append("JH")
            i += 1
            continue
        # Silent final e after a consonant (magic e).
        if rest == "e" and phones and phones[-1] not in _VOWEL_PHONES and len(word) > 2:
            break
        matched = False
        for pattern, rule_phones in _RULES:
            if pattern.endswith("$"):
                stem = pattern[:-1]
                if rest == stem:
                    phones.extend(rule_phones)
                    i += len(stem)
                    matched = True
                    break
            elif rest.startswith(pattern):
                phones.extend(rule_phones)
                i += len(pattern)
                matched = True
                break
        if not matched:
            i += 1  # skip unpronounceable character
    return phones


def rule_g2p(word: str) -> List[str]:
    """ARPAbet phones for a single word (lowercase letters only kept)."""
    lowered = re.sub(r"[^a-z']", "", word.lower())
    if lowered in _COMMON_WORDS:
        return _COMMON_WORDS[lowered].split()
    cleaned = lowered.replace("'", "")
    if not cleaned:
        return []
    if cleaned in _COMMON_WORDS:
        return _COMMON_WORDS[cleaned].split()
    phones = _apply_rules(cleaned)
    # Stress: primary on the first vowel, none elsewhere; phones already
    # carrying an explicit stress digit (e.g. AH0 from -tion) keep it.
    out: List[str] = []
    stressed = False
    for p in phones:
        if p in _VOWEL_PHONES:
            if not stressed:
                out.append(p + "1")
                stressed = True
            else:
                out.append(p + "0")
        else:
            out.append(p)
    return out
