"""Text -> phoneme ids for texts made of lexicon words, in plain Python.

The benchmark's texts are lower-case words of the built-in core lexicon
(CMUdict conventions) separated by single spaces.  For such a text the
served frontend's output is ``@sp`` followed by each word's first lexicon
entry, every phone as its id in the 360-symbol table the checkpoints were
trained on: 64 + its index in the ARPAbet inventory.  Nothing here imports
the program; the lexicon is the data file the program reads too.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CORE_LEXICON = os.path.join(REPO_ROOT, "flamed_tts_tpu", "lexicon", "english-core.txt")

ARPABET = (
    "AA AA0 AA1 AA2 AE AE0 AE1 AE2 AH AH0 AH1 AH2 AO AO0 AO1 AO2 "
    "AW AW0 AW1 AW2 AY AY0 AY1 AY2 B CH D DH EH EH0 EH1 EH2 "
    "ER ER0 ER1 ER2 EY EY0 EY1 EY2 F G HH IH IH0 IH1 IH2 "
    "IY IY0 IY1 IY2 JH K L M N NG OW OW0 OW1 OW2 OY OY0 OY1 OY2 "
    "P R S SH T TH UH UH0 UH1 UH2 UW UW0 UW1 UW2 V W Y Z ZH"
).split()
ARPABET_OFFSET = 64  # pad, special, 10 punctuation marks, 52 letters come first
SP_ID = 357          # "@sp", after the 84 ARPAbet and 209 pinyin symbols
N_SYMBOLS = 360
PHONE_ID = {p: ARPABET_OFFSET + i for i, p in enumerate(ARPABET)}


def read_words(path: str = CORE_LEXICON) -> Dict[str, Tuple[int, ...]]:
    """Lower-case alphabetic word -> phone ids of its first entry, for the
    words whose phones are all ARPAbet symbols."""
    words: Dict[str, Tuple[int, ...]] = {}
    seen = set()  # the first entry of a word is the one served
    with open(path, encoding="utf-8") as fin:
        for line in fin:
            fields = re.split(r"\s+", line.strip("\n"))
            if not fields[0]:
                continue
            key = fields[0].lower()
            if key in seen:
                continue
            seen.add(key)
            if not re.fullmatch(r"[a-z]+", key):
                continue
            phones = [p for p in fields[1:] if p]
            if phones and all(p in PHONE_ID for p in phones):
                words[key] = tuple(PHONE_ID[p] for p in phones)
    return words


def text_to_ids(text: str, words: Dict[str, Tuple[int, ...]]) -> List[int]:
    """The served frontend's ids for a text of lexicon words."""
    ids = [SP_ID]
    for word in text.split(" "):
        ids.extend(words[word])
    return ids
