"""The phone recognizer's class inventory: silence plus the 39
stress-stripped base ARPAbet phones.  The codec trainer labels frames with
it (``phone_label``); the recognizer itself is not ported yet.
"""

from __future__ import annotations

from typing import Dict

BASE_PHONES = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG",
    "OW", "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W",
    "Y", "Z", "ZH",
]
SIL = 0  # covers sil/sp/spn/empty
PHONE_TO_ID: Dict[str, int] = {p: i + 1 for i, p in enumerate(BASE_PHONES)}
N_CLASSES = len(BASE_PHONES) + 1


def phone_label(text: str) -> int:
    """A TextGrid phone ("AH0", "sil", "") -> its class id."""
    return PHONE_TO_ID.get(text.rstrip("012"), SIL)
