"""Host-side text frontend: text -> symbol-id sequences.

Keithito-Tacotron-lineage frontend with the symbol ids the checkpoints
were trained on: curly-brace regions are treated
as ARPAbet/pinyin phone runs (bypassing cleaners), everything else goes
through the configured cleaners and is mapped character-wise.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Sequence

from flamed_tts_tpu_torch.text import cleaners as _cleaners_mod
from flamed_tts_tpu_torch.text.symbols import ID_TO_SYMBOL, SYMBOL_TO_ID, symbols  # noqa: F401

_CURLY_RE = re.compile(r"(.*?)\{(.+?)\}(.*)")


def _clean(text: str, cleaner_names: Iterable[str]) -> str:
    for name in cleaner_names:
        cleaner = getattr(_cleaners_mod, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _keep(symbol: str) -> bool:
    return symbol in SYMBOL_TO_ID and symbol not in ("_", "~")


def _chars_to_ids(text: str) -> List[int]:
    return [SYMBOL_TO_ID[ch] for ch in text if _keep(ch)]


def _phones_to_ids(phone_run: str) -> List[int]:
    return [
        SYMBOL_TO_ID[tagged]
        for tagged in ("@" + p for p in phone_run.split())
        if _keep(tagged)
    ]


def text_to_sequence(text: str, cleaner_names: Sequence[str]) -> List[int]:
    """Convert text (with optional {ARPAbet ...} runs) to symbol ids."""
    sequence: List[int] = []
    while text:
        match = _CURLY_RE.match(text)
        if not match:
            sequence.extend(_chars_to_ids(_clean(text, cleaner_names)))
            break
        sequence.extend(_chars_to_ids(_clean(match.group(1), cleaner_names)))
        sequence.extend(_phones_to_ids(match.group(2)))
        text = match.group(3)
    return sequence


def sequence_to_text(sequence: Iterable[int]) -> str:
    parts: List[str] = []
    for symbol_id in sequence:
        symbol = ID_TO_SYMBOL.get(int(symbol_id))
        if symbol is None:
            continue
        if len(symbol) > 1 and symbol.startswith("@"):
            symbol = "{%s}" % symbol[1:]
        parts.append(symbol)
    return "".join(parts).replace("}{", " ")
