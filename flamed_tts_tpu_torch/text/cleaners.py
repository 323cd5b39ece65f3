"""Text cleaners.

``english_cleaners`` = ascii-fold -> lowercase -> number expansion ->
abbreviation expansion -> whitespace collapse.  We replace the unidecode
dependency with a NFKD-based ASCII fold plus a small table of common
typographic characters, which is equivalent for English text.
"""

from __future__ import annotations

import re
import unicodedata

from flamed_tts_tpu_torch.text.numbers_norm import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_TYPOGRAPHIC = {
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"',
    "–": "-", "—": "-", "―": "-", "−": "-",
    "…": "...",
    " ": " ",
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE",
    "ß": "ss", "ø": "o", "Ø": "O",
    "ð": "d", "Ð": "D", "þ": "th", "Þ": "Th",
}

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), expansion)
    for abbr, expansion in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"),
        ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
        ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
        ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
        ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def convert_to_ascii(text: str) -> str:
    for src, dst in _TYPOGRAPHIC.items():
        text = text.replace(src, dst)
    decomposed = unicodedata.normalize("NFKD", text)
    return decomposed.encode("ascii", "ignore").decode("ascii")


def lowercase(text: str) -> str:
    return text.lower()


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def expand_abbreviations(text: str) -> str:
    for regex, expansion in _ABBREVIATIONS:
        text = re.sub(regex, expansion, text)
    return text


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text
