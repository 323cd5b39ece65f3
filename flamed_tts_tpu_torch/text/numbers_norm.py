"""English number normalization without external dependencies.

Behaves as the inflect-based normalizer the checkpoints were trained
behind: commas stripped, currency
expanded, decimals spoken digit-wise after "point", ordinals spelled out,
years in (1000, 3000) spoken in two-digit groups.
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
    (10 ** 2, "hundred"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones == 0:
        return _TENS[tens]
    return f"{_TENS[tens]}-{_ONES[ones]}"


def number_to_words(n: int, andword: str = "and") -> str:
    """Spell an integer in English (inflect-compatible for our use)."""
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n < 20:
        return _ONES[n]
    if n < 100:
        return _two_digits(n)
    for scale_value, scale_name in _SCALES:
        if n >= scale_value:
            head = n // scale_value
            rest = n % scale_value
            head_words = number_to_words(head, andword)
            if rest == 0:
                return f"{head_words} {scale_name}"
            joiner = f" {andword} " if (andword and rest < 100) else " "
            return f"{head_words} {scale_name}{joiner}{number_to_words(rest, andword)}"
    return _ONES[n]  # unreachable


def number_to_ordinal_words(n: int) -> str:
    words = number_to_words(n, andword="")
    # Convert the last word to its ordinal form.
    parts = re.split(r"([ \-])", words)
    last = parts[-1]
    if last in _ORDINAL_IRREGULAR:
        parts[-1] = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        parts[-1] = last[:-1] + "ieth"
    else:
        parts[-1] = last + "th"
    return "".join(parts)


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars_match(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_decimal_match(m: re.Match) -> str:
    return m.group(1).replace(".", " point ")


def _expand_number_match(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100, andword="")
        if num % 100 == 0:
            return number_to_words(num // 100, andword="") + " hundred"
        # Year-style: two two-digit groups ("nineteen eighty-four").
        high, low = divmod(num, 100)
        low_words = "oh " + _ONES[low] if 0 < low < 10 else _two_digits(low)
        return f"{number_to_words(high, andword='')} {low_words}"
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, lambda m: m.group(1).replace(",", ""), text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars_match, text)
    text = re.sub(_decimal_number_re, _expand_decimal_match, text)
    text = re.sub(_ordinal_re, lambda m: number_to_ordinal_words(int(m.group(1))), text)
    text = re.sub(_number_re, _expand_number_match, text)
    return text
