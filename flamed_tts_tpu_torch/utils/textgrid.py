"""Minimal Praat TextGrid parser: the IntervalTier items of standard
(long-form) TextGrid files, empty intervals kept, which is what reading an
MFA alignment's "phones" tier needs.  A copy of the JAX package's
``flamed_tts_tpu/utils/textgrid.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List


@dataclass
class Interval:
    start_time: float
    end_time: float
    text: str


_ITEM_RE = re.compile(r"item\s*\[\s*(\d+)\s*\]\s*:")
_KV_RE = re.compile(r"^\s*(\w+)\s*=\s*(.*)$")


def _unquote(value: str) -> str:
    value = value.strip()
    if value.startswith('"') and value.endswith('"'):
        return value[1:-1]
    return value


def read_textgrid(path: str) -> Dict[str, List[Interval]]:
    """Returns {tier_name: [Interval, ...]} with empty intervals kept."""
    with open(path, encoding="utf-8") as fin:
        lines = fin.readlines()

    tiers: Dict[str, List[Interval]] = {}
    current_name = None
    current: List[Interval] = []
    pending: Dict[str, str] = {}
    in_interval = False

    for raw in lines:
        line = raw.strip()
        if line.startswith("name"):
            match = _KV_RE.match(line)
            if match:
                if current_name is not None:
                    tiers[current_name] = current
                current_name = _unquote(match.group(2))
                current = []
            continue
        if re.match(r"intervals\s*\[", line):
            if pending.get("xmin") is not None and "text" in pending:
                current.append(
                    Interval(
                        float(pending["xmin"]),
                        float(pending["xmax"]),
                        _unquote(pending["text"]),
                    )
                )
            pending = {}
            in_interval = True
            continue
        if in_interval:
            match = _KV_RE.match(line)
            if match:
                pending[match.group(1)] = match.group(2)

    if in_interval and pending.get("xmin") is not None and "text" in pending:
        current.append(
            Interval(
                float(pending["xmin"]),
                float(pending["xmax"]),
                _unquote(pending["text"]),
            )
        )
    if current_name is not None:
        tiers[current_name] = current
    return tiers


def get_tier(path: str, tier_name: str = "phones") -> List[Interval]:
    tiers = read_textgrid(path)
    if tier_name not in tiers:
        raise KeyError(f"Tier '{tier_name}' not found in {path} (has {list(tiers)})")
    return tiers[tier_name]


def write_textgrid(path: str, intervals, tier_name: str = "phones") -> None:
    """Write a long-form TextGrid with one IntervalTier of ``intervals``
    ((start_s, end_s, text), contiguous from 0)."""
    xmax = intervals[-1][1]
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
             f"xmax = {xmax:.6f}", "tiers? <exists>", "size = 1", "item []:", "    item [1]:",
             '        class = "IntervalTier"', f'        name = "{tier_name}"', "        xmin = 0",
             f"        xmax = {xmax:.6f}", f"        intervals: size = {len(intervals)}"]
    for i, (a, b, text) in enumerate(intervals, 1):
        lines += [f"        intervals [{i}]:", f"            xmin = {a:.6f}",
                  f"            xmax = {b:.6f}", f'            text = "{text}"']
    with open(path, "w", encoding="utf-8") as fout:
        fout.write("\n".join(lines) + "\n")
