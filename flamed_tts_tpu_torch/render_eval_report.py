"""Render an ``eval_discrimination`` JSON report as markdown tables
(stage-1 and stage-2 margins, ``wer_synth``), so that a written report
cites only numbers its artifact holds.

    python -m flamed_tts_tpu_torch.render_eval_report report.json
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional, Sequence


def stage1_table(s: Dict) -> str:
    rows = [f"| {name} | {d['same_mean']:.4f} | {d['diff_mean']:.4f} | {d['margin']:+.4f} "
            f"| {d['rank_acc']:.3f} |"
            for name, d in s.items() if isinstance(d, dict) and "margin" in d]
    return ("| embedder | same-spk cos | diff-spk cos | margin | rank-acc |\n"
            "|---|---|---|---|---|\n" + "\n".join(rows))


def stage2_table(s: Dict) -> str:
    rows = []
    for key, label in (("asr_spk", "ASR speaker head (trained)"), ("melstats", "mel-stats"),
                       ("codec_timbre", "codec timbre (trained r5)")):
        d = s.get(key)
        if d:
            rows.append(f"| {label} | {d['mean_margin']:+.4f} | {d['frac_positive']:.3f} |")
    out = "| embedder | mean margin | frac positive |\n|---|---|---|\n" + "\n".join(rows)
    w = s.get("wer_synth")
    if w:
        out += (f"\n\nwer_synth (nfe {s.get('nfe', '?')}): mean **{w['mean']:.3f}**, "
                f"median {w['median']:.3f} (n={w['n']})")
    return out


def render(d: Dict) -> str:
    parts = []
    for sec in ("stage1", "stage1_heldout", "stage2", "stage2_heldout"):
        if sec in d and isinstance(d[sec], dict):
            table = stage1_table(d[sec]) if sec.startswith("stage1") else stage2_table(d[sec])
            parts.append(f"### {sec}\n\n{table}\n\n")
    return "".join(parts)


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0], encoding="utf-8") as f:
        sys.stdout.write(render(json.load(f)))


if __name__ == "__main__":
    main()
