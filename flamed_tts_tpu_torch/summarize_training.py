"""Summarize a training run's metrics.jsonl into a markdown table.

    python -m flamed_tts_tpu_torch.summarize_training exp_dir [--every N]

Prints a loss-curve excerpt (every Nth logged step plus the last),
steps/s statistics without the windows that straddle a stall, the
time to the first step where the run logged it, and the validation losses:
the text of the repository's ``tools/summarize_training.py``, from the
``metrics.jsonl`` that ``python -m flamed_tts_tpu_torch.train`` writes.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def load_rows(path: str):
    rows = []
    with open(path, encoding="utf-8") as fin:
        for line in fin:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.summarize_training")
    ap.add_argument("exp_dir")
    ap.add_argument("--every", type=int, default=4,
                    help="print every Nth logged row (default 4)")
    args = ap.parse_args(argv)

    rows = load_rows(f"{args.exp_dir}/metrics.jsonl")
    train = [r for r in rows if "total_loss" in r]
    val = [r for r in rows if "total_loss_val" in r]
    first = next((r["first_step_s"] for r in rows if "first_step_s" in r), None)

    if not train:
        print("no training rows", file=sys.stderr)
        return 1

    if first is not None:
        print(f"time-to-first-step (trace+compile+step1): {first:.0f} s\n")

    keys = ["total_loss", "dur_loss", "sil_loss", "prior_loss", "fm_loss",
            "anchor_loss", "grad_norm"]
    print("| step | " + " | ".join(k.replace("_loss", "") for k in keys) + " | steps/s |")
    print("|" + "---|" * (len(keys) + 2))
    picked = train[:: args.every]
    if train[-1] is not picked[-1]:
        picked.append(train[-1])
    for r in picked:
        cells = [f"{r.get(k, float('nan')):.3f}" for k in keys]
        sps = r.get("steps_per_sec")
        cells.append(f"{sps:.2f}" if sps is not None else "-")
        print(f"| {r['step']} | " + " | ".join(cells) + " |")

    # steady-state steps/s: a window 5x slower than the median straddles a
    # stall, not a step rate
    sps = sorted(r["steps_per_sec"] for r in train if r.get("steps_per_sec"))
    if sps:
        med = sps[len(sps) // 2]
        steady = [s for s in sps if s > med / 5]
        print(f"\nsteps/s: median {med:.2f}, steady-state mean "
              f"{sum(steady) / len(steady):.2f} over {len(steady)} windows")
    if val:
        print("val loss: " + ", ".join(
            f"step {r['step']}: {r['total_loss_val']:.3f}" for r in val))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
