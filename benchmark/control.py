"""The controls of ``correct``: a run of a cell with the program's output
replaced by what the nearest lower precision gives, which the check must
refuse.

    python3 -m benchmark.control --workload <name> --seconds <s> --seeds <n> <n> <n>

* the Flamed-TTS cells (bfloat16): the plain reference computed with
  float8 (e4m3) operands in every product, weights and activations, in the
  program's place (``ControlServe``): the same requests, its own speculative
  buckets, the same noise;
* ``facodec_roundtrip`` (float32 with cuDNN's TF32): the program's own
  bfloat16 path (``FaCodec.cast_inference_params``).

Prints, for each seed, each number compared beside its limit and whether
the run came out correct.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import torch

from benchmark import generator, run
from benchmark.drivers.serve import Serve
from benchmark.harness import Ctx
from benchmark.reference.frontend import read_words, text_to_ids
from benchmark.reference.numerics import Numerics
from benchmark.reference.serving import FrameBudget


class ControlServe(Serve):
    """``Serve`` with the fp8 reference in the program's place."""

    def __init__(self, ctx: Ctx):
        super().__init__(ctx)
        self.budget = FrameBudget(ctx.cfg["buckets"]["frame"])

    def setup(self) -> None:
        ctx = self.ctx
        self.words = read_words()
        self.control = self.reference(Numerics("fp8"))
        pool = int(ctx.seconds * self.mix["max_calls_per_second"]) + int(self.mix["trace_calls"])
        if self.batch == 1:
            self.requests = generator.utterances(self.mix, ctx.seed, pool)
        else:
            self.voices = generator.speakers(self.mix, ctx.seed)
            self.requests = self._batches(generator.utterances(self.mix, ctx.seed, pool * self.batch), 0)
        self.next = 0

    def serve(self, req: Dict, phase: str) -> Dict:
        t0 = time.perf_counter()
        with torch.no_grad():
            got = self._reference_call(self.control, {"req": req}, self.budget)
        tgt, f = got["tgt_len"], got["frame_bucket"]
        rows = [req] if self.batch == 1 else req["rows"]
        rec = {"phase": phase, "req": req, "latency_s": time.perf_counter() - t0,
               "audio_s": sum(tgt) * 200 / 16000, "tgt_len": tgt, "frame_bucket": f,
               "n_ids": [len(text_to_ids(u["text"], self.words)) for u in rows], "dispatches": 1,
               "true_frames": sum(tgt), "bucket_frames": f * len(tgt), "index": len(self.calls),
               "latents": torch.stack(got["latents"]), "wavs": [w.cpu().numpy() for w in got["wavs"]],
               "timbres": got["timbres"],
               "flops": 0, "launches": []}
        self.calls.append(rec)
        return rec

    def keep(self, window: List[Dict], sample_seed: int) -> None:
        """The control's timbres came with its calls."""

    def counters(self) -> Dict[str, float]:
        return {}

    def free(self) -> None:
        self.control = None


def overrides(workload: str) -> Dict:
    """What turns a run of ``workload`` into its control's."""
    if workload == "facodec_roundtrip":
        return {"config": {"precision": {"codec": "bfloat16", "cudnn_tf32": True, "matmul_tf32": False,
                                         "arithmetic": "bf16"}}}
    return {"driver": ControlServe}


def merge(a: Dict, b: Dict) -> Dict:
    """``a`` with ``b``'s configuration and mix keys laid over it."""
    out = dict(a)
    for key in ("config", "mix"):
        if key in a or key in b:
            out[key] = {**a.get(key, {}), **b.get(key, {})}
    if "driver" in b:
        out["driver"] = b["driver"]
    return out


def control_runs(workload: str, seeds: List[int], seconds: float, device=None,
                 extra: Dict = None) -> List[Dict]:
    """The control's result object for each seed."""
    out = []
    for seed in seeds:
        ov = merge(extra or {}, overrides(workload))
        res = run.run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", "0"], device=device, overrides=ov)
        out.append({"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
                    "compared": res["compared"]})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description="the controls of correct, per seed")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("[control] runs on a CUDA card", file=sys.stderr)
        sys.exit(3)
    for res in control_runs(args.workload, args.seeds, args.seconds):
        print(json.dumps(res))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
