"""The serving benchmark of this checkout against another one's, in turns on
one card.

    python -m flamed_tts_tpu_torch.bench_ab --other DIR

DIR is another checkout of the repository (for example the parent commit
unpacked with ``git archive``).  Each of ``ROUNDS`` rounds runs ``python -m
flamed_tts_tpu_torch.bench`` in the other checkout and in this one, in the
order other, this, this, other (the next round starts where the last
ended), each in its own process; then, once each side, one warm bench call
profiled by ``torch.profiler`` (device kernels and copies, device-busy ms,
ms in GEMM kernels off the tensor cores, the prior's and the prob's parameter bytes) and
``python -m flamed_tts_tpu_torch.bench_components --which mfu`` (its
stages' device ms, the compute floor).  Prints one JSON object as the last
line of its output.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

from flamed_tts_tpu_torch.utils.profiling import nvidia_smi_line

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 3

# one warm bench call profiled, in the checkout it runs in (the bench's
# build / make_run / warm are the same functions in both checkouts)
PROFILE = r"""
import json, re, time, torch
from flamed_tts_tpu_torch import bench
from flamed_tts_tpu_torch.config import load_default_config
model, codec = bench.build(load_default_config(), "bf16", torch.device("cuda"))
run = bench.make_run(model, codec, bench.prompt_wav())
bench.warm(run)
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(1)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
events = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
core = re.compile(r"ffma|simt|sgemm|f32f32_f32f32", re.IGNORECASE)
params = [p for m in (model.prior, model.prob) for p in m.parameters()]
print(json.dumps({"device_kernels": sum(e.count for e in events), "wall_ms": wall,
                  "busy_ms": sum(e.self_device_time_total for e in events) / 1e3,
                  "cuda_core_gemm_ms": sum(e.self_device_time_total for e in events
                                           if core.search(e.key)) / 1e3,
                  "param_bytes": sum(p.numel() * p.element_size() for p in params)}))
"""


def _last_json(root: str, argv: List[str]) -> Dict:
    """Run ``python argv`` in ``root`` (whose package ``-m`` and ``-c``
    import first: the working directory leads ``sys.path``) and read its
    last stdout line."""
    res = subprocess.run([sys.executable, *argv], cwd=root, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"{argv} in {root} exited {res.returncode}: {res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _components(root: str) -> Dict:
    rep = _last_json(root, ["-m", "flamed_tts_tpu_torch.bench_components", "--which", "mfu"])
    return {"rows_ms": {r["name"]: r["ms"] for r in rep["rows"]},
            "rtf_compute_floor": rep["total"]["rtf_compute_floor"],
            "compute_ms": rep["total"]["compute_ms"], "mfu_whole_call": rep["total"]["mfu_whole_call"]}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.bench_ab",
                                     description="This checkout's bench against another's, in turns.")
    parser.add_argument("--other", required=True, help="Another checkout of the repository.")
    args = parser.parse_args(argv)
    sides = {"other": os.path.abspath(args.other), "this": HERE}
    rtf: Dict[str, List[float]] = {"other": [], "this": []}
    order = []
    for r in range(ROUNDS):
        for side in (("other", "this") if r % 2 == 0 else ("this", "other")):
            rtf[side].append(_last_json(sides[side], ["-m", "flamed_tts_tpu_torch.bench"])["value"])
            order.append(side)
            print(f"[bench_ab] {side}: RTF {rtf[side][-1]}", file=sys.stderr, flush=True)
    report = {"card": nvidia_smi_line(), "order": order, "rtf": rtf,
              "profile": {s: _last_json(root, ["-c", PROFILE]) for s, root in sides.items()},
              "components": {s: _components(root) for s, root in sides.items()}}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
