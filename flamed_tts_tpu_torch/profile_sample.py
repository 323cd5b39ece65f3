"""Host-span breakdown of the port's ``Flamed.sample`` (the pinned bench call).

    python -m flamed_tts_tpu_torch.profile_sample [--device cuda|cpu]

Installs a ``StageTimer`` in the sampling path
(``utils/profiling.SAMPLE_TIMER``), runs ``bench.py``'s call warm, and
prints one JSON line with, per steady-state call,

  frontend        text -> phoneme ids (host)
  prompt_prep     the prompt wav padded to the codec's grid (host)
  input_place     uploads of phonemes and lengths (and prompt codes, timbres)
  prompt_place    the int16 prompt upload
  fused_dispatch  the host's time to enqueue the whole fused call (prompt
                  analysis, both Euler loops, the decoder)
  fused_get       the one host read, which waits for the device
  residual_ms     the wall minus all of the above (host glue)

and, in ``spans_ms`` beside them, the device time of each stage of the call
(``device.<stage>``, ``device_gap.graph_launch``: ``runtime/sampler.py``),
under the keys of the repository's ``tools/profile_sample.py``: wall_ms,
audio_s, rtf, spans_ms, residual_ms, all_walls_ms.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from flamed_tts_tpu_torch import bench
from flamed_tts_tpu_torch.config import load_default_config
from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.utils import profiling


def profile(run: Callable[[int], Dict]) -> Dict:
    """Mean spans and wall of the bench's five timed calls (seeds 1-5), after
    the bench's warm-up under a timer of its own: whether marks are on is
    part of a captured graph's signature, so the warm-up captures what the
    timed calls replay."""
    profiling.SAMPLE_TIMER = profiling.StageTimer()
    walls, secs = [], []
    try:
        bench.warm(run)
        timer = profiling.SAMPLE_TIMER = profiling.StageTimer()
        for seed in bench.TIMED_SEEDS:
            t0 = time.perf_counter()
            out = run(seed)
            walls.append(time.perf_counter() - t0)
            secs.append(len(out["wav"]) / 16000.0)
    finally:
        profiling.SAMPLE_TIMER = None
    spans = timer.summary()  # mean seconds a span or device stage
    host = sum(v for k, v in spans.items() if not k.startswith("device"))
    wall = float(np.mean(walls))
    return {
        "wall_ms": round(wall * 1e3, 2),
        "audio_s": round(float(np.mean(secs)), 2),
        "rtf": round(wall / float(np.mean(secs)), 5),
        "spans_ms": {k: round(v * 1e3, 2) for k, v in sorted(spans.items())},
        "residual_ms": round((wall - host) * 1e3, 2),
        "all_walls_ms": [round(w * 1e3, 1) for w in walls],
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.profile_sample",
                                     description="Host spans of one warm Flamed.sample (port).")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.device == "cuda":
        bench.probe_gpu()
    model, codec = bench.build(load_default_config(), "bf16", resolve_device(args.device))
    result = profile(bench.make_run(model, codec, bench.prompt_wav()))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
