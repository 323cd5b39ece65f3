"""Times the port's residual-unit kernel (K2) at every tile that fits, at the
codec's main-path shapes, beside the tile ``pick_tile`` chooses.

    python3 tools/torch_sweep_unit_tile.py [bf16|fp32]      (bf16 by default)

Needs one NVIDIA Hopper GPU and nvcc.  Device ms per launch come from a CUDA
graph replay of ``reps`` launches (no host launch cost); the result has the
same bits at every tile, so only the time differs.  Prints one line per
(T, C, d) with the ms at each tile, the fastest tile and the chosen one, and
last the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = {  # the encoder over a 3 s prompt, then the decoder over 512 frames (bf16) or 256 (fp32)
    "bf16": [(1200, 256), (12800, 256), (2560, 512), (6000, 128), (51200, 128), (24000, 64),
             (102400, 64), (48000, 32)],
    "fp32": [(1200, 256), (6400, 256), (1280, 512), (6000, 128), (25600, 128), (24000, 64),
             (51200, 64), (48000, 32)],
}


def graph_ms(fn, reps: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    from flamed_tts_tpu_torch import kernels
    from flamed_tts_tpu_torch.ops import resunit
    from flamed_tts_tpu_torch.ops.resunit import (SMEM_LIMIT, pick_tile, prepare_unit,
                                                  residual_unit_cuda, unit_smem_bytes)

    name = sys.argv[1] if len(sys.argv) > 1 else "bf16"
    if name not in SHAPES:
        print(__doc__, file=sys.stderr)
        return 2
    io = torch.bfloat16 if name == "bf16" else torch.float32
    itemsize = 2 if name == "bf16" else 4
    kernels.build(["residual_unit"])
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    def rand(*shape, scale=1.0, dtype=io):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev).to(dtype)

    for t, c in SHAPES[name]:
        s = 1.0 / np.sqrt(7 * c)
        p = {"act1": {"alpha": rand(c, scale=0.3, dtype=torch.float32), "beta": rand(c, scale=0.3, dtype=torch.float32)},
             "act2": {"alpha": rand(c, scale=0.3, dtype=torch.float32), "beta": rand(c, scale=0.3, dtype=torch.float32)},
             "conv1": {"w": rand(c, c, 7, scale=s), "b": rand(c, scale=0.1)},
             "conv2": {"w": rand(c, c, 1, scale=s), "b": rand(c, scale=0.1)}}
        w = prepare_unit(p)
        x = rand(1, t, c)
        reps = max(3, min(30, int(1e8 // (t * c * (1 + c // 64)))))
        for d in (1, 3, 9):
            times = {}
            for tile in range(4, 128, 16):
                if unit_smem_bytes(c, d, tile, itemsize) <= SMEM_LIMIT:
                    # the wrapper takes its tile from pick_tile alone: stand in for it
                    with mock.patch.object(resunit, "pick_tile", lambda *a: tile):
                        times[tile] = graph_ms(lambda: residual_unit_cuda(x, p, d, w), reps)
            best, chosen = min(times, key=times.get), pick_tile(t, c, d, itemsize)
            print(f"[sweep] {name} ({t}, {c}) d={d}: " + ", ".join(f"{k}: {v:.4f}" for k, v in times.items())
                  + f" ms; fastest tile {best} ({times[best]:.4f} ms), pick_tile {chosen} "
                  f"({times[chosen]:.4f} ms, {times[chosen] / times[best]:.2f}x)", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
