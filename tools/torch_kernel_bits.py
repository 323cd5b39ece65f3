"""Dumps the outputs of the port's CUDA kernels on fixed inputs, and compares
two dumps bit for bit: the check that a change to the kernels' scheduling
(which thread computes what, and in which order) left the fp32
arithmetic alone.

    python3 tools/torch_kernel_bits.py dump <repository root> <out.pt>
    python3 tools/torch_kernel_bits.py compare <a.pt> <b.pt>

``dump`` imports ``flamed_tts_tpu_torch`` from the given root (a checkout of
another commit, for example, unpacked with ``git archive``), builds its
kernels and runs K1 in fp32 and bf16 and K2 and K3 in fp32 on inputs from a
fixed seed.  Needs one NVIDIA Hopper GPU and nvcc.  ``compare`` prints one
line per output and exits non-zero if any differs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def dump(root: str, out: str) -> int:
    sys.path.insert(0, root)
    from flamed_tts_tpu_torch.ops.resunit import residual_stack_cuda, residual_unit_cuda
    from flamed_tts_tpu_torch.ops.snake import snake_filtered_cuda

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    res = {}
    # lengths of one row, a few rows (every index clipped), one pass of the
    # snakes clipped at both ends, and many passes
    for c, t in [(32, 1000), (64, 77), (128, 517), (512, 300), (96, 5), (32, 1), (64, 3), (32, 40),
                 (64, 700), (128, 1)]:
        s = 1.0 / np.sqrt(7 * c)
        units = [{"act1": {"alpha": rand(c, scale=0.3), "beta": rand(c, scale=0.3)},
                  "act2": {"alpha": rand(c, scale=0.3), "beta": rand(c, scale=0.3)},
                  "conv1": {"w": rand(c, c, 7, scale=s), "b": rand(c, scale=0.1)},
                  "conv2": {"w": rand(c, c, 1, scale=s), "b": rand(c, scale=0.1)}} for _ in range(3)]
        x = rand(2, t, c)
        alpha, beta = units[0]["act1"]["alpha"], units[0]["act1"]["beta"]
        res[f"snake_filtered fp32 (T, C)=({t}, {c})"] = snake_filtered_cuda(x, alpha, beta).cpu()
        res[f"snake_filtered bf16 (T, C)=({t}, {c})"] = snake_filtered_cuda(x.bfloat16(), alpha, beta).float().cpu()
        for d in (1, 9):
            res[f"residual_unit fp32 (T, C)=({t}, {c}) d={d}"] = residual_unit_cuda(x, units[0], d).cpu()
        if c <= 64:
            res[f"residual_stack fp32 (T, C)=({t}, {c})"] = residual_stack_cuda(x, units).cpu()
    torch.save(res, out)
    return 0


def compare(a_path: str, b_path: str) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    differ = 0
    for key in a:
        same = torch.equal(a[key], b[key])
        differ += not same
        print(key, "equal" if same else f"DIFFERS, max abs {float((a[key] - b[key]).abs().max()):.3e}")
    return 1 if differ or set(a) != set(b) else 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "dump":
        sys.exit(dump(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    sys.exit(__doc__)
