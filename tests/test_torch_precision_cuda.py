"""The ``"default"`` matmul precision on the card (``precision.py``): a
Linear, a k3 conv and a batched product, forward and backward, against the
same bfloat16-operand arithmetic forced onto the CPU.  Needs a card
(``cuda`` marker); imports nothing of JAX, so it runs where only the port
is installed:

    python -m pytest tests/test_torch_precision_cuda.py -q -m cuda
"""

import pytest
import torch

from flamed_tts_tpu_torch import precision

pytestmark = pytest.mark.cuda


def test_card_default_matches_the_cpu_arithmetic():
    """On the card at "default": a Linear, a k3 conv and a batched product,
    forward and backward, against the same bf16-operand arithmetic on the
    CPU (float32 master weights, as the trainer holds them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    lin, conv = precision.Linear(96, 80), precision.Conv1d(96, 40, 3, padding=1)
    x = torch.randn(3, 50, 96, generator=gen)
    a, b = torch.randn(2, 4, 50, 16, generator=gen), torch.randn(2, 4, 16, 50, generator=gen)

    def run(device):
        mods = [m.to(device) for m in (lin, conv)]
        ins = [t.to(device).requires_grad_() for t in (x, a, b)]
        outs = (mods[0](ins[0]), mods[1](ins[0].transpose(1, 2)), precision.matmul(ins[1], ins[2]))
        sum((o * o).sum() for o in outs).backward()
        grads = [t.grad for t in ins] + [p.grad for m in mods for p in m.parameters()]
        res = [t.detach().cpu() for t in (*outs, *grads)]
        for m in mods:
            m.zero_grad(set_to_none=True)
        return res

    with precision.matmul_precision("default"):
        card = run(dev)
        with precision.bf16_on_cpu():
            cpu = run(torch.device("cpu"))
    # The card and the CPU's emulation round the same operands in the same
    # places (precision.py runs one code on both), so they differ only in
    # the order of the float32 sums (~1e-7 relative) and where that order
    # flips the rounding of an incoming gradient element (one bf16 step,
    # 2^-8 of it, expected about once over these tensors): held to 5e-4
    # relative L2 and 1e-2 of each tensor's peak.  Results rounded to bf16
    # would be off by ~1.5e-3 relative L2 (a uniform error of half a bf16
    # step), and a wrong product by its whole scale.
    for i, (c, h) in enumerate(zip(card, cpu)):
        assert c.dtype == h.dtype == torch.float32 and c.shape == h.shape, i
        rel = float((c - h).norm() / h.norm())
        err = float((c - h).abs().max() / h.abs().max())
        assert rel < 5e-4 and err < 1e-2, (i, rel, err)
