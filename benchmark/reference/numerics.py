"""How the plain reference rounds.

``Numerics("fp32")`` is the reference: every product in float32, with
TF32 off.  ``Numerics("fp8")`` is the control of the bfloat16 configuration:
the same code with both operands of every product (weights and
activations) rounded to float8 e4m3, per tensor scaled to its largest
magnitude, as an fp8 inference path would quantize them.  Elementwise work,
norms and the fixed filters stay float32 in both.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def exact_float32() -> None:
    """Products in true float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, back in float32."""
    amax = float(x.detach().abs().amax()) if x.numel() else 0.0
    if amax == 0.0:
        return x
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Numerics:
    MODES = ("fp32", "fp8")

    def __init__(self, mode: str = "fp32"):
        if mode not in self.MODES:
            raise ValueError(f"numerics must be one of {self.MODES}, got {mode!r}")
        self.mode = mode

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, as this precision holds it."""
        return round_fp8(x) if self.mode == "fp8" else x
