"""Dropout whose masks come from an explicit ``torch.Generator``.

``nn.Dropout`` draws from the global generator; a training step here draws
its flow-matching times and noises from one generator on its own device,
and the dropout masks come from the same one, so a run is reproducible
from its seed.  As in flax, a kept element is scaled by 1 / (1 - p); in
eval mode, or at p = 0, the input passes through with no op at all.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor, nn


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: Tensor) -> Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every ``Dropout`` under ``module`` draws its masks from ``generator``
    (None: the global generator)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
