"""Dropout whose masks come from an explicit ``torch.Generator``.

``nn.Dropout`` draws from the global generator; a training step here draws
its flow-matching times and noises from one generator on its own device,
and the dropout masks come from the same one, so a run is reproducible
from its seed.  As in flax, a kept element is scaled by 1 / (1 - p); in
eval mode, or at p = 0, the input passes through with no op at all.

``BatchRows`` is how a data-parallel rank keeps the draws of one process
on the whole batch: a draw over the batch is made at the whole batch's
shape from the same generator (every rank holds the same one) and this
rank's rows are sliced out, so N ranks draw exactly what one process
draws; the loss denominators are summed over the data group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
from torch import Tensor, nn


@dataclass(frozen=True)
class BatchRows:
    """Rows [lo, hi) of a batch of ``total`` rows, held by this rank;
    ``group_sum`` sums a tensor over the ranks that split the batch (the
    data group), None for one process."""
    lo: int
    hi: int
    total: int
    group_sum: Optional[Callable[[Tensor], Tensor]] = None

    def draw(self, fn: Callable, shape: Sequence[int], generator: Optional[torch.Generator],
             device) -> Tensor:
        """``fn`` (torch.rand or torch.randn) at the whole batch's shape,
        this rank's rows of it."""
        full = fn((self.total, *shape[1:]), generator=generator, device=device)
        return full[self.lo:self.hi]

    def sum(self, t: Tensor) -> Tensor:
        return t if self.group_sum is None else self.group_sum(t)


def draw(fn: Callable, shape: Sequence[int], generator: Optional[torch.Generator], device,
         rows: Optional[BatchRows] = None) -> Tensor:
    """A draw over a batch: ``fn(shape)``, or with ``rows`` this rank's
    rows of the whole batch's draw."""
    if rows is None:
        return fn(tuple(shape), generator=generator, device=device)
    return rows.draw(fn, shape, generator, device)


def denominator(count: Tensor, rows: Optional[BatchRows] = None) -> Tensor:
    """A loss mean's denominator: the count (of valid positions), summed
    over the data group where the batch is split, at least 1."""
    return torch.clamp(count if rows is None else rows.sum(count), min=1.0)


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None
        self.rows: Optional[BatchRows] = None  # where x is this rank's rows of a batch

    def forward(self, x: Tensor) -> Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = draw(torch.rand, x.shape, self.generator, x.device, self.rows) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every ``Dropout`` under ``module`` draws its masks from ``generator``
    (None: the global generator)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_dropout_rows(module: nn.Module, rows: Optional[BatchRows]) -> None:
    """Every ``Dropout`` under ``module`` draws its masks over the whole
    batch and keeps ``rows`` of them (None: the masks of its input alone)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.rows = rows
