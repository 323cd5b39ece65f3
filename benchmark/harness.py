"""What the drivers, the metric readers and the entry point share: the run's
context, the host spans the harness installs in the program, and the
comparison helpers that decide ``correct``."""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "flamed_tts_tpu")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


class Spans:
    """Named host-clock spans: totals and counts.  The program calls
    ``span(name)`` at its own boundaries once this is installed as its
    sample timer; while ``annotate`` is set each span is also a profiler
    annotation, so a device trace can say what the host was doing."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        rf = torch.profiler.record_function(name) if self.annotate else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def snapshot(self) -> Dict[str, tuple]:
        return {k: (self.totals[k], self.counts[k]) for k in list(self.totals)}


@dataclass
class Ctx:
    """One run of one cell."""
    root: str
    cfg: Dict
    mix: Dict
    seed: int
    device: torch.device
    seconds: float
    spans: Spans = field(default_factory=Spans)


@dataclass
class Window:
    """What a metric reader reads: the window's records and spans, the
    program's counters before and after, the traced slice, and the run's
    set-up seconds."""
    records: List[Dict]
    seconds: float
    spans: Dict[str, tuple]
    counters: Dict[str, float]
    peak_flop_per_s: float
    trace: Optional[object] = None
    setup_s: Optional[float] = None


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


class PooledGap:
    """The relative L2 gap of many outputs pooled, sqrt(sum ||got - want||^2
    / sum ||want||^2) in float64, and the widest single gap beside it."""

    def __init__(self) -> None:
        self.diff = self.norm = self.widest = 0.0

    def add(self, got, want) -> None:
        got = (got if torch.is_tensor(got) else torch.as_tensor(np.asarray(got))).double().cpu()
        want = (want if torch.is_tensor(want) else torch.as_tensor(np.asarray(want))).double().cpu()
        if got.shape != want.shape:
            raise ValueError(f"shapes {tuple(got.shape)} and {tuple(want.shape)} differ")
        d, n = float((got - want).norm()), float(want.norm())
        self.diff, self.norm = self.diff + d * d, self.norm + n * n
        self.widest = max(self.widest, d / max(n, 1e-30))

    @property
    def value(self) -> float:
        return (self.diff / self.norm) ** 0.5 if self.norm else 0.0


def sample(n: int, k: int, seed: int, must: int) -> List[int]:
    """``k`` of ``n`` indices drawn from the seed, ``must`` among them."""
    r = np.random.default_rng(np.random.SeedSequence([abs(int(seed)), 7]))
    rest = [i for i in r.permutation(n).tolist() if i != must]
    return sorted([must] + rest[:max(k - 1, 0)])
