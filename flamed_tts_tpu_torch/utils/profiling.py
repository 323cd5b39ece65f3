"""Profiling utilities: the JAX package's ``utils/profiling.py`` on PyTorch.

* ``trace(dir)``: a context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (``chrome://tracing`` or Perfetto) of the host's
  operators and, where a card is present, of the device's kernels into
  ``dir``; a no-op when ``dir`` is empty or None.
* ``StageTimer``: named host-clock spans with a per-name mean, for host-side
  breakdowns of the sampling path (``SAMPLE_TIMER`` / ``sample_span``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block when a directory is given, written to
    ``log_dir/trace.json``; no-op otherwise.  CUDA activity is recorded
    where a card is present."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# Opt-in host-span profiling of the sampling path: a profiling tool
# (profile_sample.py) installs a StageTimer here; while it is None the spans
# below are nullcontexts and serving does not change.
SAMPLE_TIMER: Optional["StageTimer"] = None


def sample_span(name: str):
    t = SAMPLE_TIMER
    return t.span(name) if t is not None else contextlib.nullcontext()


class StageTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        """Mean seconds per span name, rounded to 0.1 ms."""
        return {
            name: round(self.totals[name] / max(self.counts[name], 1), 4)
            for name in self.totals
        }

    def report(self) -> str:
        return " | ".join(
            f"{k}: {v * 1000:.1f}ms" for k, v in sorted(self.summary().items())
        )
