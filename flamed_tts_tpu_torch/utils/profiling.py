"""Profiling utilities: the JAX package's ``utils/profiling.py`` on PyTorch.

* ``trace(dir)``: a context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (``chrome://tracing`` or Perfetto) of the host's
  operators and, where a card is present, of the device's kernels into
  ``dir``; a no-op when ``dir`` is empty or None.
* ``StageTimer``: named host-clock spans with a per-name mean, for host-side
  breakdowns of the sampling path (``SAMPLE_TIMER`` / ``sample_span``).
* ``graph_ms`` / ``events_ms``: a call's time on the card, from a CUDA
  graph's replay (device time, no host launch cost) or from CUDA events
  around back-to-back calls (the host's launch cost included);
  ``nvidia_smi_line``: the card's name and power limit, to stand beside
  every time taken on it.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
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


def events_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` on the card: one warm call, then CUDA events
    around ``reps`` back-to-back calls; the host's launch cost is in it."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` with the host's launch cost taken out:
    ``reps`` calls captured in one CUDA graph, one replay timed with CUDA
    events (after a warm call on a side stream and a warm replay)."""
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


def nvidia_smi_line() -> str:
    """The first card's ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


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
