"""Profiling utilities: the JAX package's ``utils/profiling.py`` on PyTorch.

* ``trace(dir)``: a context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (``chrome://tracing`` or Perfetto) of the host's
  operators and, where a card is present, of the device's kernels into
  ``dir``; a no-op when ``dir`` is empty or None.
* ``StageTimer``: named host-clock spans with a per-name mean, for host-side
  breakdowns of the sampling path (``SAMPLE_TIMER`` / ``sample_span``).
* ``mark`` / ``Marks``: device time per stage of a call, from timing events
  the stages record on the device (below).
* ``graph_ms`` / ``events_ms``: a call's time on the card, from a CUDA
  graph's replay (device time, no host launch cost) or from CUDA events
  around back-to-back calls (the host's launch cost included);
  ``nvidia_smi_line``: the card's name and power limit, to stand beside
  every time taken on it.

The timer interface.  ``SAMPLE_TIMER`` is None (the default: serving does
not change) or an object with ``span(name)``, a context manager the program
enters at its host boundaries, and two dicts that default to 0, ``totals``
(name -> seconds) and ``counts`` (name -> occurrences).  ``StageTimer`` is
one; a benchmark may install its own.  Device readings are added to the
same two dicts: ``totals[name] += seconds`` and ``counts[name] += 1``.

Device stage marks.  A stage calls ``mark(name)`` where it starts, and the
last stage of a piece of work calls ``mark(END)``.  While a timer is
installed and a collector (``Marks``) is open (``collect``), each mark
records a timing event on the current CUDA stream (an event-record node of
the graph when the stream is being captured) or, for work on the CPU, whose
operators run synchronously, a ``time.perf_counter()`` stamp; otherwise it
does nothing.  After the call's host read ``read_marks`` turns consecutive
marks into seconds: the time from a mark to the next is its stage's, under
``device.<name>`` (``device_gap.<name>`` for a mark made with ``gap=True``,
a stretch in which the device waits), and from an ``END`` mark to the next
is nobody's.  In work launched eagerly a stage so runs from its first to
its last work on the device, the host's launch waits included.
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


# Opt-in profiling of the sampling path: a profiling tool (profile_sample.py)
# or a benchmark installs a timer here (the module docstring's interface);
# while it is None the spans below are nullcontexts, no mark records
# anything and serving does not change.
SAMPLE_TIMER: Optional["StageTimer"] = None
END = "end"


def sample_span(name: str):
    t = SAMPLE_TIMER
    return t.span(name) if t is not None else contextlib.nullcontext()


class Marks:
    """One call's device stage marks in order, for ``timer``: CUDA events on
    a CUDA ``device``, host-clock stamps on the CPU."""

    def __init__(self, device, timer) -> None:
        self.cuda = torch.device(device).type == "cuda"
        self.timer = timer
        self.stamps: list = []  # (name, gap, event or perf_counter seconds)

    def add(self, name: str, gap: bool = False) -> None:
        if self.cuda:
            stamp = torch.cuda.Event(enable_timing=True, external=True)
            stamp.record()
        else:
            stamp = time.perf_counter()
        self.stamps.append((name, gap, stamp))

    def read(self) -> None:
        """The stages' seconds into the timer, once the device has reached
        the last mark; the marks are dropped."""
        for (name, gap, a), (_, _, b) in zip(self.stamps, self.stamps[1:]):
            if name != END:
                key = ("device_gap." if gap else "device.") + name
                self.timer.totals[key] += a.elapsed_time(b) / 1e3 if self.cuda else b - a
                self.timer.counts[key] += 1
        self.stamps.clear()


_OPEN: Optional[Marks] = None  # the collector ``mark`` records into


def marking() -> bool:
    """Whether marks are on: work captured now holds their event nodes."""
    return SAMPLE_TIMER is not None


def call_marks(device) -> Optional[Marks]:
    """A collector for one call on ``device``; None while no timer is installed."""
    t = SAMPLE_TIMER
    return None if t is None else Marks(device, t)


@contextlib.contextmanager
def collect(marks: Optional[Marks]) -> Iterator[None]:
    """``marks`` is the open collector over the block (None: none is)."""
    global _OPEN
    outer, _OPEN = _OPEN, marks
    try:
        yield
    finally:
        _OPEN = outer


def mark(name: str, gap: bool = False) -> None:
    """The stage ``name`` starts here (module docstring)."""
    m = _OPEN
    if m is not None and SAMPLE_TIMER is not None:
        m.add(name, gap)


def extend_marks(marks: Optional[Marks]) -> None:
    """Append ``marks`` (a captured graph's, recorded again by its replay)
    to the open collector."""
    if marks is not None and _OPEN is not None:
        _OPEN.stamps.extend(marks.stamps)


def read_marks(marks: Optional[Marks]) -> None:
    if marks is not None:
        marks.read()


class StageTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """A host-clock span; while a profiler records, also an annotation
        on its timeline."""
        rf = (torch.profiler.record_function(name) if torch.autograd._profiler_enabled()
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
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
