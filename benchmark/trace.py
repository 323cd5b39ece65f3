"""A bounded slice of calls under ``torch.profiler``, reduced in memory to
what the per-layer metrics and the breakdown read: every device operation
(kernels, copies, sets) with its start and end, and the host's spans and
calls, so that an idle stretch of the device can be named by what the host
was doing then.  Nothing is written to disk."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Set, Tuple

import torch

NAME_CHARS = 96  # a kernel's name, cut for the breakdown
CALL = "benchmark.call"


@dataclass
class Slice:
    device: List[Tuple[str, int, int]]  # (name, start ns, end ns)
    host: List[Tuple[str, int, int]]
    start: int
    end: int

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        spans = sorted((max(s, self.start), min(e, self.end)) for _, s, e in self.device
                       if e > self.start and s < self.end)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, needle: str) -> Tuple[float, int]:
        """Device seconds and launches of the operations whose name holds
        ``needle``."""
        hits = [(e - s) for n, s, e in self.device if needle in n]
        return sum(hits) * 1e-9, len(hits)

    def top_ops(self, k: int = 10) -> List[list]:
        total: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            total[n[:NAME_CHARS]] += (e - s) * 1e-9
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle device time summed by what the host was in at the middle of
        each gap: the innermost host span or call then, else 'host'."""
        edges = [self.start]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.end)
        total: Dict[str, float] = defaultdict(float)
        host = sorted(self.host, key=lambda h: h[1])
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid, label = (a + b) // 2, "host"
            for name, s, e in host:
                if s > mid:
                    break
                if e >= mid and name != CALL:
                    label = name  # the latest-starting host event around the middle
            total[label[:NAME_CHARS]] += (b - a) * 1e-9
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def _events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every event profiled."""
    kin = getattr(prof.profiler, "kineto_results", None)
    if kin is not None:
        return [(e.name(), e.device_type() != torch.autograd.DeviceType.CPU, e.start_ns(), e.end_ns())
                for e in kin.events()]
    return [(e.name, e.device_type != torch.autograd.DeviceType.CPU, int(e.time_range.start * 1000),
             int(e.time_range.end * 1000)) for e in prof.events()]


def profile(calls: Callable[[Callable], None], annotations: Set[str]) -> Slice:
    """Profile ``calls(mark)``, which wraps each call in ``mark()``.
    ``annotations``: the host spans' names; the profiler mirrors each as a
    device-side range, which is no operation and is left out."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        calls(lambda: torch.profiler.record_function(CALL))
        torch.cuda.synchronize()
    device, host, marks = [], [], []
    skip = set(annotations) | {CALL}
    for name, on_device, s, e in _events(prof):
        if on_device:
            if name not in skip:
                device.append((name, s, e))
        elif name == CALL:
            marks.append((s, e))
        else:
            host.append((name, s, e))
    if not marks:
        raise RuntimeError("the profiled slice recorded no call")
    return Slice(device, host, min(s for s, _ in marks), max(e for _, e in marks))
