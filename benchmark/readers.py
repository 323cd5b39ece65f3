"""The per-layer readings that more than one metric takes, each for its own
cells: ``benchmark/metrics/<metric>.py`` names one of these as its ``read``.
A reading that finds nothing to read is None, and the metric is left out."""

from __future__ import annotations

import sys

from benchmark import costs


def real_time_factor(w):
    """Window seconds over the seconds of audio the window's calls completed:
    every call counted, none dropped."""
    audio = sum(r.get("audio_s", 0.0) for r in w.records)
    return w.seconds / audio if audio > 0 else None


def pad_pct(w):
    """1 - true frames / bucket frames summed over the window's calls (frames
    of the frame bucket for synthesis, samples of the seconds bucket for the
    codec)."""
    bucket = sum(r["bucket_frames"] for r in w.records)
    if not bucket:
        return None
    return 100.0 * (1.0 - sum(r["true_frames"] for r in w.records) / bucket)


def mfu_pct(w):
    """The window's operations at the calls' true lengths (``costs``) over
    the window's seconds times the configuration's peak rate."""
    flops = sum(r.get("flops", 0) for r in w.records)
    if not flops or w.seconds <= 0:
        return None
    return 100.0 * flops / (w.seconds * w.peak_flop_per_s)


def device_idle_pct(w):
    """The share of the profiled slice in which no operation ran on the card."""
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)


def kernels_roofline_pct(w):
    """The least time of the profiled slice's K1 / K2 / K3 launches (the
    frozen ``kernel_cost`` at the shapes the calls launched, the larger of
    operations over the peak and bytes over HBM) over their device time, by
    kernel name, from the trace."""
    if w.trace is None:
        return None
    device_s, found = 0.0, 0
    for needle in costs.KERNEL_NAMES.values():
        s, n = w.trace.kernel_seconds(needle)
        device_s, found = device_s + s, found + n
    launches = [x for r in w.trace.records for x in r["launches"]]
    if not found or not launches:
        return None
    if found != len(launches):
        print(f"[roofline] {found} kernel launches traced, {len(launches)} counted from the "
              "calls' shapes", file=sys.stderr)
    least = sum(costs.least_seconds(*costs.kernel_cost(k, rows, c, w.trace.io_bytes), w.trace.arithmetic,
                                    w.trace.peaks) for k, rows, c in launches)
    return 100.0 * least / device_s
