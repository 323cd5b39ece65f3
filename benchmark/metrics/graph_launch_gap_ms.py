"""Captured executor: device ms a call between an event recorded just before
a graph's replay and the graph's first node, the wait the host's launch
causes (the program's `device_gap.graph_launch` mark; not busy)."""


def read(w):
    total, count = w.spans.get("device_gap.graph_launch", (0.0, 0))
    return 1e3 * total / len(w.records) if count and w.records else None
