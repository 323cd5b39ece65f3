"""Orchestration: host ms a call spends in the program's ``fused_dispatch``
span (enqueueing the fused call, or replaying its graph, with the input
copies), total over the window over the calls."""


def read(w):
    total, count = w.spans.get("fused_dispatch", (0.0, 0))
    return 1e3 * total / len(w.records) if count and w.records else None
