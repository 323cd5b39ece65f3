"""Captured executor: signatures captured inside the window (the sampler's
``captures`` after the window minus before it); warm-up should leave none."""


def read(w):
    if "captures_before" not in w.counters:
        return None
    return w.counters["captures_after"] - w.counters["captures_before"]
