"""Device, synthesis: the share of the window in which no marked stage ran
on the card, from the program's `device.*` marks, with no profiler present.
The eager noise draws and the host copies fall outside the marks."""


def read(w):
    busy = [total for name, (total, count) in w.spans.items() if name.startswith("device.") and count]
    if not busy or w.seconds <= 0:
        return None
    return 100.0 * (1.0 - sum(busy) / w.seconds)
