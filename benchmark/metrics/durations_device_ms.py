"""Prior, denoiser, codec: device ms a call in the phoneme encoder and the
PVA Euler loop (the program's `device.durations` mark)."""


def read(w):
    total, count = w.spans.get("device.durations", (0.0, 0))
    return 1e3 * total / len(w.records) if count and w.records else None
