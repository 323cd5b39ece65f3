"""Prior, denoiser, codec: device ms a call in the denoiser's Euler loop (the
program's `device.denoiser` mark; an overflow retry adds its second run)."""


def read(w):
    total, count = w.spans.get("device.denoiser", (0.0, 0))
    return 1e3 * total / len(w.records) if count and w.records else None
