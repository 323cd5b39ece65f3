"""Prior, denoiser, codec: device ms a call in the served prompt's encode +
analyze (the program's `device.codec_encode` mark, inside the captured call)."""


def read(w):
    total, count = w.spans.get("device.codec_encode", (0.0, 0))
    return 1e3 * total / len(w.records) if count and w.records else None
