"""Prior, denoiser, codec: device ms a round trip in `vq2emb` and the codec's
decoder, launched eagerly: from the stage's first work on the card to its
last, launch waits included (the program's `device.codec_decode`)."""


def read(w):
    total, count = w.spans.get("device.codec_decode", (0.0, 0))
    return 1e3 * total / len(w.records) if count and w.records else None
