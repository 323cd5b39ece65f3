"""Prior, denoiser, codec: device ms a round trip in the codec's encoder and
`analyze`, launched eagerly: from the stage's first work on the card to the
next stage's, launch waits included (the program's `device.codec_encode`)."""


def read(w):
    total, count = w.spans.get("device.codec_encode", (0.0, 0))
    return 1e3 * total / len(w.records) if count and w.records else None
