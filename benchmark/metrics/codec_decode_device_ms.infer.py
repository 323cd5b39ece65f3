"""Prior, denoiser, codec: device ms a call in the codec's synthesis and the
int16 quantization of the served call (the program's `device.codec_decode`
mark; an overflow retry adds its second run)."""


def read(w):
    total, count = w.spans.get("device.codec_decode", (0.0, 0))
    return 1e3 * total / len(w.records) if count and w.records else None
