"""Prior, denoiser, codec: device ms a call in length regulation and the
prior's decoders (the program's `device.prior_decode` mark; an overflow
retry adds its second run)."""


def read(w):
    total, count = w.spans.get("device.prior_decode", (0.0, 0))
    return 1e3 * total / len(w.records) if count and w.records else None
