"""Dump the codec round trip of every corpus utterance to a cache dir.

    python -m flamed_tts_tpu_torch.dump_decoded --corpus corpus \\
        --codec-dir artifacts/codec_r5 --out-dir decoded [--device cuda|cpu]

decode(vq2emb(analyze(encode(wav)))) is the output domain of the TTS
pipeline; the phone recognizer trains on it (``train_asr --train-on decoded
--decoded-cache``) so that its WER on synthesized audio is not dominated by
codec artifacts.  A file already in the cache is kept.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Sequence

from flamed_tts_tpu_torch.device import resolve_device


def dump_decoded(corpus: str, codec, out_dir: str, log=print) -> Dict:
    """Round-trip each ``fab_manifest.txt`` wav of ``corpus`` not yet in
    ``out_dir`` into ``out_dir/<stem>.wav``; returns {"decoded", "skipped",
    "audio_s" (of the decoded), "seconds" (wall)}."""
    from flamed_tts_tpu_torch.utils.audio import load_wav, save_wav

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    n = skipped = 0
    audio_s = 0.0
    with open(os.path.join(corpus, "fab_manifest.txt"), encoding="utf-8") as fin:
        lines = [ln.strip().split("|") for ln in fin if ln.strip()]
    for parts in lines:
        stem = os.path.splitext(os.path.basename(parts[0]))[0]
        out_path = os.path.join(out_dir, f"{stem}.wav")
        if os.path.isfile(out_path):
            skipped += 1
            continue
        wav = load_wav(parts[0])
        save_wav(out_path, codec.round_trip(wav))
        audio_s += len(wav) / 16000.0
        n += 1
        if n % 100 == 0:
            log(f"  {n}/{len(lines)} ({time.time() - t0:.0f}s)")
    seconds = time.time() - t0
    log(f"decoded {n} utterances -> {out_dir} ({seconds:.0f}s)")
    return {"decoded": n, "skipped": skipped, "audio_s": audio_s, "seconds": seconds}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--corpus", required=True)
    parser.add_argument("--codec-dir", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from flamed_tts_tpu_torch.config import load_default_config
    from flamed_tts_tpu_torch.synthesize import get_codec

    codec = get_codec(load_default_config(), args.codec_dir, device)
    return dump_decoded(args.corpus, codec, args.out_dir)


if __name__ == "__main__":
    main()
