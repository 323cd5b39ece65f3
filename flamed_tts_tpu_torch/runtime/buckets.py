"""Bucket tuples and the bucket rule shared with the JAX package, so that a
run pads its phonemes, prompt and frames exactly as the JAX staged path
does and produces the same outputs."""

from __future__ import annotations

from typing import List, Sequence

DEFAULT_PHONEME_BUCKETS = (64, 128, 192, 256, 512)
DEFAULT_FRAME_BUCKETS = (256, 512, 768, 1024, 1408)
DEFAULT_PROMPT_BUCKETS = (128, 256, 320, 512)
DEFAULT_WAV_SECOND_BUCKETS = (1, 2, 3, 4, 5, 8, 11, 17)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; the largest bucket if n exceeds all."""
    for b in buckets:
        if n <= b:
            return int(b)
    return int(buckets[-1])


def bucket_list(cfg_value, default: Sequence[int]) -> List[int]:
    return sorted(int(b) for b in (default if cfg_value is None else cfg_value))
