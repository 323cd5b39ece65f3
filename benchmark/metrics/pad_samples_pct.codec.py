"""Buckets, codec: 1 - true samples / seconds-bucket samples over the window's round trips."""

from benchmark.readers import pad_pct as read  # noqa: F401
