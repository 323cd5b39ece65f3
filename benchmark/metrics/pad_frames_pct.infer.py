"""Buckets, synthesis: 1 - true frames / frame-bucket frames over the window's calls."""

from benchmark.readers import pad_pct as read  # noqa: F401
