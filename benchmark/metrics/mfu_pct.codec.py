"""Whole round trip: operations at true lengths over window seconds times the TF32 peak."""

from benchmark.readers import mfu_pct as read  # noqa: F401
