"""Whole synthesis call: operations at true lengths over window seconds times the bf16 peak."""

from benchmark.readers import mfu_pct as read  # noqa: F401
