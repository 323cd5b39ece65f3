"""Device, synthesis: the share of the profiled slice with no operation on the card."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
