"""Hand kernels in bf16 io (the served codec): least time over device time of K1 / K2 / K3."""

from benchmark.readers import kernels_roofline_pct as read  # noqa: F401
