"""Hand kernels in fp32 io (the codec cell): least time over device time of K1 / K2 / K3."""

from benchmark.readers import kernels_roofline_pct as read  # noqa: F401
