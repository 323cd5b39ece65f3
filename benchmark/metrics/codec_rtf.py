"""End to end, codec: window seconds over the seconds of audio round-tripped in it."""

from benchmark.readers import real_time_factor as read  # noqa: F401
