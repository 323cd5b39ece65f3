"""End to end, synthesis: window seconds over the seconds of audio synthesized in it."""

from benchmark.readers import real_time_factor as read  # noqa: F401
