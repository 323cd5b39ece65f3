"""Orchestration: the share of calls whose speculative frame bucket
overflowed, so that the stages after the durations ran again (more than one
``fused_dispatch`` span in the call)."""


def read(w):
    calls = [r for r in w.records if "dispatches" in r]
    if not calls:
        return None
    return 100.0 * sum(r["dispatches"] > 1 for r in calls) / len(calls)
