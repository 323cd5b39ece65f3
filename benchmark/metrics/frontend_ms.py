"""Text frontend: host ms a request spends in the program's ``frontend``
span (text -> phoneme ids), total over the window over its count."""


def read(w):
    total, count = w.spans.get("frontend", (0.0, 0))
    return 1e3 * total / count if count else None
