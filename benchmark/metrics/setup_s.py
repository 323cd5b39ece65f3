"""End to end: seconds from the process's start to the first timed call
(weights, the program built, every shape of the cell warmed up)."""


def read(w):
    return w.setup_s
