"""Rows of every train step whose loss was read back, over the wall seconds
of the timed requests of a traced run (before the profiler starts)."""


def read(run):
    if run.trace is None or not run.window_s:
        return None
    return run.items / run.window_s
