"""Poses that reached the host in the window, over the window's seconds."""


def read(run):
    return run.items / run.window_s
