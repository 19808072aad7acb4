"""Set-up: from the process's start to the window's, seconds (the weights,
the program's build and warm-up, a first run's compile)."""


def read(run):
    return run.setup_s
