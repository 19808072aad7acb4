"""Device time of a graph replay, ms: the program's CUDA events around
``GraphLoop``'s replay alone, averaged over the program-traced phase."""
from portbench.metrics._program import replay_device_ms


def read(run):
    return replay_device_ms(run)
