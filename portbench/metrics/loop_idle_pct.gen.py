"""The device's idle share in the program-traced phase, %: 100 × (1 − the
replays' device seconds, from the program's CUDA events, over the phase's
wall seconds), without the profiler."""
from portbench.metrics._program import loop_idle_pct


def read(run):
    return loop_idle_pct(run)
