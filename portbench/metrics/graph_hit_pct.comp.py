"""Loop calls served by a CUDA graph already captured, over all loop calls
of the program-traced phase, %: from ``GraphLoop.replays`` and
``GraphLoop.captures``."""
from portbench.metrics._program import graph_hit_pct


def read(run):
    return graph_hit_pct(run)
