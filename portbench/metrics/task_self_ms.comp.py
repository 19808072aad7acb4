"""The completion task's own host time a request, ms: the span
``comp.optimize_hypos`` less its child spans (the solver's lookup, the
loop's call), averaged over the program-traced phase."""
from portbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "comp.optimize_hypos", own=True)
