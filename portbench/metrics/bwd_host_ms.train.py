"""Host time of a train step's backward, ms: the span ``train.backward``
(autograd launching K12 and the weight-gradient GEMMs), a step's mean in the
program-traced phase."""
from portbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "train.backward", per="train.step")
