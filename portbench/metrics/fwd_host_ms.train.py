"""Host time of a train step's forward, ms: the span ``train.forward``
(``zero_grad``, the t/z draws, K10 and K11 launched), a step's mean in the
program-traced phase."""
from portbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "train.forward", per="train.step")
