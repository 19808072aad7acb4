"""Host time of a train step's update, ms: the span ``train.update`` (the
gradient hook, the clip, Adam, the EMA), a step's mean in the
program-traced phase."""
from portbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "train.update", per="train.step")
