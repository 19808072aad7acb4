"""Generation: the k1 kernel's share of its roofline in the traced window, %."""
from portbench.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "k1")
