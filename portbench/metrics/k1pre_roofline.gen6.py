"""Generation at 126 dims: K1's pre route's share of its roofline in the
traced window, %."""
from portbench.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "k1pre")
