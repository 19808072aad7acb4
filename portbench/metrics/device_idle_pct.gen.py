"""The share of the traced window with no device operation running, %."""
from portbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
