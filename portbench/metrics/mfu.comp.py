"""The model step's share of the chip's peak in the traced window, %."""
from portbench.metrics._common import mfu_pct


def read(run):
    return mfu_pct(run)
