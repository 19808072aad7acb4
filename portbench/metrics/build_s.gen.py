"""The program's set-up spans summed, s: the builds (``build.*``), the int8
calibration (``quant.calibrate``), the graph's warm-up, capture and
instantiation (``loop.*``), the train state (``train.init``)."""
from portbench.metrics._program import build_s


def read(run):
    return build_s(run)
