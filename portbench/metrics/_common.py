"""What several readers share: a kernel's share of its roofline, the model
step's share of the chip's peak, and the device's idle share, all from the
traced window. A reader that finds nothing to read returns None."""
from __future__ import annotations

import importlib

from portbench import peaks


def roofline_pct(run, kernel: str):
    """The kernel's bound (the work the traffic asked of it in the window)
    over its device time in the trace, %."""
    if run.trace is None:
        return None
    rf = importlib.import_module(f"portbench.roofline.{kernel}")
    t = run.trace.op_seconds(rf.PATTERN)
    return 100.0 * rf.bound_s(run.work) / t if t > 0 else None


def mfu_pct(run):
    """The matmul operations the traffic needs in the timed requests of a
    traced run, each over the peak of its type, over their wall seconds, %
    (the profiler's own overhead left out)."""
    if run.trace is None:
        return None
    at_peak = (run.work.get("flops_bf16", 0) / peaks.BF16_TC_FLOPS
               + run.work.get("ops_int8", 0) / peaks.INT8_TC_OPS)
    return 100.0 * at_peak / run.window_s


def idle_pct(run):
    """The share of the traced window with no device operation running, %."""
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
