"""Device time per train step, ms: the seconds in which any device operation
ran over the whole window (``trace.device_busy``), over the window's steps."""


def read(run):
    if not run.device_busy_s:
        return None
    return 1e3 * run.device_busy_s / run.work["train_steps"]
