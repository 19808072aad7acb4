"""A request's wall time minus the device span of its solve (CUDA events
around the ``optimize_hypos`` call), averaged over the timed requests of a
traced run, ms: the task layer's host work and the copy back."""


def read(run):
    spans = run.cell.call_device_s() if run.trace is not None else []
    if not spans:
        return None
    rest = [w - d for w, d in zip(run.latencies, spans)]
    return 1e3 * sum(rest) / len(rest)
