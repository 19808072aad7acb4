"""Device time of a sampler call, ms: CUDA events around each timed call of
a traced run, averaged."""


def read(run):
    times = run.cell.call_device_s() if run.trace is not None else []
    return 1e3 * sum(times) / len(times) if times else None
