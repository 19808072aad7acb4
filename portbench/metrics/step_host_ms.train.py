"""Host time to enqueue one train step, ms: a harness span around each call
of the step function (which holds no synchronisation), averaged over the
timed requests of a traced run."""


def read(run):
    times = run.cell.step_host_s if run.trace is not None else []
    return 1e3 * sum(times) / len(times) if times else None
