"""The 95th percentile of all requests' latencies in the window, ms: from a
request's issue until its results are on the host."""
from portbench.harness import percentile


def read(run):
    return percentile(run.latencies, 95.0) * 1e3
