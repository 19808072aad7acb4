"""The window's arithmetic: a rate over all its work and time, a tail over
all its requests; a stall moves both."""
from types import SimpleNamespace

from portbench import harness


def window(durations, seconds):
    clock = SimpleNamespace(t=0.0)
    it = iter(durations)

    def request(i):
        clock.t += next(it)
        return 10

    return harness.closed_window(request, seconds, clock=lambda: clock.t)


def read(name, items, lat, window_s):
    return harness.reader(name)(SimpleNamespace(items=items, latencies=lat, window_s=window_s))


def test_rate_and_tail_over_the_whole_window():
    items, lat, w = window([0.125] * 100, 1.0)
    assert len(lat) == 8 and w == 1.0
    assert read("poses_per_s", items, lat, w) == 80.0
    assert read("request_p95_ms", items, lat, w) == 125.0


def test_a_stall_moves_both():
    base = window([0.125] * 100, 1.0)
    stalled = window([0.125] * 5 + [0.625] + [0.125] * 100, 1.0)
    assert read("poses_per_s", *stalled) < read("poses_per_s", *base)
    assert read("request_p95_ms", *stalled) > read("request_p95_ms", *base)
    # the request that ran past the deadline is counted, with its time
    assert stalled[2] >= 1.0 and stalled[0] == 10 * len(stalled[1])


def test_percentile():
    assert harness.percentile(list(range(101)), 95.0) == 95.0
    assert harness.percentile([1.0, 2.0], 50.0) == 1.5
