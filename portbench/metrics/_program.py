"""The program's own spans and counters (``dposer_tpu_torch.utils.profiling``)
for the readers of the program's layers, in a traced run.

After the harness's timed and profiled requests, the first such reader runs
the program-traced phase: twice the traffic's ``trace_requests`` more
requests (ids ``2n .. 4n - 1``), the program's spans on in every second one
(inside the recorder's ``request(i)``) and off in the others, no profiler,
and the harness's CUDA events around each call as in the timed requests.
The readers read the requests with spans on; those with spans off, run in
turns with them in the same state of the process (after the profiler), say
what the spans cost. The phase is kept on the run, so every reader reads
the same one; it comes after every reader of the accepted metrics, so none
of them reads it. Set-up spans are those the program kept since the process
started (it times set-up whether or not spans are on).

It prints on standard error a ``span <name> <count> <total_s> <self_s>``
line a span name (set-up and the phase), a ``counter <name> <change>`` line
a counter that moved in the requests with spans on, and, spans on against off, the mean host
time of a request and of a train step, and the device time of a call
(the harness's events). A program without the recorder runs no phase: every
reader reads None.
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import Optional


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from dposer_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "take_setup") else None


def setup_seconds(setup: list) -> float:
    """The seconds of the set-up spans that lie inside no other one."""
    return sum((e - s) * 1e-9 for _, s, e, depth in setup if depth == 0)


def setup_summary(setup: list) -> dict:
    """``{name: (count, total_s, self_s)}`` of set-up spans, a span's self
    time less the set-up spans one deeper inside it."""
    out: dict = {}
    for name, s, e, depth in setup:
        inner = sum(e2 - s2 for _, s2, e2, d2 in setup if d2 == depth + 1 and s <= s2 and e2 <= e)
        n, total, own = out.get(name, (0, 0.0, 0.0))
        out[name] = (n + 1, total + (e - s) * 1e-9, own + (e - s - inner) * 1e-9)
    return out


def _moved(before: dict, after: dict) -> dict:
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            for name, d in _moved(before[k], v).items():
                out[f"{k}.{name}"] = d
        elif v != before[k]:
            out[k] = v - before[k]
    return out


def _mean_ms(seconds) -> Optional[float]:
    return 1e3 * sum(seconds) / len(seconds) if seconds else None


def phase(run):
    """The program-traced phase of ``run`` (``SimpleNamespace``: ``spans``,
    ``summary``, ``setup``, ``counters``, the change of each counter that
    moved, ``latencies`` and ``wall_s`` of the requests with spans on), run
    at the first call; None outside a traced run or without the program's
    recorder."""
    if hasattr(run, "program"):
        return run.program
    run.program = None
    prof = recorder()
    if run.trace is None or prof is None:
        return None
    import torch

    cell, n = run.cell, run.n
    cuda = torch.device(cell.dev).type == "cuda"
    setup = prof.take_setup()
    prof.take()
    moved: dict = {}
    lat = {False: [], True: []}
    steps = {False: [], True: []}
    calls = {False: [], True: []}
    try:
        for j in range(2 * n):
            on = j % 2 == 1
            k, e = len(getattr(cell, "step_host_s", [])), len(getattr(cell, "events", []))
            before = prof.counters() if on else None
            prof.enable(on)
            with prof.request(2 * n + j):
                t0 = time.perf_counter()
                cell.request(2 * n + j, timed_device=cuda)
                lat[on].append(time.perf_counter() - t0)
            prof.enable(False)
            if on:
                for name, d in _moved(before, prof.counters()).items():
                    moved[name] = moved.get(name, 0) + d
            steps[on] += getattr(cell, "step_host_s", [])[k:]
            calls[on] += getattr(cell, "events", [])[e:]
    finally:
        prof.enable(False)
    spans = prof.take()
    run.program = SimpleNamespace(spans=spans, summary=prof.summary(spans), setup=setup,
                                  counters=moved, latencies=lat[True], wall_s=sum(lat[True]))
    for name, (count, total, own) in sorted({**setup_summary(setup),
                                             **run.program.summary}.items()):
        print(f"span {name} {count} {total!r} {own!r}", file=sys.stderr)
    for name, d in sorted(moved.items()):
        print(f"counter {name} {d}", file=sys.stderr)
    for what, got in (("a request's mean host ms", lat), ("a train step's mean host ms", steps),
                      ("a call's mean device ms", calls)):
        if got[True] and what.endswith("device ms"):
            torch.cuda.synchronize()
            got = {on: [a.elapsed_time(b) * 1e-3 for a, b in got[on]] for on in got}
        if got[True]:
            print(f"program spans: {what} {_mean_ms(got[True])!r} on, {_mean_ms(got[False])!r}"
                  f" off", file=sys.stderr)
    return run.program


def mean_ms(run, name: str, per: Optional[str] = None, own: bool = False):
    """The mean seconds (``own``: self seconds) of the spans ``name`` in the
    phase, over their count or over the count of the spans ``per``, ms."""
    p = phase(run)
    if p is None or name not in p.summary:
        return None
    count, total, self_s = p.summary[name]
    if per is not None:
        count = p.summary.get(per, (0,))[0]
    return 1e3 * (self_s if own else total) / count if count else None


def replays(run):
    """The device seconds of each replay in the phase (CUDA events around
    ``GraphLoop``'s replay)."""
    p = phase(run)
    if p is None:
        return []
    return [s.device_s for s in p.spans if s.name == "loop.replay" and s.device_s is not None]


def replay_device_ms(run):
    return _mean_ms(replays(run))


def loop_idle_pct(run):
    """100 × (1 − the replays' device seconds over the wall seconds of the
    requests with spans on): the device's idle share with no profiler."""
    dev = replays(run)
    p = run.program
    return 100.0 * (1.0 - sum(dev) / p.wall_s) if dev and p.wall_s > 0 else None


def graph_hit_pct(run):
    """Loop calls served by a graph already captured, over all loop calls in
    the phase, %: replays less captures over replays and eager calls."""
    p = phase(run)
    if p is None:
        return None
    calls = sum(p.summary.get(k, (0,))[0] for k in ("loop.replay", "loop.eager"))
    hits = p.counters.get("graph_replays", 0) - p.counters.get("graph_captures", 0)
    return 100.0 * hits / calls if calls else None


def build_s(run):
    """The program's set-up spans summed (builds, calibration, warm-up,
    capture, instantiation, the train state), s."""
    p = phase(run)
    return setup_seconds(p.setup) if p is not None and p.setup else None
