"""Profiling and step timing for the training and sampling loops (port of
``dposer_tpu/utils/profiling.py``).

- ``span`` (``spanned``: a function's calls as spans): the program's spans
  at its layer boundaries (the task, the graph loop, the train step,
  set-up). Off by default: a span then costs one check of a module flag.
  ``enable(True)`` records each span in memory as a ``Span`` on
  ``time.time_ns()``'s clock, the clock kineto stamps its events with, so a
  span can be laid on a device trace as it is; while a profiler runs, a
  span also opens ``record_function("dp." + name)``, so Chrome traces show
  it. ``request(i)`` tags the spans inside it, ``take()`` hands
  the recorded spans over, ``device_events()`` adds a pair of CUDA events to
  the innermost open span (its device time), ``counters()`` reads the
  program's counters where they live; ``self_seconds`` and ``summary``
  reduce the spans.
- ``setup_span``: a span of set-up (a build, a calibration, a capture),
  always timed and kept until ``take_setup()``; recorded as a span too when
  spans are on.
- ``Trace``: trace the host (and the card) with ``torch.profiler``, the
  program's spans on, and write one Chrome trace file into a directory.
- ``StepTimer``: wall-clock steps with an exponentially smoothed rate.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch

PREFIX = "dp."  # a span's name in a profiler's trace

_on = False
_spans: list = []  # records [name, start_ns, end_ns, parent, request, events, index]
_setup: list = []  # set-up spans: (name, start_ns, end_ns, depth)
_local = threading.local()  # per thread: the open records, the request id, set-up depth
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    """A recorded span. ``parent`` indexes the list ``take()`` returned (None
    at the top); ``request`` is the id of the enclosing ``request(i)``;
    ``device_s`` the seconds between the span's CUDA events, if it recorded
    any (``device_events``)."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: Optional[int]
    device_s: Optional[float]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def enable(on: bool = True) -> bool:
    """Turn span recording on or off; returns the previous setting."""
    global _on
    was, _on = _on, bool(on)
    return was


def _state():
    st = _local
    if not hasattr(st, "open"):
        st.open, st.request, st.setup_depth = [], None, 0
    return st


class _Span:
    """An open span: timed, and recorded when recording was on at its
    start. ``seconds`` once it ends."""
    __slots__ = ("name", "rec", "rf", "start_ns", "end_ns")

    def __init__(self, name: str):
        self.name, self.rec, self.rf = name, None, None

    def __enter__(self):
        self.start_ns = time.time_ns()
        if _on:
            st = _state()
            parent = st.open[-1][6] if st.open else None
            self.rec = [self.name, self.start_ns, None, parent, st.request, None, len(_spans)]
            _spans.append(self.rec)
            st.open.append(self.rec)
            if torch.autograd._profiler_enabled():
                self.rf = torch.profiler.record_function(PREFIX + self.name)
                self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.end_ns = time.time_ns()
        if self.rec is not None:
            self.rec[2] = self.end_ns
            _state().open.pop()
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def span(name: str):
    """A span named ``name`` around the block: a shared no-op when recording
    is off."""
    return _Span(name) if _on else _NULL


def spanned(name: str):
    """Decorate a function: each call is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


@contextlib.contextmanager
def _request(i):
    st = _state()
    prev, st.request = st.request, i
    try:
        yield
    finally:
        st.request = prev


def request(i: int):
    """Tag the spans opened inside the block with request id ``i`` (a no-op
    when recording is off)."""
    if not _on:
        return _NULL
    return _request(i)


@contextlib.contextmanager
def _events():
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    try:
        yield
    finally:
        ev[1].record()
        st = _state()
        if st.open:
            rec = st.open[-1]
            rec[5] = (rec[5] or []) + [ev]


def device_events():
    """CUDA events on the current stream around the block, kept on the
    innermost open span: ``take()`` gives their seconds as its ``device_s``.
    A no-op when recording is off."""
    return _events() if _on else _NULL


def take() -> List[Span]:
    """The spans recorded since the last ``take()``, in the order they
    opened, and clears them; waits for their CUDA events. Call it outside
    every span."""
    global _spans
    recs, _spans = _spans, []
    out = []
    for name, s, e, parent, req, events, _ in recs:
        dev = None
        if events:
            for a, b in events:
                b.synchronize()
            dev = sum(a.elapsed_time(b) for a, b in events) * 1e-3
        out.append(Span(name, s, e if e is not None else s, parent, req, dev))
    return out


def self_seconds(spans: List[Span]) -> List[float]:
    """Each span's seconds less those of its child spans (``take()``'s list)."""
    out = [s.seconds for s in spans]
    for s in spans:
        if s.parent is not None:
            out[s.parent] -= s.seconds
    return out


def summary(spans: List[Span]) -> dict:
    """``{name: (count, total_s, self_s)}`` over ``take()``'s list."""
    out: dict = {}
    for s, own in zip(spans, self_seconds(spans)):
        n, total, self_s = out.get(s.name, (0, 0.0, 0.0))
        out[s.name] = (n + 1, total + s.seconds, self_s + own)
    return out


class _SetupSpan(_Span):
    """A set-up span: timed and kept whether or not recording is on."""
    __slots__ = ("depth",)

    def __enter__(self):
        st = _state()
        self.depth, st.setup_depth = st.setup_depth, st.setup_depth + 1
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _state().setup_depth = self.depth
        _setup.append((self.name, self.start_ns, self.end_ns, self.depth))
        return False


def setup_span(name: str) -> _SetupSpan:
    """A span of set-up: timed whether or not spans are on (set-up runs
    once), kept until ``take_setup()``, and a ``span`` besides."""
    return _SetupSpan(name)


def take_setup() -> list:
    """The set-up spans since the last call, ``(name, start_ns, end_ns,
    depth)`` in the order they ended (``depth`` 0: inside no other set-up
    span), and clears them."""
    global _setup
    out, _setup = _setup, []
    return out


def counters() -> dict:
    """One snapshot of the program's counters, read where they live: each
    kernel's launches, routes and programmatic launches, the kernels' scope
    refusals by reason (``scope.refused``), the graph loops' captures and
    replays, ``DPoserComp``'s solver builds and lookups, the train window's
    host reads."""
    from ..ops.cuda.fused_em import (launch_counts, programmatic_counts, route_counts,
                                     scope_refused_counts)
    from ..ops.cuda.graph_loop import GraphLoop
    from ..parallel import sharding
    from ..tasks.completion import DPoserComp

    return dict(launches=launch_counts(), routes=route_counts(),
                programmatic=programmatic_counts(),
                scope=dict(refused=scope_refused_counts()),
                graph_captures=GraphLoop.captures, graph_replays=GraphLoop.replays,
                solver_builds=DPoserComp.solver_builds,
                solver_lookups=DPoserComp.solver_lookups,
                train_host_reads=sharding.host_reads)


class Trace:
    """A running trace of the host (and the card when ``device`` is a CUDA
    device), started here, with the program's spans on; ``stop()`` writes
    ``<logdir>/trace_<pid>_<time>.json`` (Chrome trace format, for
    chrome://tracing or Perfetto) and returns its path."""

    def __init__(self, logdir: str, device=None):
        self.logdir = logdir
        self.device = None if device is None else torch.device(device)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        self.profiler = torch.profiler.profile(activities=activities)
        self.path: Optional[str] = None
        self.profiler.start()
        self._was_on = enable(True)

    def stop(self) -> str:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profiler.stop()
        if not self._was_on:
            enable(False)
            take()  # the spans are in the trace file; nothing else reads them
        self.path = os.path.join(self.logdir, f"trace_{os.getpid()}_{int(time.time())}.json")
        self.profiler.export_chrome_trace(self.path)
        return self.path


class StepTimer:
    """Throughput meter: ``tick()`` marks a step and keeps an exponentially
    smoothed rate."""

    def __init__(self, smoothing: float = 0.98):
        self.smoothing = smoothing
        self._last: Optional[float] = None
        self._rate: Optional[float] = None
        self.steps = 0

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            inst = 1.0 / max(now - self._last, 1e-9)
            self._rate = inst if self._rate is None else (
                self.smoothing * self._rate + (1 - self.smoothing) * inst)
        self._last = now
        self.steps += 1
        return self._rate

    @property
    def steps_per_sec(self) -> Optional[float]:
        return self._rate
