"""The traced window: the harness's spans and the device's operations from
``torch.profiler`` (CUPTI), reduced in memory to what the per-layer metrics
read. Nothing is written to disk.

A span is a ``record_function`` range the harness opens around its calls into
the program (``span("request")``, ...); its name carries the ``pb.`` prefix
in the trace. Device operations are the kernels, copies and sets on the card.
"""
from __future__ import annotations

import contextlib
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

PREFIX = "pb."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[float, float]  # seconds

SETUP_PHASES: List[Tuple[str, float]] = []  # (phase, seconds), in order


@contextlib.contextmanager
def setup_phase(name: str, device=None):
    """Time one phase of set-up on the host clock, the card synchronised at
    its end, into ``SETUP_PHASES`` (the split a run prints on standard
    error)."""
    t0 = time.perf_counter()
    yield
    if device is not None and getattr(device, "type", device) == "cuda":
        import torch

        torch.cuda.synchronize(device)
    SETUP_PHASES.append((name, time.perf_counter() - t0))


def span(name: str):
    """A harness span around a call into the program (a no-op outside a
    trace)."""
    import torch

    return torch.profiler.record_function(PREFIX + name)


@dataclass
class Trace:
    """One traced window. ``ops``: device operations ``(name, start, end)``;
    ``spans``: harness spans. Times in seconds from the window's start."""
    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    window: Interval
    busy: List[Interval] = field(default_factory=list)

    def __post_init__(self):
        self.busy = merge((s, e) for _, s, e in self.ops)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def op_seconds(self, pattern: str) -> float:
        """Summed time of the device operations whose name matches
        ``pattern`` (a regular expression searched in the name)."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.ops if rx.search(n))

    def idle_gaps(self) -> List[Interval]:
        """The window's stretches with no device operation running."""
        gaps, at = [], self.window[0]
        for s, e in self.busy:
            if s > at:
                gaps.append((at, min(s, self.window[1])))
            at = max(at, e)
        if at < self.window[1]:
            gaps.append((at, self.window[1]))
        return [g for g in gaps if g[1] > g[0]]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by the
        innermost harness span open at the start of each gap."""
        by_op: Dict[str, float] = {}
        for n, s, e in self.ops:
            k = short_name(n)
            by_op[k] = by_op.get(k, 0.0) + (e - s)
        by_span: Dict[str, float] = {}
        for s, e in self.idle_gaps():
            k = self.innermost_span(s) or "outside any span"
            by_span[k] = by_span.get(k, 0.0) + (e - s)
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in order(by_op)],
                "idle_gaps": [[k, v] for k, v in order(by_span)]}

    def innermost_span(self, at: float) -> Optional[str]:
        best = None
        for n, s, e in self.spans:
            if s <= at < e and (best is None or e - s < best[1]):
                best = (n, e - s)
        return best[0] if best else None


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def short_name(name: str) -> str:
    """A kernel's name without ``void``, namespaces, template arguments and
    parameters."""
    n = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in n:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out).split("(")[0].split("::")[-1].strip() or name


def _kind(ev) -> str:
    """The event's kind: ``kernel``, ``gpu_memcpy``, ``gpu_memset``,
    ``user_annotation`` (a span on the host), ``gpu_user_annotation`` or
    another: from kineto's activity type where the event has one, else from
    its device and name."""
    kind = getattr(ev, "activity_type", None)
    kind = str(kind()).lower() if callable(kind) else ""
    cuda = "cuda" in str(ev.device_type()).lower()
    name = ev.name()
    annotation = getattr(ev, "is_user_annotation", None)
    annotation = bool(annotation()) if callable(annotation) else name.startswith(PREFIX)
    if "gpu_user_annotation" in kind or (cuda and annotation):
        return "gpu_user_annotation"
    if "user_annotation" in kind or annotation:
        return "user_annotation"
    for k in ("memcpy", "memset"):
        if k in kind or (cuda and k in name.lower()):
            return "gpu_" + k
    if "kernel" in kind or cuda:
        return "kernel"
    return kind or "cpu_op"


def reduce_events(events, window: Interval) -> Trace:
    """A ``Trace`` from kineto events (``prof.profiler.kineto_results.events()``)
    and the window ``(start_ns, end_ns)`` on the same clock."""
    t0 = window[0]
    ops, spans = [], []
    for ev in events:
        kind, name = _kind(ev), ev.name()
        s = (ev.start_ns() - t0) * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if kind in DEVICE_KINDS:
            w = (window[1] - t0) * 1e-9
            if e > 0.0 and s < w:  # clipped to the window
                ops.append((name, max(s, 0.0), min(e, w)))
        elif kind == "user_annotation" and name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], s, e))
    return Trace(ops, spans, (0.0, (window[1] - t0) * 1e-9))


def busy_seconds(events) -> float:
    """The seconds in which any device operation ran: the union of their
    intervals, from kineto events recorded with the device's activity alone
    (``device_busy``: no host events, so no spans on the device either)."""
    import numpy as np

    start, dur, on_device = [], [], {}
    for ev in events:  # some millions in a long window: one pass, little per event
        dt = ev.device_type()
        if dt not in on_device:
            on_device[dt] = "cuda" in str(dt).lower()
        if on_device[dt]:
            start.append(ev.start_ns())
            dur.append(ev.duration_ns())
    if not start:
        return 0.0
    s = np.asarray(start, np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], (s + np.asarray(dur, np.int64))[order]
    reach = np.maximum.accumulate(e)
    first = np.ones(len(s), bool)
    first[1:] = s[1:] > reach[:-1]
    return float((np.maximum.reduceat(e, np.flatnonzero(first)) - s[first]).sum()) * 1e-9


@contextlib.contextmanager
def device_busy(result: list):
    """Record the body's device operations alone (CUPTI, no host events, so
    the kernels' times hold, and no correlation with host operations, which
    would only slow the trace's reading); append their ``busy_seconds`` to
    ``result``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    config = torch._C._profiler._ExperimentalConfig(disable_external_correlation=True)
    with profile(activities=[ProfilerActivity.CUDA], experimental_config=config) as prof:
        yield
        torch.cuda.synchronize()
    result.append(busy_seconds(prof.profiler.kineto_results.events()))


@contextlib.contextmanager
def profiled(result: list):
    """Profile the body on the CPU and the card; append its ``Trace`` to
    ``result``. The window runs from the body's first span to its last
    span's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    marks = [(ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in events
             if _kind(ev) == "user_annotation" and ev.name() == PREFIX + "request"]
    if not marks:
        raise RuntimeError("the traced window holds no request span")
    result.append(reduce_events(events, (min(m[0] for m in marks), max(m[1] for m in marks))))
