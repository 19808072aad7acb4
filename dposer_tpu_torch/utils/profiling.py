"""Profiling and step timing for the training and sampling loops (port of
``dposer_tpu/utils/profiling.py``).

- ``trace_annotation``: a named span on the profiler's timeline
  (``torch.profiler.record_function``; next to nothing when no trace runs).
- ``Trace`` and ``profile_trace``: trace the host and the card
  (``torch.profiler``, CUPTI on the card) and write one Chrome trace file
  into a directory.
- ``StepTimer``: wall-clock steps with an exponentially smoothed rate.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def trace_annotation(name: str):
    """A named span for the profiler's timeline."""
    return torch.profiler.record_function(name)


class Trace:
    """A running trace of the host (and the card when ``device`` is a CUDA
    device), started here; ``stop()`` writes
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

    def stop(self) -> str:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profiler.stop()
        self.path = os.path.join(self.logdir, f"trace_{os.getpid()}_{int(time.time())}.json")
        self.profiler.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def profile_trace(logdir: str, device=None):
    """A ``Trace`` of the block; its ``path`` names the file once written."""
    trace = Trace(logdir, device)
    try:
        yield trace
    finally:
        trace.stop()


class StepTimer:
    """Throughput meter: ``tick(stream)`` marks a step, after synchronising
    the CUDA ``stream`` when one is given (kernels return before the device
    is done), and keeps an exponentially smoothed rate."""

    def __init__(self, smoothing: float = 0.98):
        self.smoothing = smoothing
        self._last: Optional[float] = None
        self._rate: Optional[float] = None
        self.steps = 0

    def tick(self, stream: Optional[torch.cuda.Stream] = None) -> Optional[float]:
        if stream is not None:
            stream.synchronize()
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
