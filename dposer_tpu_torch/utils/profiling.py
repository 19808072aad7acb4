"""Step timing for the training and sampling loops (port of
``StepTimer`` in ``dposer_tpu/utils/profiling.py``)."""
from __future__ import annotations

import time
from typing import Optional

import torch


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
