"""Steady-state timing of enqueued device work (port of
``dposer_tpu/utils/benchtime.py``).

A launch returns before the device has finished, so timing one call on the
host clock measures the enqueue. The steady-state measurement enqueues
``m_pipe`` tasks back to back and ends them with one synchronisation of the
device the last task's output lives on (the JAX package ends them with a
device-to-host read instead); the device runs a stream in order, so that
bounds all of them.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def steady_state(launch: Callable[[int], torch.Tensor], m_pipe: int = 8,
                 rounds: int = 3) -> float:
    """Best-of-``rounds`` steady-state seconds per task.

    ``launch(i)`` enqueues task ``i`` and returns a tensor it writes, without
    synchronising. The caller runs one warm-up ``launch`` first, so that
    building and loading the kernels stay out of the timing. On a CPU tensor
    the work is done when ``launch`` returns.
    """
    times = []
    for r in range(rounds):
        t0 = time.perf_counter()
        out = None
        for i in range(m_pipe):
            out = launch(r * m_pipe + i)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        times.append((time.perf_counter() - t0) / m_pipe)
    return min(times)
