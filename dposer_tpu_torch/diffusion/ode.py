"""Adaptive Dormand-Prince RK45 ODE solver on torch tensors.

scipy's RK45 algorithm (the reference integrates with
``scipy.integrate.solve_ivp``, ref ``sampling.py:530``, ``likelihood.py:99``):
the DOPRI5(4) tableau, the error norm (RMS of err / (atol + rtol * max(|y0|,
|y1|))), the step controller (safety 0.9, growth clamp [0.2, 10], exponent
-1/5) and the initial-step heuristic. The state stays on its device; the
controller runs on the host in float32, so each step costs one
device-to-host read of the error norm.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

# Dormand-Prince 5(4) tableau
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
# b - b_hat (error weights), with the FSAL 7th stage
_E = (71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40)

_SAFETY = np.float32(0.9)
_MIN_FACTOR = np.float32(0.2)
_MAX_FACTOR = np.float32(10.0)
_ERR_EXP = np.float32(-1.0 / 5.0)


class ODEResult(NamedTuple):
    y: torch.Tensor
    nfe: int  # number of RHS evaluations
    status: int  # 0 ok, 1 hit max_steps


def _rms_norm(x: torch.Tensor) -> np.float32:
    return np.float32(torch.sqrt(torch.mean(x ** 2)).item())


def _weighted(coefs, ks) -> torch.Tensor:
    return sum(c * k for c, k in zip(coefs, ks))


def _initial_step(func, t0, y0, f0, direction, order, rtol, atol) -> np.float32:
    """scipy's select_initial_step heuristic."""
    scale = atol + y0.abs() * rtol
    d0 = _rms_norm(y0 / scale)
    d1 = _rms_norm(f0 / scale)
    h0 = np.float32(1e-6) if (d0 < 1e-5 or d1 < 1e-5) else np.float32(0.01) * d0 / d1
    f1 = func(t0 + h0 * direction, y0 + float(h0 * direction) * f0)
    d2 = _rms_norm((f1 - f0) / scale) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = max(np.float32(1e-6), h0 * np.float32(1e-3))
    else:
        h1 = (np.float32(0.01) / max(d1, d2)) ** np.float32(1.0 / (order + 1))
    return min(np.float32(100) * h0, h1)


@torch.no_grad()
def rk45(func: Callable[[float, torch.Tensor], torch.Tensor], t0: float, t1: float,
         y0: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-5,
         max_steps: int = 100_000) -> ODEResult:
    """Integrate ``dy/dt = func(t, y)`` from ``t0`` to ``t1`` (either
    direction); ``func`` gets ``t`` as a float32 scalar.

    ``y0`` may be any shape; the error norm is taken over all elements (the
    reference's flattened-state scipy usage). ``status`` is 1 if
    ``max_steps`` ran out before ``t1``: ``y`` is then the truncated state,
    and callers must check. ``nfe`` counts 2 for the first RHS and the
    initial-step probe and 6 per attempted step.
    """
    t0, t1 = np.float32(t0), np.float32(t1)
    direction = np.sign(t1 - t0)
    t, y = t0, y0
    f = func(t0, y0)
    h = _initial_step(func, t0, y0, f, direction, 4, rtol, atol)
    nfe, steps, done, rejected = 2, 0, False, False
    while not done and steps < max_steps:
        # clamp the step at t1; when the clamp engages this is the last step
        remainder = abs(t1 - t)
        h = min(h, remainder)
        is_last = h >= remainder
        h_signed = h * direction
        hs = float(h_signed)

        ks = [f]
        for i in range(1, 6):
            ks.append(func(t + np.float32(_C[i]) * h_signed, y + hs * _weighted(_A[i], ks)))
        y_new = y + hs * _weighted(_B, ks)
        t_new = t + h_signed
        f_new = func(t_new, y_new)  # FSAL stage 7
        ks.append(f_new)

        err = hs * _weighted(_E, ks)
        scale = atol + torch.maximum(y.abs(), y_new.abs()) * rtol
        err_norm = _rms_norm(err / scale)

        accept = bool(err_norm <= 1.0)
        if err_norm == 0.0:
            factor = _MAX_FACTOR
        else:
            factor = min(max(_SAFETY * err_norm ** _ERR_EXP, _MIN_FACTOR), _MAX_FACTOR)
        # scipy's step_rejected memory: the accept right after a rejection
        # may not grow h, which keeps accept/reject from oscillating
        if not accept or rejected:
            factor = min(factor, np.float32(1.0))
        h = h * factor
        if accept:
            # land exactly on t1: the float32 ``t + (t1 - t)`` need not equal
            # t1 bitwise, and the residue would cost micro-steps or never end
            t, y, f = (t1 if is_last else t_new), y_new, f_new
            done = is_last
        rejected = not accept
        nfe += 6
        steps += 1
    return ODEResult(y=y, nfe=nfe, status=0 if done else 1)
