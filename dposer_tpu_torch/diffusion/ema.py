"""Exponential moving average of the parameters (port of
``dposer_tpu/diffusion/ema.py``; ref lib/algorithms/ema.py:10-98).

The shadow is a list of tensors aligned with the model's trainable
parameters in ``model.parameters()`` order, which is
``utils/checkpoint.py::torch_parameter_order`` and the reference
checkpoint's ``ema.shadow_params``. The update is one ``torch._foreach_lerp_``
over all of them. The decay warms up as ``min(decay, (1 + n) / (10 + n))``,
computed in float32 as the JAX package computes it; ``num_updates < 0`` turns
the warm-up off (the reference's ``use_num_updates=False``, a ``None``
counter in its checkpoints).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class EMAState:
    shadow_params: List[torch.Tensor]
    num_updates: int  # < 0 means disabled (use_num_updates=False)
    decay: float = 0.9999


def ema_init(params, decay: float = 0.9999, use_num_updates: bool = True) -> EMAState:
    """A shadow copy of ``params`` (an iterable of tensors)."""
    if decay < 0.0 or decay > 1.0:
        raise ValueError("Decay must be between 0 and 1")
    return EMAState(shadow_params=[p.detach().clone() for p in params],
                    num_updates=0 if use_num_updates else -1, decay=decay)


def ema_decay(state: EMAState) -> tuple:
    """``(num_updates after this update, the decay it uses)``, in float32."""
    if state.num_updates < 0:
        return state.num_updates, float(np.float32(state.decay))
    num = state.num_updates + 1
    warm = np.float32(1.0 + num) / np.float32(10.0 + num)
    return num, float(min(np.float32(state.decay), warm))


@torch.no_grad()
def ema_update(state: EMAState, params) -> EMAState:
    """One EMA step in place: ``s <- s - (1 - decay) * (s - p)``."""
    num, decay = ema_decay(state)
    one_minus = float(np.float32(1.0) - np.float32(decay))
    torch._foreach_lerp_(state.shadow_params, [p.detach() for p in params], one_minus)
    state.num_updates = num
    return state
