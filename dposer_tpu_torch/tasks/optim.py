"""Adam for the fitting loops, with optax's arithmetic (``optax.adam``: the
moments ``(1-b)*g + b*m``, the bias corrections ``1 - b**t`` in float32,
``m_hat / (sqrt(v_hat) + eps)`` scaled by ``-lr`` and added), so that a loop
held to the JAX package's takes the same steps to float32 rounding."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


class Adam:
    """One state over a list of tensors, updated in place by ``step``."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        t = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * (g * g))
            p.add_(-self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)))
