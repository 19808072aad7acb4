"""Model-output -> score adapter (ref lib/algorithms/advanced/utils.py:127-186).

- VP/subVP continuous: ``labels = t * 999``; ``std = marginal_prob(0, t)[1]``
  (for subVP the non-sqrt quantity); ``score = -model_out / std``.
- VP discrete: ``labels = t * (N - 1)``; ``std = sqrt_1m_alphas_cumprod[labels]``.
- VE continuous: ``labels = marginal_prob(0, t)[1]``; the output IS the score.
- VE discrete: ``labels = round((T - t) * (N - 1))``.
"""
from __future__ import annotations

from typing import Callable

import torch

from .sde import SDE, VESDE, VPSDE, SubVPSDE, batch_mul


def get_score_fn(sde: SDE, model_fn: Callable, continuous: bool = True) -> Callable:
    """Wrap ``model_fn(x, labels) -> out`` into ``score_fn(x, t) -> score``."""
    if isinstance(sde, (VPSDE, SubVPSDE)):

        def score_fn(x, t):
            if continuous or isinstance(sde, SubVPSDE):
                out = model_fn(x, t * 999)
                std = sde.marginal_prob(torch.zeros_like(x), t)[1]
            else:
                labels = t * (sde.N - 1)
                out = model_fn(x, labels)
                sqrt_1m = torch.sqrt(1.0 - torch.cumprod(sde.alphas(x.device), 0))
                std = sqrt_1m[labels.long()]
            return -batch_mul(1.0 / std, out)

        return score_fn

    if isinstance(sde, VESDE):

        def score_fn(x, t):
            if continuous:
                labels = sde.marginal_prob(torch.zeros_like(x), t)[1]
            else:
                labels = torch.round((sde.T - t) * (sde.N - 1))
            return model_fn(x, labels)

        return score_fn

    raise NotImplementedError(f"SDE class {type(sde).__name__} not yet supported.")
