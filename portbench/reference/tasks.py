"""The reference's tasks on ``scorefc``: the int8 calibration trajectory, one
reverse sampling step, and the completion solve.

Written from the published algorithms (DPoser's ``run/completion.py`` and
``lib/algorithms/completion.py``; score_sde's Euler-Maruyama predictor), in
float32 with float64 scalars. Plain PyTorch: nothing of the program.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from .scorefc import ScoreFC, SubVP

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@torch.no_grad()
def calibrate_per_channel(net: ScoreFC, sde: SubVP, eps: float, z: torch.Tensor,
                          noise: torch.Tensor, margin: float = 1.1) -> List[np.ndarray]:
    """The int8 configuration's activation ranges: the running max |input|
    of every matmul, per channel, along a float32 Euler-Maruyama trajectory
    from ``z`` [B, D] with ``noise`` [N, B, D], times ``margin``; a channel that
    never lights up takes its vector's max. As the configuration states it,
    that trajectory applies the sigma output scale twice (once in the
    network, once in the update)."""
    grid = sde.grid(eps).tolist()
    x, amax = z.float(), None
    for i, t in enumerate(grid):
        labels = torch.full((1,), t * 999.0, dtype=torch.float32, device=x.device)
        probe: list = []
        out = net.raw(x, labels, probe) * net.out_scale(labels)
        seen = [p.abs().amax(0) for p in probe]
        amax = seen if amax is None else [torch.maximum(a, b) for a, b in zip(amax, seen)]
        x = sde.em_step(out, x, t, noise[i], out_scale_twice=float(net.out_scale(labels)))[0]
    res = [a.double().cpu().numpy() * margin for a in amax]
    return [np.where(a > 0, a, a.max()).astype(np.float32) for a in res]


@torch.no_grad()
def em_step(net: ScoreFC, sde: SubVP, grid: torch.Tensor, i: int, x: torch.Tensor,
            z: torch.Tensor):
    """Reverse step ``i`` from ``x``: ``(x_new, x_mean, model_term)``."""
    t = float(grid[i])
    labels = torch.full((1,), t * 999.0, dtype=torch.float32, device=x.device)
    return sde.em_step(net.forward(x, labels), x, t, z)


def annealed_index(step: int, total: int, n: int, trun: float, offset: int) -> int:
    """Time strategy '3', truncated annealing: ``N - floor((total - step - 1) *
    N / (trun * total)) - offset``, the rate in float32."""
    rate = float(np.float32(n / (trun * total)))
    return n - int(np.floor(np.float32((total - step - 1) * rate))) - offset


@torch.no_grad()
def complete(net: ScoreFC, sde: SubVP, grid: torch.Tensor, obs: torch.Tensor,
             mask: torch.Tensor, n_elems: int, normals: Callable[[int], torch.Tensor],
             traffic: dict) -> torch.Tensor:
    """DPoser completion by Adam on ``obs``/``mask`` [R, D] (``mask`` 1 where
    observed), hypotheses as rows, every loss a mean over ``n_elems``:
    ``100 / (1 + it) * data + 0.1 * (it + 1) * dposer`` with the
    SNR-weighted one-step-denoise loss at the annealed time, ``normals(i)``
    the perturbation's normals of step ``i``; the observed dims pasted at the
    end."""
    iters, spi = int(traffic["iterations"]), int(traffic["steps_per_iter"])
    total, lr = iters * spi, float(traffic["lr"])
    x = obs.clone()
    m1, v = torch.zeros_like(x), torch.zeros_like(x)
    for i in range(total):
        it = i // spi
        t = float(grid[annealed_index(i, total, sde.N, float(traffic["sample_trun"]), 2)])
        mc, std = sde.mean_coef(t), sde.std(t)
        pert = mc * x + std * normals(i)
        labels = torch.full((1,), t * 999.0, dtype=torch.float32, device=x.device)
        score = -net.forward(pert, labels) / std
        alpha, sigma2 = mc, std * std
        x0_hat = (pert + sigma2 * score) / alpha
        snr = alpha / sigma2 ** 0.5
        g = (2.0 * 100.0 / (1.0 + it) / n_elems) * mask * (x - obs) \
            + (0.1 * (it + 1.0) * (1.0 + snr) ** 0.5 / n_elems) * (x - x0_hat)
        m1 = ADAM_B1 * m1 + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * v + (1.0 - ADAM_B2) * g * g
        bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(i + 1))
        bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(i + 1))
        x = x - lr * (m1 / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
    return obs * mask + x * (1.0 - mask)
