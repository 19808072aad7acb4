"""The predictor-corrector sampler as a plain torch loop (ref sampling.py:429-466).

This is the port's semantic reference for the tabled sampler and the
kernels: per step, the corrector update, then the predictor update; with
``denoise`` the last predictor's ``x_mean`` is returned.

- Euler-Maruyama: ``dt = -1/N``, ``x_mean = x + drift*dt``,
  ``x = x_mean + diffusion*sqrt(-dt)*z`` (ref sampling.py:182-188)
- reverse diffusion: ``x_mean = x - f``, ``x = x_mean + G*z`` (ref :210-220)
- langevin: ``step = 2*alpha*(snr*|z|/|score|)^2`` with batch-mean row norms
  (ref :273-302)

Noise is drawn per step from ``generator`` in slab order corr_0..corr_{S-1},
predictor; ``noise=[N, K, B, D]`` injects the same slabs instead, the layout
the tabled sampler and the kernel sampler take.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from .sde import SDE, VPSDE, SubVPSDE, batch_mul


def euler_maruyama_predictor(sde: SDE, score_fn, probability_flow=False):
    rsde = sde.reverse_sde(score_fn, probability_flow)
    dt = -1.0 / sde.N
    sqrt_mdt = math.sqrt(1.0 / sde.N)

    def update(x, t, z):
        drift, diffusion = rsde(x, t)
        x_mean = x + drift * dt
        return x_mean + batch_mul(diffusion * sqrt_mdt, z), x_mean

    return update


def reverse_diffusion_predictor(sde: SDE, score_fn, probability_flow=False):
    rdisc = sde.reverse_discretize(score_fn, probability_flow)

    def update(x, t, z):
        f, G = rdisc(x, t)
        x_mean = x - f
        return x_mean + batch_mul(G, z), x_mean

    return update


_PREDICTORS = {"euler_maruyama": euler_maruyama_predictor,
               "reverse_diffusion": reverse_diffusion_predictor}


def _corrector_alpha(sde: SDE, t):
    if isinstance(sde, (VPSDE, SubVPSDE)):
        return sde.alphas(t.device)[(t * (sde.N - 1) / sde.T).long()]
    return torch.ones_like(t)


def langevin_corrector_step(sde: SDE, score_fn, snr: float):
    """One langevin step ``update(x, t, z) -> (x, x_mean)``."""

    def update(x, t, z):
        alpha = _corrector_alpha(sde, t)
        grad = score_fn(x, t)
        grad_norm = torch.linalg.norm(grad.reshape(grad.shape[0], -1), dim=-1).mean()
        noise_norm = torch.linalg.norm(z.reshape(z.shape[0], -1), dim=-1).mean()
        step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * alpha
        x_mean = x + batch_mul(step_size, grad)
        return x_mean + batch_mul(torch.sqrt(step_size * 2), z), x_mean

    return update


def get_pc_sampler(sde: SDE, shape: Tuple[int, ...], score_fn: Callable,
                   predictor: str = "euler_maruyama", corrector: str = "none",
                   snr: float = 0.16, n_steps: int = 1,
                   probability_flow: bool = False, denoise: bool = True,
                   eps: float = 1e-3, device="cuda"):
    """``sampler(generator=None, z=None, noise=None) -> x``.

    ``z`` replaces the prior draw; ``noise`` [N, K, B, D] (K = corrector
    steps + 1) replaces the per-step draws.
    """
    if corrector not in ("none", "langevin"):
        raise NotImplementedError(f"corrector {corrector!r}")
    predictor_update = _PREDICTORS[predictor.lower()](sde, score_fn, probability_flow)
    corrector_update = langevin_corrector_step(sde, score_fn, snr)
    n_corr = n_steps if corrector == "langevin" else 0
    timesteps = sde.timesteps(eps, device=device)

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, z=None, noise=None):
        x = sde.prior_sampling(shape, generator, device) if z is None else z
        x_mean = x
        for i in range(sde.N):
            t = timesteps[i]
            zs = (noise[i] if noise is not None else
                  torch.randn((n_corr + 1,) + tuple(shape), generator=generator,
                              device=device))
            for j in range(n_corr):
                x, x_mean = corrector_update(x, t, zs[j])
            x, x_mean = predictor_update(x, t, zs[n_corr])
        return x_mean if denoise else x

    return sampler
