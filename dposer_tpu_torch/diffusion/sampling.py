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
imput_c, predictor, imput_p (the imputation slabs only with
``imputation=True``, ref sampling.py:410-427); ``noise=[N, K, B, D]`` injects
the same slabs instead, the layout the tabled sampler and the kernel sampler
take.

``get_ode_sampler`` integrates the probability-flow ODE with the adaptive
RK45 of ``ode.py`` (ref sampling.py:471-542), and ``get_sampling_fn``
dispatches on the config as the reference does (ref sampling.py:80-124).
The guided Euler-Maruyama update is not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from . import ode as ode_lib
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
                   eps: float = 1e-3, imputation: bool = False, device="cuda"):
    """``sampler(generator=None, observation=None, mask=None, z=None,
    noise=None) -> x``.

    ``z`` replaces the prior draw; ``noise`` [N, K, B, D] (K = corrector
    steps + 1, plus 2 with imputation) replaces the per-step draws.
    ``observation`` and ``mask`` are read only with ``imputation=True``:
    after the corrector and after the predictor the observed dims are
    overwritten with the observation re-noised to the step's time.
    """
    if corrector not in ("none", "langevin"):
        raise NotImplementedError(f"corrector {corrector!r}")
    predictor_update = _PREDICTORS[predictor.lower()](sde, score_fn, probability_flow)
    corrector_update = langevin_corrector_step(sde, score_fn, snr)
    n_corr = n_steps if corrector == "langevin" else 0
    K = n_corr + (2 if imputation else 0) + 1
    timesteps = sde.timesteps(eps, device=device)

    def impute(x, t, z, observation, mask):
        masked_mean, std = sde.marginal_prob(observation, t)
        return x * (1 - mask) + (masked_mean + std * z) * mask

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, observation=None,
                mask=None, z=None, noise=None):
        x = sde.prior_sampling(shape, generator, device) if z is None else z
        x_mean = x
        for i in range(sde.N):
            t = timesteps[i]
            zs = (noise[i] if noise is not None else
                  torch.randn((K,) + tuple(shape), generator=generator,
                              device=device))
            for j in range(n_corr):
                x, x_mean = corrector_update(x, t, zs[j])
            k = n_corr
            if imputation:
                x = impute(x, t, zs[k], observation, mask)
                k += 1
            x, x_mean = predictor_update(x, t, zs[k])
            if imputation:
                x = impute(x, t, zs[k + 1], observation, mask)
        return x_mean if denoise else x

    return sampler


def get_ode_sampler(sde: SDE, shape: Tuple[int, ...], score_fn: Callable,
                    denoise: bool = False, rtol: float = 1e-5, atol: float = 1e-5,
                    eps: float = 1e-3, device="cuda"):
    """Deterministic probability-flow-ODE sampler on the adaptive RK45.

    ``sampler(generator=None, z=None) -> (nfe, x)``. A run that exhausts the
    solver's step budget returns NaNs rather than the truncated state;
    ``denoise`` adds one reverse-diffusion predictor step without noise at
    ``eps`` (ref sampling.py:492-498).
    """
    pf_rsde = sde.reverse_sde(score_fn, probability_flow=True)
    rdisc = sde.reverse_discretize(score_fn, probability_flow=False)

    def drift_fn(t, x):
        return pf_rsde(x, torch.full((x.shape[0],), float(t), dtype=x.dtype,
                                     device=x.device))[0]

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, z=None):
        x = sde.prior_sampling(shape, generator, device) if z is None else z
        sol = ode_lib.rk45(drift_fn, sde.T, eps, x, rtol=rtol, atol=atol)
        x = sol.y if sol.status == 0 else torch.full_like(sol.y, float("nan"))
        if denoise:
            f, _ = rdisc(x, torch.full((x.shape[0],), eps, dtype=x.dtype, device=x.device))
            x = x - f
        return sol.nfe, x

    return sampler


def get_sampling_fn(config, sde: SDE, shape, score_fn, eps, **overrides):
    """The config's sampler (ref sampling.py:80-124): ``method`` "ode" gives
    ``get_ode_sampler``'s ``(nfe, x)`` sampler, "pc" ``get_pc_sampler``'s."""
    method = config.sampling.method.lower()
    if method == "ode":
        return get_ode_sampler(sde, shape, score_fn,
                               denoise=config.sampling.noise_removal, eps=eps, **overrides)
    if method == "pc":
        return get_pc_sampler(sde, shape, score_fn, predictor=config.sampling.predictor,
                              corrector=config.sampling.corrector, snr=config.sampling.snr,
                              n_steps=config.sampling.n_steps_each,
                              probability_flow=config.sampling.probability_flow,
                              denoise=config.sampling.noise_removal, eps=eps, **overrides)
    raise ValueError(f"Sampler name {config.sampling.method} unknown.")
