"""The predictor-corrector sampler as a plain torch loop (ref sampling.py:429-466).

This is the port's semantic reference for the tabled sampler and the
kernels: per step, the corrector update, then the predictor update; with
``denoise`` the last predictor's ``x_mean`` is returned.

The registry maps names to builders, as the JAX package's does
(``register_predictor``, ``get_predictor``; ref sampling.py:39-59):

- predictors ``(sde, score_fn, probability_flow) -> update(x, t, z) -> (x,
  x_mean)``: ``euler_maruyama`` (``dt = -1/N``, ``x_mean = x + drift*dt``,
  ``x = x_mean + diffusion*sqrt(-dt)*z``; ref :182-188), ``reverse_diffusion``
  (``x_mean = x - f``, ``x = x_mean + G*z``; ref :210-220),
  ``ancestral_sampling`` (VP and VE; ref :223-259) and ``none``;
- correctors ``(sde, score_fn, snr, n_steps) -> update(x, t, zs) -> (x,
  x_mean)``, ``zs`` one normal slab a corrector step: ``langevin``
  (``step = 2*alpha*(snr*|z|/|score|)^2`` with batch-mean row norms; ref
  :273-302), ``ald`` (annealed Langevin, ``step = 2*alpha*(snr*std)^2``
  with the marginal's std; ref :305-339) and ``none``.

The table index ``t*(N-1)/T`` is cast from float32, as JAX casts it. A
scalar ``t`` (the samplers' shared step time) scales the state directly, a
per-row ``t`` [B] row by row, in the JAX package's order of operations.

Noise is drawn per step from ``generator`` in slab order corr_0..corr_{S-1},
imput_c, predictor, imput_p (S corrector steps, none for the ``none``
corrector; the imputation slabs only with ``imputation=True``, ref
sampling.py:410-427); ``noise=[steps, K, B, D]`` injects the same slabs
instead, the layout the tabled sampler and the kernel sampler take.

``get_ode_sampler`` integrates the probability-flow ODE with the adaptive
RK45 of ``ode.py`` (ref sampling.py:471-542), ``get_sampling_fn``
dispatches on the config as the reference does (ref sampling.py:80-124), and
``get_guided_em_update`` is the guided Euler-Maruyama step (ref :191-207).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from . import ode as ode_lib
from .sde import SDE, VESDE, VPSDE, SubVPSDE, batch_mul

_PREDICTORS = {}
_CORRECTORS = {}


def register_predictor(name):
    def _register(fn):
        _PREDICTORS[name] = fn
        return fn

    return _register


def register_corrector(name):
    def _register(fn):
        _CORRECTORS[name] = fn
        return fn

    return _register


def get_predictor(name):
    return _PREDICTORS[name.lower()]


def get_corrector(name):
    return _CORRECTORS[name.lower()]


def _scale(a, x):
    """``a * x`` for a scalar time's coefficient, ``batch_mul`` for a
    per-row one, as the JAX package branches on ``jnp.ndim(t)``."""
    return a * x if a.ndim == 0 else batch_mul(a, x)


def _table_index(sde: SDE, t):
    return (t * (sde.N - 1) / sde.T).long()


@register_predictor("euler_maruyama")
def euler_maruyama_predictor(sde: SDE, score_fn, probability_flow=False):
    rsde = sde.reverse_sde(score_fn, probability_flow)
    dt = -1.0 / sde.N
    sqrt_mdt = math.sqrt(1.0 / sde.N)

    def update(x, t, z):
        drift, diffusion = rsde(x, t)
        x_mean = x + drift * dt
        return x_mean + _scale(diffusion * sqrt_mdt, z), x_mean

    return update


@register_predictor("reverse_diffusion")
def reverse_diffusion_predictor(sde: SDE, score_fn, probability_flow=False):
    rdisc = sde.reverse_discretize(score_fn, probability_flow)

    def update(x, t, z):
        f, G = rdisc(x, t)
        x_mean = x - f
        return x_mean + _scale(G, z), x_mean

    return update


@register_predictor("ancestral_sampling")
def ancestral_sampling_predictor(sde: SDE, score_fn, probability_flow=False):
    """Ancestral sampling on the SDE's discrete ladder; VP and VE only (ref
    sampling.py:223-259)."""
    if probability_flow:
        raise AssertionError("Probability flow not supported by ancestral sampling")

    if isinstance(sde, VESDE):
        def update(x, t, z):
            timestep = _table_index(sde, t)
            sigmas = sde.discrete_sigmas(x.device)
            sigma = sigmas[timestep]
            adjacent = torch.where(timestep == 0, torch.zeros_like(t),
                                   sigmas[torch.clamp(timestep - 1, min=0)])
            score = score_fn(x, t)
            x_mean = (x + batch_mul(sigma ** 2 - adjacent ** 2, score) if t.ndim
                      else x + score * (sigma ** 2 - adjacent ** 2))
            std = torch.sqrt((adjacent ** 2 * (sigma ** 2 - adjacent ** 2)) / (sigma ** 2))
            return x_mean + _scale(std, z), x_mean

        return update

    if isinstance(sde, VPSDE):
        def update(x, t, z):
            beta = sde.discrete_betas(x.device)[_table_index(sde, t)]
            score = score_fn(x, t)
            num = x + _scale(beta, score)
            x_mean = (batch_mul(1.0 / torch.sqrt(1.0 - beta), num) if t.ndim
                      else num / torch.sqrt(1.0 - beta))
            return x_mean + _scale(torch.sqrt(beta), z), x_mean

        return update

    raise NotImplementedError(f"SDE class {type(sde).__name__} not yet supported.")


@register_predictor("none")
def none_predictor(sde, score_fn, probability_flow=False):
    def update(x, t, z):
        return x, x

    return update


def _corrector_alpha(sde: SDE, t):
    if isinstance(sde, (VPSDE, SubVPSDE)):
        return sde.alphas(t.device)[_table_index(sde, t)]
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


def _repeat(step):
    """A corrector of ``step`` applied once a slab of ``zs``."""
    def update(x, t, zs):
        x_mean = x
        for z in zs:
            x, x_mean = step(x, t, z)
        return x, x_mean

    return update


@register_corrector("langevin")
def langevin_corrector(sde: SDE, score_fn, snr, n_steps):
    return _repeat(langevin_corrector_step(sde, score_fn, snr))


@register_corrector("ald")
def ald_corrector(sde: SDE, score_fn, snr, n_steps):
    """Annealed Langevin dynamics (NCSN/v2; ref sampling.py:305-339): the
    step size from the marginal's std at ``t``."""

    def step(x, t, z):
        alpha = _corrector_alpha(sde, t)
        std = sde.marginal_prob(x, t)[1]
        grad = score_fn(x, t)
        step_size = (snr * std) ** 2 * 2 * alpha
        x_mean = x + _scale(step_size, grad)
        return (x_mean + batch_mul(torch.sqrt(step_size * 2), z) if t.ndim
                else x_mean + z * torch.sqrt(step_size * 2)), x_mean

    return _repeat(step)


@register_corrector("none")
def none_corrector(sde, score_fn, snr, n_steps):
    def update(x, t, zs):
        return x, x

    return update


def get_pc_sampler(sde: SDE, shape: Tuple[int, ...], score_fn: Callable,
                   predictor: str = "euler_maruyama", corrector: str = "none",
                   snr: float = 0.16, n_steps: int = 1,
                   probability_flow: bool = False, denoise: bool = True,
                   eps: float = 1e-3, imputation: bool = False, start_step: int = 0,
                   return_trajectory: bool = False, device="cuda"):
    """``sampler(generator=None, observation=None, mask=None, z=None,
    noise=None) -> x``, or ``(trajs, x)`` with ``return_trajectory``.

    The loop runs grid steps ``start_step..N-1``. ``z`` replaces the prior
    draw; ``noise`` [N - start_step, K, B, D] (K = corrector steps + 1, plus
    2 with imputation) replaces the per-step draws. ``observation`` and
    ``mask`` are read only with ``imputation=True``: after the corrector and
    after the predictor the observed dims are overwritten with the
    observation re-noised to the step's time. ``trajs`` [N - start_step, B,
    D] holds ``x`` after every step (not ``x_mean``; ref sampling.py:459-461).
    """
    predictor_update = get_predictor(predictor)(sde, score_fn, probability_flow)
    corrector_update = get_corrector(corrector)(sde, score_fn, snr, n_steps)
    n_corr = 0 if corrector.lower() == "none" else n_steps
    K = n_corr + (2 if imputation else 0) + 1
    timesteps = sde.timesteps(eps, device=device)
    if not 0 <= start_step <= sde.N:
        raise ValueError(f"start_step {start_step} outside [0, {sde.N}]")

    def impute(x, t, z, observation, mask):
        masked_mean, std = sde.marginal_prob(observation, t)
        return x * (1 - mask) + (masked_mean + std * z) * mask

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, observation=None,
                mask=None, z=None, noise=None):
        x = sde.prior_sampling(shape, generator, device) if z is None else z
        x_mean = x
        trajs = []
        for i in range(start_step, sde.N):
            t = timesteps[i]
            zs = (noise[i - start_step] if noise is not None else
                  torch.randn((K,) + tuple(shape), generator=generator,
                              device=device))
            x, x_mean = corrector_update(x, t, zs[:n_corr])
            k = n_corr
            if imputation:
                x = impute(x, t, zs[k], observation, mask)
                k += 1
            x, x_mean = predictor_update(x, t, zs[k])
            if imputation:
                x = impute(x, t, zs[k + 1], observation, mask)
            if return_trajectory:
                trajs.append(x)
        out = x_mean if denoise else x
        if not return_trajectory:
            return out
        return (torch.stack(trajs) if trajs else x.new_zeros((0,) + tuple(x.shape))), out

    return sampler


def get_guided_em_update(sde: SDE, score_fn, grad_step: float = 1.0):
    """One guided Euler-Maruyama update (MCG/DPS-style; ref sampling.py:191-207):
    ``update(x_t, t, observation, mask, z) -> (y_hat, y_mean)`` takes the EM
    step on the normal ``z`` [B, D], then descends the gradient with respect
    to ``x_t`` of ``||observation*mask - x0_hat*mask||``, ``x0_hat`` the
    one-step denoised estimate through the score."""
    rsde_guided = sde.reverse_sde_guided(score_fn)
    dt = -1.0 / sde.N
    sqrt_mdt = math.sqrt(1.0 / sde.N)

    def update(x_t, t, observation, mask, z):
        with torch.enable_grad():
            xt = x_t.detach().requires_grad_(True)
            drift, diffusion, alpha, sigma2, score = rsde_guided(xt, t)
            x0_hat = (xt + batch_mul(torch.atleast_1d(sigma2), score) if sigma2.ndim
                      else xt + sigma2 * score) / alpha
            norm = torch.linalg.norm(observation * mask - x0_hat * mask)
            norm_grad, = torch.autograd.grad(norm, xt)
        y_mean = x_t + drift.detach() * dt
        diffusion = diffusion.detach()
        y_hat = y_mean + (batch_mul(diffusion, z) * sqrt_mdt if t.ndim
                          else diffusion * sqrt_mdt * z)
        return y_hat - grad_step * norm_grad, y_mean

    return update


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
