"""Continuous-time SDEs (VP / sub-VP / VE) on torch tensors.

Same numerics as the reference (ref lib/algorithms/advanced/sde_lib.py):

- sub-VP ``marginal_prob`` "std" is ``1 - exp(2*lmc)``, NOT square-rooted
  (ref sde_lib.py:216); VP uses ``sqrt(1 - exp(2*lmc))`` (ref :155).
- reverse drift: ``drift - diffusion**2 * score * (0.5 if probability_flow
  else 1.0)`` (ref sde_lib.py:98-109); the discretized reverse keeps the full
  score factor in probability-flow mode (ref :114-115).

Grids are built with ``jnp.linspace``'s float32 formula
(``start*(1-s) + stop*s``, last point exact). XLA may contract and reorder
that arithmetic, so grid points can differ from the JAX package's by a few
float32 ulps; the integer casts of the grid (``t*(N-1)`` table indices,
``t*999`` labels) agree on the grids the samplers use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

Tensor = torch.Tensor


def linspace_f32(start: float, stop: float, num: int, device=None) -> Tensor:
    """float32 ``linspace`` with ``jnp.linspace``'s arithmetic."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t[None]])


def batch_mul(a: Tensor, x: Tensor) -> Tensor:
    """Multiply a per-sample scalar ``a`` ([...]) against ``x`` ([..., D])."""
    return a[..., None] * x if a.ndim == x.ndim - 1 else a * x


@dataclasses.dataclass(frozen=True)
class SDE:
    """Base SDE: dx = f(x, t) dt + g(t) dw on t in [0, T]."""

    N: int = 1000
    T: float = 1.0

    def sde(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def marginal_prob(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def prior_sampling(self, shape, generator: torch.Generator | None = None,
                       device=None) -> Tensor:
        raise NotImplementedError

    def prior_logp(self, z: Tensor) -> Tensor:
        raise NotImplementedError

    def return_alpha_sigma(self, t: Tensor) -> Tuple[Tensor, Tensor]:
        """``(alpha [..., 1], sigma [...])`` of the marginal
        ``x_t = alpha*x_0 + sigma*eps`` (sub-VP: its non-sqrt "std")."""
        raise NotImplementedError

    def discretize(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
        """Euler-Maruyama discretization x_{i+1} = x_i + f_i + G_i z_i."""
        dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)

    def timesteps(self, eps: float, device=None) -> Tensor:
        """The sampler time grid linspace(T, eps, N) (ref sampling.py:449)."""
        return linspace_f32(self.T, eps, self.N, device=device)

    def reverse_sde(self, score_fn: Callable, probability_flow: bool = False):
        """``rsde(x, t) -> (drift, diffusion)`` of the reverse-time SDE/ODE."""

        def rsde(x, t):
            drift, diffusion = self.sde(x, t)
            score = score_fn(x, t)
            drift = drift - batch_mul(diffusion ** 2, score) * (0.5 if probability_flow else 1.0)
            diffusion = torch.zeros_like(diffusion) if probability_flow else diffusion
            return drift, diffusion

        return rsde

    def reverse_sde_guided(self, score_fn: Callable):
        """``rsde(x, t) -> (drift, diffusion, alpha, sigma^2, score)``: the
        reverse SDE with what guidance and one-step denoising need (ref
        sde_lib.py:98-109 with guide=True)."""

        def rsde(x, t):
            drift, diffusion = self.sde(x, t)
            score = score_fn(x, t)
            drift = drift - batch_mul(diffusion ** 2, score)
            alpha, sigma = self.return_alpha_sigma(t)
            return drift, diffusion, alpha, sigma ** 2, score

        return rsde

    def reverse_discretize(self, score_fn: Callable, probability_flow: bool = False):
        """Discretized reverse iteration (ref sde_lib.py:111-117)."""

        def rdisc(x, t):
            f, G = self.discretize(x, t)
            rev_f = f - batch_mul(G ** 2, score_fn(x, t))
            rev_G = torch.zeros_like(G) if probability_flow else G
            return rev_f, rev_G

        return rdisc

    def _index(self, t: Tensor) -> Tensor:
        return (t * (self.N - 1) / self.T).long()


def _prior_device(generator, device):
    if device is not None:
        return device
    return generator.device if generator is not None else "cpu"


def _gaussian_prior_logp(z: Tensor, var: float = 1.0) -> Tensor:
    n = z.shape[-1]
    return (-n / 2.0 * math.log(2 * math.pi * var)
            - torch.sum(z ** 2, dim=-1) / (2.0 * var))


@dataclasses.dataclass(frozen=True)
class VPSDE(SDE):
    """Variance-preserving SDE (ref sde_lib.py:122-181)."""

    beta_0: float = 0.1
    beta_1: float = 20.0

    def discrete_betas(self, device=None) -> Tensor:
        return linspace_f32(self.beta_0 / self.N, self.beta_1 / self.N, self.N,
                            device=device)

    def alphas(self, device=None) -> Tensor:
        return 1.0 - self.discrete_betas(device)

    def sde(self, x, t):
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        return batch_mul(-0.5 * beta_t, x), torch.sqrt(beta_t)

    def _log_mean_coeff(self, t):
        return -0.25 * t ** 2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def marginal_prob(self, x, t):
        lmc = self._log_mean_coeff(t)
        return batch_mul(torch.exp(lmc), x), torch.sqrt(1.0 - torch.exp(2.0 * lmc))

    def return_alpha_sigma(self, t):
        lmc = self._log_mean_coeff(t)
        return torch.exp(lmc)[..., None], torch.sqrt(1.0 - torch.exp(2.0 * lmc))

    def prior_sampling(self, shape, generator=None, device=None):
        return torch.randn(shape, generator=generator,
                           device=_prior_device(generator, device))

    def prior_logp(self, z):
        return _gaussian_prior_logp(z)

    def discretize(self, x, t):
        """DDPM discretization (ref sde_lib.py:167-175)."""
        idx = self._index(t)
        beta = self.discrete_betas(t.device)[idx]
        alpha = self.alphas(t.device)[idx]
        return batch_mul(torch.sqrt(alpha), x) - x, torch.sqrt(beta)


@dataclasses.dataclass(frozen=True)
class SubVPSDE(SDE):
    """sub-VP SDE (ref sde_lib.py:184-231). NOTE the non-sqrt "std"."""

    beta_0: float = 0.1
    beta_1: float = 20.0

    def discrete_betas(self, device=None) -> Tensor:
        return linspace_f32(self.beta_0 / self.N, self.beta_1 / self.N, self.N,
                            device=device)

    def alphas(self, device=None) -> Tensor:
        return 1.0 - self.discrete_betas(device)

    def sde(self, x, t):
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        discount = 1.0 - torch.exp(-2 * self.beta_0 * t
                                   - (self.beta_1 - self.beta_0) * t ** 2)
        return batch_mul(-0.5 * beta_t, x), torch.sqrt(beta_t * discount)

    def _log_mean_coeff(self, t):
        return -0.25 * t ** 2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def marginal_prob(self, x, t):
        lmc = self._log_mean_coeff(t)
        return batch_mul(torch.exp(lmc), x), 1.0 - torch.exp(2.0 * lmc)

    def return_alpha_sigma(self, t):
        lmc = self._log_mean_coeff(t)
        return torch.exp(lmc)[..., None], 1.0 - torch.exp(2.0 * lmc)

    def prior_sampling(self, shape, generator=None, device=None):
        return torch.randn(shape, generator=generator,
                           device=_prior_device(generator, device))

    def prior_logp(self, z):
        return _gaussian_prior_logp(z)


@dataclasses.dataclass(frozen=True)
class VESDE(SDE):
    """Variance-exploding SDE (ref sde_lib.py:234-292)."""

    sigma_min: float = 0.01
    sigma_max: float = 50.0

    def discrete_sigmas(self, device=None) -> Tensor:
        return torch.exp(linspace_f32(math.log(self.sigma_min),
                                      math.log(self.sigma_max), self.N,
                                      device=device))

    def sde(self, x, t):
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        diffusion = sigma * math.sqrt(2 * (math.log(self.sigma_max)
                                           - math.log(self.sigma_min)))
        return torch.zeros_like(x), diffusion

    def marginal_prob(self, x, t):
        return x, self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def return_alpha_sigma(self, t):
        return (torch.ones(t.shape + (1,), dtype=t.dtype, device=t.device),
                self.sigma_min * (self.sigma_max / self.sigma_min) ** t)

    def prior_sampling(self, shape, generator=None, device=None):
        return torch.randn(shape, generator=generator,
                           device=_prior_device(generator, device)) * self.sigma_max

    def prior_logp(self, z):
        return _gaussian_prior_logp(z, self.sigma_max ** 2)

    def discretize(self, x, t):
        """SMLD (NCSN) discretization (ref sde_lib.py:279-287)."""
        idx = self._index(t)
        sigmas = self.discrete_sigmas(t.device)
        sigma = sigmas[idx]
        adjacent = torch.where(idx == 0, torch.zeros_like(t),
                               sigmas[torch.clamp(idx - 1, min=0)])
        return torch.zeros_like(x), torch.sqrt(sigma ** 2 - adjacent ** 2)


def build_sde(config, N: int | None = None) -> SDE:
    """The SDE named by ``config.training.sde`` (ref train.py:196-212)."""
    name = config.training.sde.lower()
    n = N if N is not None else config.model.num_scales
    if name == "vpsde":
        return VPSDE(beta_0=config.model.beta_min, beta_1=config.model.beta_max, N=n)
    if name == "subvpsde":
        return SubVPSDE(beta_0=config.model.beta_min, beta_1=config.model.beta_max, N=n)
    if name == "vesde":
        return VESDE(sigma_min=config.model.sigma_min,
                     sigma_max=config.model.sigma_max, N=n)
    raise NotImplementedError(f"SDE {config.training.sde} unknown.")


def sampling_eps_for(sde: SDE) -> float:
    """Default integration cutoff (ref train.py:200-212)."""
    return 1e-5 if isinstance(sde, VESDE) else 1e-3
