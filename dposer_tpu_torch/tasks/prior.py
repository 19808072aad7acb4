"""The DPoser prior for the test-time optimisation tasks. Port of
``dposer_tpu/tasks/prior.py``.

One- and multi-step denoising through the score function, the DPoser loss
(perturb -> denoise -> weighted L2) and the discrete time-sampling
strategies (ref run/completion.py:95-207). Gradients do not flow through the
denoiser (the reference detaches x0_hat, ref completion.py:110): only through
the clean-pose argument of the L2.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..diffusion.sde import SDE, batch_mul


@torch.no_grad()
def one_step_denoise(sde: SDE, score_fn: Callable, x_t: torch.Tensor, t: torch.Tensor):
    """``x0_hat = (x_t + sigma^2 * score) / alpha`` and ``SNR = alpha /
    sqrt(sigma^2)`` (ref completion.py:105-110), both detached."""
    score = score_fn(x_t, t)
    alpha, sigma = sde.return_alpha_sigma(t)
    sigma2 = sigma ** 2
    x0_hat = (x_t + batch_mul(sigma2, score)) / alpha
    return x0_hat, alpha / torch.sqrt(sigma2)[..., None]


@torch.no_grad()
def multi_step_denoise(sde: SDE, score_fn: Callable, x_t: torch.Tensor,
                       t: torch.Tensor, t_end: torch.Tensor, N: int = 10):
    """DDIM-style multi-step denoise (ref completion.py:112-129)."""
    x_current = x_t
    for i in range(N):
        a0, a1 = i / N, (i + 1) / N
        t_cur = (1 - a0) * t + a0 * t_end
        t_bef = (1 - a1) * t + a1 * t_end
        alpha_c, sigma_c = sde.return_alpha_sigma(t_cur)
        alpha_b, sigma_b = sde.return_alpha_sigma(t_bef)
        noise_pred = -score_fn(x_current, t_cur) * sigma_c[:, None]
        x_current = (alpha_b / alpha_c * (x_current - sigma_c[:, None] * noise_pred)
                     + sigma_b[:, None] * noise_pred)
    alpha, sigma = sde.return_alpha_sigma(t)
    return x_current, alpha / sigma[..., None]


def sample_quan_t(step: int, total_steps: int, sde_N: int, time_strategy: str = "3",
                  sample_trun: float = 5.0, sample_time: int = 900, offset: int = 2,
                  generator: Optional[torch.Generator] = None) -> int:
    """The discrete time index of the prior loss at optimisation ``step``.

    Strategies (ref completion.py:185-192): '1' random (from ``generator``),
    '2' fixed ``sample_time``, '3' truncated annealing ``N - floor((total -
    step - 1) * (N / (trun * total))) - offset``, in float32 as the JAX
    package computes it (offset 2 for completion, 5 for SMPLify).
    """
    if time_strategy == "1":
        return int(torch.randint(0, sde_N, (), generator=generator,
                                 device=generator.device if generator is not None else "cpu"))
    if time_strategy == "2":
        if not 0 <= sample_time < sde_N:
            raise ValueError(f"sample_time={sample_time} outside the sde time "
                             f"grid [0, {sde_N})")
        return int(sample_time)
    if time_strategy == "3":
        rate = torch.tensor(sde_N / (sample_trun * total_steps), dtype=torch.float32)
        return sde_N - int(torch.floor((total_steps - step - 1) * rate)) - offset
    raise NotImplementedError("unsupported time sampling strategy")


class DPoserPrior:
    """The DPoser plug-in prior: perturb -> denoise -> weighted L2.

    ``score_fn`` closes over an eval-mode model; ``sde`` carries the task's
    step count N.
    """

    def __init__(self, sde: SDE, score_fn: Callable, eps: float = 1e-3, device=None):
        self.sde = sde
        self.score_fn = score_fn
        self.timesteps = sde.timesteps(eps, device=device)

    def _perturb(self, x0, vec_t, z, generator):
        if z is None:
            z = torch.randn(x0.shape, generator=generator, device=x0.device,
                            dtype=x0.dtype)
        mean, std = self.sde.marginal_prob(x0, vec_t)
        return mean + batch_mul(std, z), std, z

    def loss(self, x0: torch.Tensor, vec_t: torch.Tensor, weighted: bool = False,
             multi_denoise: bool = False, reduction: str = "mean",
             batch_size: Optional[int] = None, z: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The DPoser loss (ref completion.py:131-149). ``reduction='mean'``:
        torch's MSELoss-mean (completion); ``'sum_per_batch'``: sum over
        batch_size (motion denoising, SMPLify). ``z`` injects the
        perturbation normal. Differentiable in ``x0`` through the L2 only."""
        perturbed, _, _ = self._perturb(x0.detach(), vec_t, z, generator)
        if multi_denoise:
            denoised, snr = multi_step_denoise(self.sde, self.score_fn, perturbed,
                                               vec_t, t_end=vec_t / 20.0, N=10)
        else:
            denoised, snr = one_step_denoise(self.sde, self.score_fn, perturbed, vec_t)
        weight = 0.5 * torch.sqrt(1 + snr) if weighted else 0.5
        sq = weight * (x0 - denoised) ** 2
        if reduction == "mean":
            return sq.mean()
        return sq.sum() / (batch_size or x0.shape[0])

    def red_diff_loss(self, x0: torch.Tensor, vec_t: torch.Tensor,
                      z: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """RED-Diff guidance (ref motion_denoising.py:145-154): the inner
        product of the detached noise-prediction residual with x0, weighted by
        1/SNR. The reference keeps it unused."""
        perturbed, std, z = self._perturb(x0.detach(), vec_t, z, generator)
        with torch.no_grad():
            score = self.score_fn(perturbed, vec_t)
            alpha, sigma = self.sde.return_alpha_sigma(vec_t)
            inverse_snr = torch.sqrt(sigma ** 2) / alpha[:, 0]
            residual = -batch_mul(std, score) - z
        return (inverse_snr * (residual * x0).sum(dim=1)).mean()
