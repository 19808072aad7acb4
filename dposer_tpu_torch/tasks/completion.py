"""Pose completion by test-time optimisation (DPoserComp). Port of
``dposer_tpu/tasks/completion.py`` (ref run/completion.py:95-207).

Poses are optimised against the DPoser one-step-denoise loss plus a masked
data term for ``iterations x steps_per_iter`` Adam steps:

- loss weights per iteration: data ``100/(1+it)``, dposer ``0.1*(it+1)`` with
  ``it = step // steps_per_iter`` (ref :151-155);
- time strategy '3': truncated annealing with offset 2 (ref :189-191);
- the reference passes ``quan_t`` as the loss's ``weighted`` flag (ref :196),
  a non-zero tensor, so the SNR-weighted branch is always taken;
- Adam with b1 0.9, b2 0.999, eps 1e-8 and bias corrections applied as optax
  applies them (``m/(1-b1^t)``, ``sqrt(v/(1-b2^t)) + eps``);
- the observed dims are pasted at the end: ``obs*mask + x*(1-mask)`` (ref :205).

``backend="torch"`` is the loop in autograd: the gradient flows through the
clean-pose argument of the losses only, the denoised estimate is detached.
``backend="cuda"`` is the whole loop on the CUDA kernels
(``ops/cuda/fused_comp.py``): forward-only per step, since nothing is
differentiated through the network. Hypotheses there are extra rows.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..diffusion.score_fn import get_score_fn
from ..diffusion.sde import SDE
from .prior import DPoserPrior, sample_quan_t

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class DPoserComp:
    """Completion solver: observation + mask -> completed poses."""

    def __init__(self, sde: SDE, score_fn: Optional[Callable] = None,
                 continuous: bool = True, lr: float = 0.1, iterations: int = 2,
                 steps_per_iter: int = 100, time_strategy: str = "3",
                 sample_trun: float = 5.0, sample_time: int = 900,
                 backend: str = "torch", model=None, device="cuda"):
        if backend not in ("torch", "cuda"):
            raise ValueError(f"backend must be 'torch' or 'cuda', got {backend!r}")
        if backend == "cuda" and model is None:
            raise ValueError("backend='cuda' needs model=")
        if score_fn is None:
            if model is None:
                raise ValueError("pass score_fn= or model=")
            score_fn = get_score_fn(sde, model, continuous=continuous)
        self.sde = sde
        self.device = torch.device(device)
        self.prior = DPoserPrior(sde, score_fn, device=self.device)
        self.lr = lr
        self.iterations = iterations
        self.steps_per_iter = steps_per_iter
        self.total_steps = iterations * steps_per_iter
        self.time_strategy = time_strategy
        self.sample_trun = sample_trun
        self.sample_time = sample_time
        self.backend = backend
        self.continuous = continuous
        self._model = model
        self._solvers = {}

    def _loss(self, x, t, observation, mask, z, generator):
        vec_t = torch.full((x.shape[0],), float(t), dtype=x.dtype, device=x.device)
        dposer = self.prior.loss(x, vec_t, weighted=True, reduction="mean", z=z,
                                 generator=generator)
        data = ((x * mask - observation * mask) ** 2).mean()
        return dposer, data

    def _optimize_torch(self, observation, mask, noise, generator):
        x = observation.clone().requires_grad_(True)
        m, v = torch.zeros_like(observation), torch.zeros_like(observation)
        for i in range(self.total_steps):
            it = i // self.steps_per_iter
            quan_t = sample_quan_t(i, self.total_steps, self.sde.N, self.time_strategy,
                                   self.sample_trun, self.sample_time, offset=2,
                                   generator=generator)
            dposer, data = self._loss(x, self.prior.timesteps[quan_t], observation, mask,
                                      None if noise is None else noise[i], generator)
            loss = 100.0 / (1.0 + it) * data + 0.1 * (it + 1.0) * dposer
            (g,) = torch.autograd.grad(loss, x)
            with torch.no_grad():
                m = ADAM_B1 * m + (1.0 - ADAM_B1) * g
                v = ADAM_B2 * v + (1.0 - ADAM_B2) * g * g
                m_hat = m / (1.0 - ADAM_B1 ** (i + 1))
                v_hat = v / (1.0 - ADAM_B2 ** (i + 1))
                x -= self.lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        x = x.detach()
        return observation * mask + x * (1.0 - mask)

    def _cuda_solver(self, rows: int, dim: int, n_elems: int, rng_mode: str):
        key = (rows, dim, n_elems, rng_mode)
        if key not in self._solvers:
            from ..ops.cuda.fused_comp import get_cuda_comp_solver

            self._solvers[key] = get_cuda_comp_solver(
                self.sde, self._model, (rows, dim), n_elems, lr=self.lr,
                iterations=self.iterations, steps_per_iter=self.steps_per_iter,
                time_strategy=self.time_strategy, sample_trun=self.sample_trun,
                sample_time=self.sample_time, rng_mode=rng_mode,
                continuous=self.continuous, device=self.device)
        return self._solvers[key]

    def _default_rng_mode(self) -> str:
        return "kernel" if self.device.type == "cuda" else "host"

    def optimize(self, observation: torch.Tensor, mask: torch.Tensor, noise=None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One completion pass on ``observation``/``mask`` [B, D]. ``noise``
        [total_steps, B, D] injects the per-step perturbation normals."""
        if self.backend == "cuda":
            b, d = observation.shape
            solver = self._cuda_solver(b, d, b * d, "host" if noise is not None
                                       else self._default_rng_mode())
            return solver(generator, observation, mask, noise=noise)
        return self._optimize_torch(observation, mask, noise, generator)

    def optimize_hypos(self, observation: torch.Tensor, mask: torch.Tensor, hypo: int,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``hypo`` completions of every pose -> [B, hypo, D]."""
        b, d = observation.shape
        if self.backend == "cuda":
            # hypotheses are extra rows: the mean-loss gradients are
            # per-element with the per-hypothesis 1/(B*D) divisor, so
            # flattening is exact
            solver = self._cuda_solver(hypo * b, d, b * d, self._default_rng_mode())
            out = solver(generator, observation.repeat(hypo, 1), mask.repeat(hypo, 1))
            return out.reshape(hypo, b, d).transpose(0, 1)
        return torch.stack([self._optimize_torch(observation, mask, None, generator)
                            for _ in range(hypo)], dim=1)
