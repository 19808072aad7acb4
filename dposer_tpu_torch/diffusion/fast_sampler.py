"""Tabled Euler-Maruyama / PC sampler for ScoreModelFC.

Every x-independent quantity of a step is precomputed as an ``[N, ...]``
table before the loop (the contract the CUDA kernels consume):

- predictor constants: ``x_mean = cx[i]*x + cout[i]*model_out``,
  ``x = x_mean + cnoise[i]*z``;
- langevin constants: ``score = score_scale[i]*model_out`` and the
  corrector's ``alpha[i]``;
- the time-embedding path: each layer's ``Dense(temb)`` contribution.

What is left per step is 6 matmuls, 3 GroupNorms, SiLUs and 3 scalar-table
multiplies.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..models.score_mlp import ScoreModelFC
from ..models.time_embedding import get_timestep_embedding
from .sde import SDE, VESDE, VPSDE, SubVPSDE

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _em_tables(sde: SDE, timesteps: torch.Tensor,
               probability_flow: bool = False) -> Tables:
    """Per-step (cx, cout, cnoise) of the reverse EM update.

    dt = -1/N; drift = f(x,t) - g(t)^2 * score with score = -out/std(t) for
    VP/subVP (continuous) and score = out for VE. ``probability_flow`` halves
    the score term and drops the noise (ref sde_lib.py:98-109).
    """
    dt = -1.0 / sde.N
    sqrt_mdt = math.sqrt(1.0 / sde.N)
    zeros = torch.zeros_like(timesteps)
    if isinstance(sde, (VPSDE, SubVPSDE)):
        beta_t = sde.beta_0 + timesteps * (sde.beta_1 - sde.beta_0)
        _, diffusion = sde.sde(zeros, timesteps)
        _, std = sde.marginal_prob(zeros, timesteps)
        cx = 1.0 + (-0.5 * beta_t) * dt
        cout = (diffusion ** 2 / std) * dt
        cnoise = diffusion * sqrt_mdt
    elif isinstance(sde, VESDE):
        _, diffusion = sde.sde(zeros, timesteps)
        cx = torch.ones_like(timesteps)
        cout = -diffusion ** 2 * dt
        cnoise = diffusion * sqrt_mdt
    else:
        raise NotImplementedError(type(sde).__name__)
    if probability_flow:
        cout = 0.5 * cout
        cnoise = torch.zeros_like(cnoise)
    return cx, cout, cnoise


def _rd_tables(sde: SDE, timesteps: torch.Tensor,
               probability_flow: bool = False) -> Tables:
    """Per-step (cx, cout, cnoise) of the reverse-diffusion predictor
    (ref sampling.py:210-220); ``f`` is linear with ``f(0) = 0``, so
    ``f(1)`` captures it. The score factor stays full under probability
    flow (ref sde_lib.py:114-115)."""
    f1, G = sde.discretize(torch.ones((timesteps.shape[0], 1),
                                      device=timesteps.device), timesteps)
    f1 = f1[:, 0]
    G = torch.broadcast_to(G, timesteps.shape)
    ss, _ = _corrector_tables(sde, timesteps, None)
    cnoise = torch.zeros_like(G) if probability_flow else G
    return 1.0 - f1, G ** 2 * ss, cnoise


def _pred_tables(sde: SDE, timesteps: torch.Tensor, predictor: str,
                 probability_flow: bool = False) -> Tables:
    if predictor == "euler_maruyama":
        return _em_tables(sde, timesteps, probability_flow)
    if predictor == "reverse_diffusion":
        return _rd_tables(sde, timesteps, probability_flow)
    raise NotImplementedError(f"tabled samplers support euler_maruyama/"
                              f"reverse_diffusion; got {predictor!r}")


def _labels_for(sde: SDE, timesteps: torch.Tensor) -> torch.Tensor:
    if isinstance(sde, (VPSDE, SubVPSDE)):
        return timesteps * 999
    return sde.marginal_prob(torch.zeros_like(timesteps), timesteps)[1]


@torch.no_grad()
def precompute_time_tables(model: ScoreModelFC, labels: torch.Tensor):
    """(tprojs: name -> [N, H] time projections incl. their bias,
    out_scale: [N] or None)."""
    if model.embedding_type != "positional":
        raise NotImplementedError("fast sampler supports positional embeddings")
    temb = model.shared_time_embed(get_timestep_embedding(labels, model.embed_dim))
    names = ["pre_dense_t"] + [f"b{i + 1}_dense{j}_t"
                               for i in range(model.n_blocks) for j in (1, 2)]
    tprojs = {name: getattr(model, name)(temb) for name in names}
    out_scale = None
    if model.scale_by_sigma:
        out_scale = 1.0 / model.sigmas[labels.long()]
    return tprojs, out_scale


def _group_norm(h, scale, bias, num_groups=32, eps=1e-5):
    b, c = h.shape
    g = h.reshape(b, num_groups, c // num_groups)
    mean = g.mean(-1, keepdim=True)
    var = g.var(-1, unbiased=False, keepdim=True)
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(b, c) * scale + bias


def make_fast_forward(model: ScoreModelFC, tprojs, out_scale):
    """Step-indexed network forward ``fwd(x, i) -> model_out``."""
    act = model.act

    def dense(name, h):
        return torch.nn.functional.linear(h, getattr(model, name).weight,
                                          getattr(model, name).bias)

    def gnorm(name, h):
        g = getattr(model, name)
        return act(_group_norm(h, g.weight, g.bias))

    def fwd(x, i):
        h = gnorm("pre_gnorm", dense("pre_dense", x) + tprojs["pre_dense_t"][i])
        for blk in range(model.n_blocks):
            b = f"b{blk + 1}_"
            h1 = gnorm(b + "gnorm1", dense(b + "dense1", h) + tprojs[b + "dense1_t"][i])
            h2 = gnorm(b + "gnorm2", dense(b + "dense2", h1) + tprojs[b + "dense2_t"][i])
            h = h + h2
        res = dense("post_dense", h)
        return res * out_scale[i] if out_scale is not None else res

    return fwd


def _corrector_tables(sde: SDE, timesteps: torch.Tensor, out_scale):
    """Per-step (score_scale, alpha) for the langevin corrector: ``score =
    score_scale[i]*raw_model_out`` (folds the sigma output scaling and the
    -1/std adapter); alpha as the corrector's step size uses it
    (ref sampling.py:280-287)."""
    if isinstance(sde, (VPSDE, SubVPSDE)):
        _, std = sde.marginal_prob(torch.zeros_like(timesteps), timesteps)
        score_scale = -1.0 / std
        alpha = sde.alphas(timesteps.device)[(timesteps * (sde.N - 1) / sde.T).long()]
    elif isinstance(sde, VESDE):
        score_scale = torch.ones_like(timesteps)
        alpha = torch.ones_like(timesteps)
    else:
        raise NotImplementedError(type(sde).__name__)
    if out_scale is not None:
        score_scale = score_scale * out_scale
    return score_scale, alpha


def _imputation_tables(sde: SDE, timesteps: torch.Tensor):
    """Per-step (mean_coeff, std): the re-noised observation is
    ``mc[i]*obs + std[i]*z`` (ref sampling.py:418-421)."""
    mean, std = sde.marginal_prob(torch.ones((timesteps.shape[0], 1),
                                             device=timesteps.device), timesteps)
    return mean[:, 0], std


def get_fast_pc_sampler(sde: SDE, model: ScoreModelFC, shape: Tuple[int, ...],
                        eps: float = 1e-3, denoise: bool = True,
                        corrector: str = "none", snr: float = 0.16,
                        n_corrector_steps: int = 1,
                        predictor: str = "euler_maruyama",
                        probability_flow: bool = False, device="cuda"):
    """Tabled PC sampler in fp32: EM (or reverse-diffusion) predictor and an
    optional langevin corrector, on the same tables the kernels use.

    ``sampler(generator=None, z=None, noise=None) -> x``; ``noise=[N, K, B,
    D]`` injects the per-step slabs in order corr_0..corr_{S-1}, predictor.
    """
    if corrector not in ("none", "langevin"):
        raise NotImplementedError(f"corrector {corrector!r}")
    timesteps = sde.timesteps(eps, device=device)
    labels = _labels_for(sde, timesteps)
    cx, cout, cnoise = _pred_tables(sde, timesteps, predictor, probability_flow)
    tprojs, out_scale = precompute_time_tables(model, labels)
    score_scale, alpha = _corrector_tables(sde, timesteps, out_scale)
    if out_scale is not None:
        cout = cout * out_scale
    fwd = make_fast_forward(model, tprojs, None)  # scales folded into the tables
    n_steps = int(timesteps.shape[0])
    S = n_corrector_steps if corrector == "langevin" else 0

    def langevin_step(x, i, z):
        score = score_scale[i] * fwd(x, i)
        grad_norm = torch.sqrt(torch.sum(score * score, dim=-1)).mean()
        noise_norm = torch.sqrt(torch.sum(z * z, dim=-1)).mean()
        step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * alpha[i]
        return x + step_size * score + torch.sqrt(step_size * 2) * z

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, z=None, noise=None):
        if noise is not None and noise.shape[1] != S + 1:
            raise ValueError(f"noise needs K={S + 1} slabs per step, got "
                             f"{noise.shape[1]}")
        x = sde.prior_sampling(shape, generator, device) if z is None else z
        x_mean = x
        for i in range(n_steps):
            zs = (noise[i] if noise is not None else
                  torch.randn((S + 1,) + tuple(shape), generator=generator,
                              device=device))
            for j in range(S):
                x = langevin_step(x, i, zs[j])
            x_mean = cx[i] * x + cout[i] * fwd(x, i)
            x = x_mean + cnoise[i] * zs[S]
        return x_mean if denoise else x

    return sampler
