"""Tabled samplers for ScoreModelFC: Euler-Maruyama / PC, and the fixed-grid
RK4 integrator of the probability-flow ODE.

Every x-independent quantity of a step is precomputed as an ``[N, ...]``
table before the loop (the contract the CUDA kernels consume):

- predictor constants: ``x_mean = cx[i]*x + cout[i]*model_out``,
  ``x = x_mean + cnoise[i]*z``;
- langevin constants: ``score = score_scale[i]*model_out`` and the
  corrector's ``alpha[i]``;
- the time-embedding path: each layer's ``Dense(temb)`` contribution.

What is left per step is 6 matmuls, 3 GroupNorms, SiLUs and 3 scalar-table
multiplies. The PF-ODE paths (``get_fast_ode_sampler``, the likelihood of
``likelihood.py`` and the RK4 kernels) precompute the same on a stage-time grid
(``pf_ode_grid``): the drift there is ``a1[j]*x + a2[j]*model_out``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..models.score_mlp import ScoreModelFC
from ..models.time_embedding import get_timestep_embedding
from .sde import SDE, VESDE, VPSDE, SubVPSDE, linspace_f32

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


def _pf_tables(sde: SDE, taus: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-grid-point (a1, a2): the probability-flow-ODE drift is
    ``a1[j]*x + a2[j]*model_out`` (ref sde_lib.py:98-109 with
    probability_flow=True: f - g^2*score/2, score = -out/std for VP/subVP
    continuous and = out for VE)."""
    zeros = torch.zeros_like(taus)
    if isinstance(sde, (VPSDE, SubVPSDE)):
        beta_t = sde.beta_0 + taus * (sde.beta_1 - sde.beta_0)
        _, diffusion = sde.sde(zeros, taus)
        _, std = sde.marginal_prob(zeros, taus)
        return -0.5 * beta_t, 0.5 * diffusion ** 2 / std
    if isinstance(sde, VESDE):
        _, diffusion = sde.sde(zeros, taus)
        return zeros, -0.5 * diffusion ** 2
    raise NotImplementedError(type(sde).__name__)


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


def _sliced_timesteps(sde: SDE, eps: float, step_range, device):
    """The N-step grid, or rows ``lo..hi`` of it. Every per-step table is a
    function of the timestep value and ``sde.N`` only (``dt = -1/N``), never
    of the grid's length, so a sliced grid runs those steps identically."""
    timesteps = sde.timesteps(eps, device=device)
    if step_range is None:
        return timesteps
    lo, hi = step_range
    if not 0 <= lo < hi <= int(timesteps.shape[0]):
        raise ValueError(f"step_range {step_range} out of bounds for the "
                         f"{int(timesteps.shape[0])}-step grid")
    return timesteps[lo:hi]


def check_imputation_args(imputation: bool, observation, mask) -> None:
    if (observation is None) != (mask is None) or (observation is None) == imputation:
        raise ValueError("observation/mask must be passed iff the sampler was "
                         "built with imputation=True")


def impute(x, observation, mask, mean_coeff, std, z):
    """The masked re-noise and overwrite of the completion samplers (ref
    sampling.py:410-427): observed dims become ``mean_coeff*obs + std*z``."""
    return x * (1 - mask) + (mean_coeff * observation + std * z) * mask


def get_fast_pc_sampler(sde: SDE, model: ScoreModelFC, shape: Tuple[int, ...],
                        eps: float = 1e-3, denoise: bool = True,
                        corrector: str = "none", snr: float = 0.16,
                        n_corrector_steps: int = 1, imputation: bool = False,
                        predictor: str = "euler_maruyama",
                        probability_flow: bool = False,
                        step_range: Optional[Tuple[int, int]] = None,
                        device="cuda"):
    """Tabled PC sampler in fp32: EM (or reverse-diffusion) predictor, an
    optional langevin corrector and optional masked imputation, on the same
    tables the kernels use.

    ``sampler(generator=None, observation=None, mask=None, z=None,
    noise=None) -> x``. ``noise=[N, K, B, D]`` injects the per-step slabs in
    the order corr_0..corr_{S-1}, imput_c, em, imput_p (present slots only:
    K = S + 1, plus 2 with imputation); without it each step draws its K slabs
    from ``generator`` in that order. ``step_range=(lo, hi)`` runs rows
    ``lo..hi`` of the N-step grid, the state carried in through ``z=`` and
    out through the return: head then tail on one generator is the full run.
    With ``denoise`` the return is the last row's ``x_mean``, which is not
    re-imputed.
    """
    if corrector not in ("none", "langevin"):
        raise NotImplementedError(f"corrector {corrector!r}")
    timesteps = _sliced_timesteps(sde, eps, step_range, device)
    labels = _labels_for(sde, timesteps)
    cx, cout, cnoise = _pred_tables(sde, timesteps, predictor, probability_flow)
    tprojs, out_scale = precompute_time_tables(model, labels)
    score_scale, alpha = _corrector_tables(sde, timesteps, out_scale)
    mc, istd = _imputation_tables(sde, timesteps)
    if out_scale is not None:
        cout = cout * out_scale
    fwd = make_fast_forward(model, tprojs, None)  # scales folded into the tables
    n_steps = int(timesteps.shape[0])
    S = n_corrector_steps if corrector == "langevin" else 0
    K = S + (2 if imputation else 0) + 1

    def langevin_step(x, i, z):
        score = score_scale[i] * fwd(x, i)
        grad_norm = torch.sqrt(torch.sum(score * score, dim=-1)).mean()
        noise_norm = torch.sqrt(torch.sum(z * z, dim=-1)).mean()
        step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * alpha[i]
        return x + step_size * score + torch.sqrt(step_size * 2) * z

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, observation=None,
                mask=None, z=None, noise=None):
        check_imputation_args(imputation, observation, mask)
        if noise is not None and noise.shape[1] != K:
            raise ValueError(f"noise needs K={K} slabs per step, got "
                             f"{noise.shape[1]}: {S} corrector + "
                             f"{K - S - 1} imputation + 1 predictor")
        x = sde.prior_sampling(shape, generator, device) if z is None else z
        x_mean = x
        for i in range(n_steps):
            zs = (noise[i] if noise is not None else
                  torch.randn((K,) + tuple(shape), generator=generator,
                              device=device))
            for j in range(S):
                x = langevin_step(x, i, zs[j])
            k = S
            if imputation:
                x = impute(x, observation, mask, mc[i], istd[i], zs[k])
                k += 1
            x_mean = cx[i] * x + cout[i] * fwd(x, i)
            x = x_mean + cnoise[i] * zs[k]
            if imputation:
                x = impute(x, observation, mask, mc[i], istd[i], zs[k + 1])
        return x_mean if denoise else x

    return sampler


def get_fast_em_sampler(sde: SDE, model: ScoreModelFC, shape: Tuple[int, ...],
                        eps: float = 1e-3, denoise: bool = True, device="cuda"):
    """The tabled EM sampler with no corrector, in fp32, the model's sigma
    output scaling applied to the network's output as the model applies it.

    ``sampler(generator=None, z=None, noise=None) -> x``; ``noise`` [N, B, D]
    injects the per-step normals.
    """
    timesteps = sde.timesteps(eps, device=device)
    cx, cout, cnoise = _em_tables(sde, timesteps)
    tprojs, out_scale = precompute_time_tables(model, _labels_for(sde, timesteps))
    fwd = make_fast_forward(model, tprojs, out_scale)

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, z=None, noise=None):
        x = sde.prior_sampling(shape, generator, device) if z is None else z
        x_mean = x
        for i in range(sde.N):
            z_i = (noise[i] if noise is not None else
                   torch.randn(shape, generator=generator, device=device))
            x_mean = cx[i] * x + cout[i] * fwd(x, i)
            x = x_mean + cnoise[i] * z_i
        return x_mean if denoise else x

    return sampler


def pf_ode_grid(sde: SDE, model: ScoreModelFC, t_start: float, t_end: float,
                n_steps: int, device):
    """The stage-time grid of an ``n_steps`` fixed-grid RK4 run of the
    probability-flow ODE from ``t_start`` to ``t_end``: ``tau_j = t_start +
    j*h/2`` for j = 0..2*n_steps. Returns ``(taus, labels, a1, a2, h)`` with
    the drift ``a1[j]*x + a2[j]*raw_model_out`` (``a2`` folds the model's
    sigma output scaling) and the step ``h``."""
    taus = linspace_f32(t_start, t_end, 2 * n_steps + 1, device=device)
    labels = _labels_for(sde, taus)
    a1, a2 = _pf_tables(sde, taus)
    if model.scale_by_sigma:
        a2 = a2 / model.sigmas[labels.long()]
    return taus, labels, a1, a2, (t_end - t_start) / n_steps


def denoise_coefs(sde: SDE, model: ScoreModelFC, eps: float, device):
    """``(cdx, cdo)`` of the PF-ODE samplers' final denoise, one noise-free
    reverse-diffusion step at ``eps`` (ref sampling.py:492-498): ``x <- cdx*x
    + cdo*raw_model_out``. ``f`` is linear with ``f(0) = 0``, so ``f(1)``
    captures it."""
    t = torch.full((1,), float(eps), device=device)
    f1, G = sde.discretize(torch.ones((1, 1), device=device), t)
    out_scale = (1.0 / model.sigmas[_labels_for(sde, t).long()]
                 if model.scale_by_sigma else None)
    ss, _ = _corrector_tables(sde, t, out_scale)
    return 1.0 - f1.reshape(-1)[0], G.reshape(-1)[0] ** 2 * ss[0]


def get_fast_ode_sampler(sde: SDE, model: ScoreModelFC, shape: Tuple[int, ...],
                         n_steps: int = 125, eps: float = 1e-3, denoise: bool = False,
                         device="cuda"):
    """Tabled fixed-grid RK4 probability-flow-ODE sampler in fp32.

    The drift coefficients, time embeddings and per-layer time projections
    are precomputed on the ``2*n_steps + 1`` stage-time grid from T to
    ``eps``, so each of the ``4*n_steps`` network evaluations is the 6-matmul
    fast forward; the adaptive ``sampling.get_ode_sampler`` stays the accuracy
    oracle. ``sampler(generator=None, z=None) -> (nfe, x)`` with the static
    ``nfe = 4*n_steps``; ``denoise`` adds the noise-free reverse-diffusion
    step at ``eps``.
    """
    _, labels, a1, a2, h = pf_ode_grid(sde, model, sde.T, eps, n_steps, device)
    tprojs, _ = precompute_time_tables(model, labels)
    fwd = make_fast_forward(model, tprojs, None)  # the output scale is folded into a2
    cdx, cdo = denoise_coefs(sde, model, eps, device)

    def drift(x, j):
        return a1[j] * x + a2[j] * fwd(x, j)

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, z=None):
        x = sde.prior_sampling(shape, generator, device) if z is None else z
        for i in range(n_steps):
            j = 2 * i
            k1 = drift(x, j)
            k2 = drift(x + 0.5 * h * k1, j + 1)
            k3 = drift(x + 0.5 * h * k2, j + 1)
            k4 = drift(x + h * k3, j + 2)
            x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        if denoise:
            x = cdx * x + cdo * fwd(x, 2 * n_steps)
        return 4 * n_steps, x

    return sampler
