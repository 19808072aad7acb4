"""Probability-flow-ODE exact log-likelihood in bits/dim (ref
``lib/algorithms/advanced/likelihood.py:26-113``).

The Hutchinson-Skilling divergence comes from one forward-mode
Jacobian-vector product (``torch.autograd.forward_ad``; the primal is the
drift, so an RHS costs about two network forwards). ``get_likelihood_fn`` integrates the augmented state with the
adaptive RK45 and is the accuracy oracle; ``get_fast_likelihood_fn`` is the
tabled fixed-grid RK4 in fp32. The kernel path is
``ops.cuda.fused_lik.get_cuda_likelihood_fn``.

The Hutchinson probe comes from an explicit ``torch.Generator``, or is
injected with ``epsilon=``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.autograd.forward_ad as fwad

from . import ode as ode_lib
from .fast_sampler import make_fast_forward, pf_ode_grid, precompute_time_tables
from .sde import SDE


def draw_epsilon(hutchinson_type: str, shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """The Hutchinson probe: standard normals or Rademacher signs."""
    if hutchinson_type == "Gaussian":
        return torch.randn(shape, generator=generator, device=device)
    if hutchinson_type == "Rademacher":
        return torch.randint(0, 2, shape, generator=generator,
                             device=device).float() * 2.0 - 1.0
    raise NotImplementedError(f"Hutchinson type {hutchinson_type} unknown.")


def bits_per_dim(sde: SDE, z: torch.Tensor, delta_logp: torch.Tensor) -> torch.Tensor:
    """``-(log p_T(z) + delta_logp) / ln 2 / D`` per row."""
    return -(sde.prior_logp(z) + delta_logp) / math.log(2) / math.prod(z.shape[1:])


def jvp(fn: Callable, x: torch.Tensor, v: torch.Tensor):
    """``(fn(x), J_fn(x) v)`` in one forward-mode pass."""
    with fwad.dual_level():
        out = fwad.unpack_dual(fn(fwad.make_dual(x, v)))
    tangent = out.tangent if out.tangent is not None else torch.zeros_like(out.primal)
    return out.primal, tangent


def get_div_fn(fn: Callable) -> Callable:
    """``div_fn(x, t, eps) -> (fn(x, t), eps^T J eps)``: the Hutchinson
    divergence estimate of ``fn`` in ``x`` from one forward-mode jvp."""

    def div_fn(x, t, eps):
        primal, tangent = jvp(lambda xx: fn(xx, t), x, eps)
        return primal, torch.sum(tangent * eps, dim=tuple(range(1, x.ndim)))

    return div_fn


def _full_t(x: torch.Tensor, t) -> torch.Tensor:
    return torch.full((x.shape[0],), float(t), dtype=x.dtype, device=x.device)


def get_likelihood_fn(sde: SDE, score_fn: Callable, hutchinson_type: str = "Rademacher",
                      rtol: float = 1e-5, atol: float = 1e-5, eps: float = 1e-5):
    """``likelihood_fn(generator, data, epsilon=None) -> (bpd [B], z [B, D],
    nfe)`` on the adaptive RK45, data -> prior. Poses are evaluated in the
    normalized space the model was trained in. A run that exhausts the
    solver's step budget returns NaNs."""
    pf_rsde = sde.reverse_sde(score_fn, probability_flow=True)
    div_fn = get_div_fn(lambda x, vec_t: pf_rsde(x, vec_t)[0])

    @torch.no_grad()
    def likelihood_fn(generator, data, epsilon=None):
        if epsilon is None:
            epsilon = draw_epsilon(hutchinson_type, data.shape, generator, data.device)

        def ode_func(t, state):
            drift, logp_grad = div_fn(state[:, :-1], _full_t(state, t), epsilon)
            return torch.cat([drift, logp_grad[:, None]], dim=1)

        init = torch.cat([data, torch.zeros_like(data[:, :1])], dim=1)
        sol = ode_lib.rk45(ode_func, eps, sde.T, init, rtol=rtol, atol=atol)
        y = sol.y if sol.status == 0 else torch.full_like(sol.y, float("nan"))
        z, delta_logp = y[:, :-1], y[:, -1]
        return bits_per_dim(sde, z, delta_logp), z, sol.nfe

    return likelihood_fn


def get_latent_encoder(sde: SDE, score_fn: Callable, rtol: float = 1e-5,
                       atol: float = 1e-5, eps: float = 1e-3):
    """``encode(data) -> (z, nfe)``: the forward PF-ODE, data -> latent, on
    the adaptive RK45 (NaNs if the step budget runs out)."""
    pf_rsde = sde.reverse_sde(score_fn, probability_flow=True)

    @torch.no_grad()
    def encode(data):
        sol = ode_lib.rk45(lambda t, x: pf_rsde(x, _full_t(x, t))[0], eps, sde.T, data,
                           rtol=rtol, atol=atol)
        z = sol.y if sol.status == 0 else torch.full_like(sol.y, float("nan"))
        return z, sol.nfe

    return encode


def get_fast_likelihood_fn(sde: SDE, model, n_steps: int = 100,
                           hutchinson_type: str = "Rademacher", eps: float = 1e-5):
    """Tabled fixed-grid RK4 likelihood in fp32, the contract of
    ``get_likelihood_fn``. The drift coefficients and every x-independent
    network quantity are precomputed on the ``2*n_steps + 1`` stage-time grid
    from ``eps`` to T; each of the ``4*n_steps`` stages is one jvp through the
    6-matmul fast forward. ``nfe`` is the static ``4*n_steps``."""
    device = model.sigmas.device
    _, labels, a1, a2, h = pf_ode_grid(sde, model, eps, sde.T, n_steps, device)
    tprojs, _ = precompute_time_tables(model, labels)
    fwd = make_fast_forward(model, tprojs, None)  # the output scale is folded into a2

    @torch.no_grad()
    def likelihood_fn(generator, data, epsilon=None):
        if epsilon is None:
            epsilon = draw_epsilon(hutchinson_type, data.shape, generator, data.device)

        def ode_fn(x, j):
            drift, jv = jvp(lambda xx: a1[j] * xx + a2[j] * fwd(xx, j), x, epsilon)
            return drift, torch.sum(jv * epsilon, dim=-1)

        x, lp = data, torch.zeros_like(data[:, 0])
        for i in range(n_steps):
            j = 2 * i
            d1, v1 = ode_fn(x, j)
            d2, v2 = ode_fn(x + 0.5 * h * d1, j + 1)
            d3, v3 = ode_fn(x + 0.5 * h * d2, j + 1)
            d4, v4 = ode_fn(x + h * d3, j + 2)
            x = x + (h / 6.0) * (d1 + 2.0 * d2 + 2.0 * d3 + d4)
            lp = lp + (h / 6.0) * (v1 + 2.0 * v2 + 2.0 * v3 + v4)
        return bits_per_dim(sde, x, lp), x, 4 * n_steps

    return likelihood_fn
