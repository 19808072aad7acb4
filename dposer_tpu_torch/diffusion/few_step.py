"""Few-step deterministic samplers (DDIM, DPM-Solver++(2M)) and the hybrid
DDIM -> pc sampler. Port of ``dposer_tpu/diffusion/few_step.py``.

- **DDIM** (Song et al., ICLR'21, eta = 0): ``x' = (a'/a) x + (s' - (a'/a) s)
  eps_hat`` is the reverse-diffusion kernels' 3-scalar update with zero
  noise, so the kernel route (``get_cuda_ddim_sampler``) is the kernel
  sampler run on overridden tables.
- **DPM-Solver++(2M)** (Lu et al.'22): second-order multistep in
  data-prediction form, ``x' = (s'/s) x - a' (e^{-h} - 1) D`` with ``D`` the
  extrapolated x0-prediction. It has no kernel route, as in the JAX package.
- **hybrid**: ``n_head`` DDIM steps down to the ``(N - m_tail)``-th point of
  the N-step schedule, then the pc sampler's last ``m_tail`` rows verbatim
  (EM with masked re-noise, langevin corrector by default). A deterministic
  integrator never reconciles the overwritten observed block with the
  sampled rest; the late stochastic rows do. NFE = n_head + m_tail*(1 + S).

All support the SDEs with Gaussian marginals ``x_t = a(t) x0 + s(t) eps`` and
a uniform-t or uniform-log-SNR (``grid="lambda"``) step grid. With
``imputation=True`` every row is wrapped in the masked re-noise and overwrite
of the completion samplers (ref sampling.py:410-427).

Samplers return ``(nfe, x)``. Noise comes from a ``torch.Generator``, each
row drawing its slabs in the order imput_c, imput_p; ``noise=`` injects them.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..models.score_mlp import ScoreModelFC
from .fast_sampler import (_corrector_tables, _imputation_tables, _labels_for,
                           check_imputation_args, get_fast_pc_sampler, impute,
                           make_fast_forward, precompute_time_tables)
from .sde import SDE, linspace_f32


def _alpha_sigma_1d(sde: SDE, taus: torch.Tensor):
    a, s = sde.return_alpha_sigma(taus)
    return a.reshape(-1), s.reshape(-1)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """1-D linear interpolation over increasing ``xp`` (``numpy.interp``)."""
    hi = torch.searchsorted(xp, x).clamp(1, xp.numel() - 1)
    lo = hi - 1
    w = (x - xp[lo]) / (xp[hi] - xp[lo])
    return fp[lo] + w.clamp(0.0, 1.0) * (fp[hi] - fp[lo])


def step_grid(sde: SDE, n_points: int, eps: float, grid: str = "t",
              device=None) -> torch.Tensor:
    """``n_points`` time points from T to eps: uniform in t, or uniform in
    the log-SNR ``lambda = log(alpha/sigma)`` (``grid="lambda"``, inverted
    numerically on a fine t-grid)."""
    if grid == "t":
        return linspace_f32(sde.T, eps, n_points, device=device)
    if grid != "lambda":
        raise ValueError(f"grid must be 't' or 'lambda', got {grid!r}")
    t_fine = linspace_f32(sde.T, eps, 4096, device=device)
    a, s = _alpha_sigma_1d(sde, t_fine)
    lam_fine = torch.log(a) - torch.log(s)  # increases as t decreases
    lams = linspace_f32(float(lam_fine[0]), float(lam_fine[-1]), n_points, device=device)
    taus = _interp(lams, lam_fine, t_fine)
    taus[0], taus[-1] = sde.T, eps
    return taus


def _eps_hat_scale(sde: SDE, taus: torch.Tensor, out_scale):
    """Per-point c with ``eps_hat = c * raw_model_out`` (``eps_hat = -score *
    sigma``, ``score = score_scale * raw``)."""
    score_scale, _ = _corrector_tables(sde, taus, out_scale)
    _, s = _alpha_sigma_1d(sde, taus)
    return -score_scale * s


@torch.no_grad()
def ddim_tables(sde: SDE, n_steps: int, eps: float, model: ScoreModelFC,
                denoise: bool = True, grid: str = "t", device=None):
    """``(taus_eval, cx, cout, cnoise=0)`` rows of the 3-scalar update ``x' =
    cx*x + cout*raw_out``, the kernels' table contract; ``cout`` has any
    sigma output scaling folded in. With ``denoise`` a last x0-projection row
    ``x0_hat = x/a_eps - (s_eps/a_eps) eps_hat`` is appended."""
    taus = step_grid(sde, n_steps + 1, eps, grid, device)
    a, s = _alpha_sigma_1d(sde, taus)
    _, oscale = precompute_time_tables(model, _labels_for(sde, taus))
    ehat = _eps_hat_scale(sde, taus, oscale)
    cx = a[1:] / a[:-1]
    cout = (s[1:] - cx * s[:-1]) * ehat[:-1]
    taus_eval = taus[:-1]
    if denoise:
        cx = torch.cat([cx, 1.0 / a[-1:]])
        cout = torch.cat([cout, -(s[-1:] / a[-1:]) * ehat[-1:]])
        taus_eval = taus
    return taus_eval, cx, cout, torch.zeros_like(cx)


def _imputation_noise(noise, n_rows: int, shape, generator, device) -> Callable:
    """``draw(i) -> [2, B, D]``: row i's imputation slabs (imput_c, imput_p)."""
    if noise is not None and tuple(noise.shape) != (n_rows, 2) + tuple(shape):
        raise ValueError(f"noise must be {(n_rows, 2) + tuple(shape)} (per row: "
                         f"imput_c, imput_p), got {tuple(noise.shape)}")
    if noise is not None:
        return lambda i: noise[i]
    return lambda i: torch.randn((2,) + tuple(shape), generator=generator, device=device)


def get_ddim_sampler(sde: SDE, model: ScoreModelFC, shape: Tuple[int, ...],
                     n_steps: int = 50, eps: float = 1e-3, denoise: bool = True,
                     grid: str = "t", imputation: bool = False, device="cuda"):
    """Tabled DDIM in fp32: ``sampler(generator=None, observation=None,
    mask=None, z=None, noise=None) -> (nfe, x)``; ``noise=[rows, 2, B, D]``
    injects the imputation slabs."""
    taus_eval, cx, cout, _ = ddim_tables(sde, n_steps, eps, model, denoise=denoise,
                                         grid=grid, device=device)
    tprojs, _ = precompute_time_tables(model, _labels_for(sde, taus_eval))
    fwd = make_fast_forward(model, tprojs, None)  # ddim_tables folded the scaling
    n_rows = int(taus_eval.shape[0])
    mc, istd = _imputation_tables(sde, taus_eval)

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, observation=None,
                mask=None, z=None, noise=None):
        check_imputation_args(imputation, observation, mask)
        x = sde.prior_sampling(shape, generator, device) if z is None else z
        draw = _imputation_noise(noise, n_rows, shape, generator, device)
        for i in range(n_rows):
            if imputation:
                zs = draw(i)
                x = impute(x, observation, mask, mc[i], istd[i], zs[0])
            x = cx[i] * x + cout[i] * fwd(x, i)
            if imputation:
                x = impute(x, observation, mask, mc[i], istd[i], zs[1])
        return n_rows, x

    return sampler


def get_dpm_sampler(sde: SDE, model: ScoreModelFC, shape: Tuple[int, ...],
                    n_steps: int = 20, eps: float = 1e-3, denoise: bool = True,
                    grid: str = "lambda", imputation: bool = False, device="cuda"):
    """Tabled DPM-Solver++(2M): the loop carries the previous step's
    x0-prediction; the first step is first-order. With ``denoise`` one more
    evaluation projects to x0 at eps (and, with imputation, is re-imputed
    once). ``noise=[n_steps + 1, 2, B, D]``: the last row's first slab is the
    projection's."""
    taus = step_grid(sde, n_steps + 1, eps, grid, device)
    a, s = _alpha_sigma_1d(sde, taus)
    tprojs, out_scale = precompute_time_tables(model, _labels_for(sde, taus))
    ehat = _eps_hat_scale(sde, taus, out_scale)
    fwd = make_fast_forward(model, tprojs, None)

    lam = torch.log(a) - torch.log(s)
    h = lam[1:] - lam[:-1]
    r = torch.cat([torch.ones_like(h[:1]), h[:-1] / h[1:]])  # r_j = h_{j-1}/h_j
    c_x = s[1:] / s[:-1]
    c_D = -a[1:] * (torch.exp(-h) - 1.0)
    # x0_hat_j = (x - s_j * ehat_j * raw) / a_j, for every grid point
    d1 = 1.0 / a
    d2 = -(s / a) * ehat
    # D_j = (1 + 1/(2 r_j)) x0_j - 1/(2 r_j) x0_{j-1}; first step: D_0 = x0_0
    w_prev = torch.cat([torch.zeros_like(r[:1]), 1.0 / (2.0 * r[1:])])
    n_rows = int(h.shape[0])
    mc, istd = _imputation_tables(sde, taus)

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, observation=None,
                mask=None, z=None, noise=None):
        check_imputation_args(imputation, observation, mask)
        x = sde.prior_sampling(shape, generator, device) if z is None else z
        draw = _imputation_noise(noise, n_rows + 1, shape, generator, device)
        x0_prev = torch.zeros_like(x)
        for i in range(n_rows):
            if imputation:
                zs = draw(i)
                x = impute(x, observation, mask, mc[i], istd[i], zs[0])
            x0 = d1[i] * x + d2[i] * fwd(x, i)
            D = (1.0 + w_prev[i]) * x0 - w_prev[i] * x0_prev
            x = c_x[i] * x + c_D[i] * D
            if imputation:
                x = impute(x, observation, mask, mc[i], istd[i], zs[1])
            x0_prev = x0
        nfe = n_rows
        if denoise:
            x = d1[n_rows] * x + d2[n_rows] * fwd(x, n_rows)
            if imputation:
                x = impute(x, observation, mask, mc[n_rows], istd[n_rows],
                           draw(n_rows)[0])
            nfe += 1
        return nfe, x

    return sampler


def get_cuda_ddim_sampler(sde: SDE, model: ScoreModelFC, shape: Tuple[int, ...],
                          n_steps: int = 50, eps: float = 1e-3, denoise: bool = True,
                          grid: str = "t", bf16_tail_steps: int = 0, **kw):
    """DDIM through the reverse-diffusion kernels: the DDIM rows are the
    kernel sampler's table contract. ``kw`` goes to ``get_cuda_em_sampler``
    (``imputation``, ``rng_mode``, ``quant``/``act_amax``, ``device``,
    ``plain``, ``mesh``: each part shards over it). With ``imputation=True`` the kernel sampler derives its
    imputation columns from the overridden timesteps.

    ``bf16_tail_steps=K`` (with ``quant="int8"``) splits the rows into an int8
    head and a bf16 tail of the last K rows, the state carried between them:
    the few-step form of the kernel sampler's mixed schedule.
    ``sampler(generator=None, observation=None, mask=None, z=None, noise=None)
    -> (nfe, x)``."""
    from ..ops.cuda.fused_em import get_cuda_em_sampler

    rows = ddim_tables(sde, n_steps, eps, model, denoise=denoise, grid=grid,
                       device=model.sigmas.device)
    n_rows = int(rows[0].shape[0])
    # the kernel sampler's denoise returns the last row's mean: the x0
    # projection row when denoise, the last DDIM mean otherwise (cnoise = 0)
    if not bf16_tail_steps:
        inner = get_cuda_em_sampler(sde, model, shape, eps=eps, denoise=denoise,
                                    _tables_override=rows, **kw)

        def sampler(generator=None, observation=None, mask=None, z=None, noise=None):
            return n_rows, inner(generator, observation=observation, mask=mask, z=z,
                                 noise=noise)

        sampler.loops = inner.loops
        return sampler
    if kw.get("quant") != "int8":
        raise ValueError("bf16_tail_steps requires quant='int8'")
    if not 0 < bf16_tail_steps < n_rows:
        raise ValueError(f"bf16_tail_steps must be in (0, {n_rows}); got {bf16_tail_steps}")
    m = n_rows - bf16_tail_steps
    head = get_cuda_em_sampler(sde, model, shape, eps=eps, denoise=False,
                               _tables_override=tuple(r[:m] for r in rows), **kw)
    tail_kw = {k: v for k, v in kw.items() if k not in ("quant", "act_amax")}
    tail = get_cuda_em_sampler(sde, model, shape, eps=eps, denoise=denoise,
                               _tables_override=tuple(r[m:] for r in rows), **tail_kw)

    def mixed(generator=None, observation=None, mask=None, z=None, noise=None):
        nh = nt = None
        if noise is not None:
            if noise.ndim == 3:
                noise = noise[:, None]
            nh, nt = noise[:m], noise[m:]
        x = head(generator, observation=observation, mask=mask, z=z, noise=nh)
        return n_rows, tail(generator, observation=observation, mask=mask, z=x, noise=nt)

    mixed.loops = head.loops + tail.loops
    return mixed


# ---------------------------------------------------------------------------
# Hybrid DDIM -> pc sampler: few-step head + the exact stochastic tail
# ---------------------------------------------------------------------------

def hybrid_t_switch(sde: SDE, m_tail: int, eps: float) -> float:
    """The time where the DDIM head hands off to the stochastic tail: the
    ``(N - m_tail)``-th point of the N-step schedule, so the tail's rows are
    the last ``m_tail`` rows of the full pc sampler."""
    if not 0 < m_tail < sde.N:
        raise ValueError(f"m_tail must be in (0, {sde.N}); got {m_tail}")
    return float(sde.timesteps(eps)[sde.N - m_tail])


def _head_then_tail(head, tail, nfe: int):
    """``head`` and ``tail`` return x; both draw from the one generator."""

    def sampler(generator=None, observation=None, mask=None, z=None, noise=None):
        nh, nt = (None, None) if noise is None else noise  # (head slabs, tail slabs)
        x = head(generator, observation=observation, mask=mask, z=z, noise=nh)
        return nfe, tail(generator, observation=observation, mask=mask, z=x, noise=nt)

    return sampler


def get_hybrid_sampler(sde: SDE, model: ScoreModelFC, shape: Tuple[int, ...],
                       n_head: int = 25, m_tail: int = 100, eps: float = 1e-3,
                       grid: str = "t", tail_corrector: str = "none",
                       snr: float = 0.16, n_corrector_steps: int = 1,
                       imputation: bool = False, device="cuda"):
    """DDIM head + exact pc tail in fp32. The tail always returns its last
    row's mean (``denoise=True``). ``sampler(generator=None, observation=None,
    mask=None, z=None, noise=None) -> (nfe, x)``; ``noise=(head, tail)``
    injects the two samplers' slabs."""
    t_sw = hybrid_t_switch(sde, m_tail, eps)
    ddim = get_ddim_sampler(sde, model, shape, n_steps=n_head, eps=t_sw,
                            denoise=False, grid=grid, imputation=imputation,
                            device=device)
    tail = get_fast_pc_sampler(sde, model, shape, eps=eps, denoise=True,
                               corrector=tail_corrector, snr=snr,
                               n_corrector_steps=n_corrector_steps,
                               imputation=imputation,
                               step_range=(sde.N - m_tail, sde.N), device=device)
    S = n_corrector_steps if tail_corrector == "langevin" else 0
    return _head_then_tail(lambda g, **k: ddim(g, **k)[1], tail,
                           n_head + m_tail * (1 + S))


def get_cuda_hybrid_sampler(sde: SDE, model: ScoreModelFC, shape: Tuple[int, ...],
                            n_head: int = 25, m_tail: int = 100, eps: float = 1e-3,
                            grid: str = "t", tail_corrector: str = "none",
                            snr: float = 0.16, n_corrector_steps: int = 1, **kw):
    """DDIM head + exact pc tail through the reverse-diffusion kernels: the
    head rides the DDIM table override (no corrector), the tail is the kernel
    sampler's ``step_range=(N - m_tail, N)`` slice, optionally with the
    langevin corrector. ``kw`` goes to both ``get_cuda_em_sampler`` builds
    (``quant``/``act_amax`` quantize both; ``mesh`` shards both, the head's
    rows joined and split again for the tail)."""
    from ..ops.cuda.fused_em import get_cuda_em_sampler

    t_sw = hybrid_t_switch(sde, m_tail, eps)
    rows = ddim_tables(sde, n_head, t_sw, model, denoise=False, grid=grid,
                       device=model.sigmas.device)
    head = get_cuda_em_sampler(sde, model, shape, eps=eps, denoise=False,
                               corrector="none", _tables_override=rows, **kw)
    tail = get_cuda_em_sampler(sde, model, shape, eps=eps, denoise=True,
                               corrector=tail_corrector, snr=snr,
                               n_corrector_steps=n_corrector_steps,
                               step_range=(sde.N - m_tail, sde.N), **kw)
    S = n_corrector_steps if tail_corrector == "langevin" else 0
    sampler = _head_then_tail(head, tail, n_head + m_tail * (1 + S))
    sampler.loops = head.loops + tail.loops  # the kernel loops, graphed or eager
    return sampler


# ---------------------------------------------------------------------------
# Multi-hypothesis completion: hypotheses as rows of one batch
# ---------------------------------------------------------------------------

def _tile_hypos(build_sampler: Callable, shape: Tuple[int, int], hypo_num: int):
    """Tile H hypotheses into the rows of one [H*B, D] sampler and untile its
    output to [B, H, D]. Rows decorrelate through the prior draw and the
    noise streams, which cover the whole row space. A kernel route built
    with ``mesh=`` shards the tiled rows, hypothesis-major, as JAX does."""
    batch, dim = shape
    inner = build_sampler((hypo_num * batch, dim))

    def sampler(generator, observation, mask, z=None, noise=None):
        nfe, out = inner(generator, observation=observation.repeat(hypo_num, 1),
                         mask=mask.repeat(hypo_num, 1), z=z, noise=noise)
        return nfe, out.reshape(hypo_num, batch, dim).transpose(0, 1)

    sampler.loops = getattr(inner, "loops", ())  # the kernel routes' loops
    return sampler


def _tiled(get_sampler: Callable):
    def build(sde: SDE, model: ScoreModelFC, shape: Tuple[int, int], hypo_num: int,
              **kw):
        kw.setdefault("imputation", True)
        return _tile_hypos(lambda s: get_sampler(sde, model, s, **kw), shape, hypo_num)

    build.__doc__ = (f"Multi-hypothesis completion with ``{get_sampler.__name__}``: "
                     f"``sampler(generator, observation [B, D], mask [B, D], z=None, "
                     f"noise=None) -> (nfe, [B, H, D])``; ``z`` and ``noise`` are in "
                     f"the tiled row space.")
    return build


get_ddim_hypo_sampler = _tiled(get_ddim_sampler)
get_dpm_hypo_sampler = _tiled(get_dpm_sampler)
get_hybrid_hypo_sampler = _tiled(get_hybrid_sampler)
get_cuda_ddim_hypo_sampler = _tiled(get_cuda_ddim_sampler)
get_cuda_hybrid_hypo_sampler = _tiled(get_cuda_hybrid_sampler)
