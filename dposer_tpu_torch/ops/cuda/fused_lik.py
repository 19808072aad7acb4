"""The exact PF-ODE log-likelihood on the card: CUDA kernels, the whole
loop replayed as one CUDA graph (``graph_loop.py``).

Port of ``dposer_tpu/ops/pallas/fused_lik.py``. The augmented state ``(x,
delta_logp)`` is integrated forward (data -> prior, eps -> T) with fixed-grid
RK4; every stage evaluates the network and its directional derivative along
the Hutchinson probe ``e``, the tangent propagated by hand through dense,
GroupNorm, SiLU and the skips (forward mode: one more bf16 matmul per primal
matmul). Per stage, six launches on one stream, no host synchronization:

- K7 ``dense_gn_silu_jvp`` (``score_net.py``) x (1 + 2*n_blocks): the hidden
  layers and their tangents at the stage's state and time row, handing the
  activations on in bf16 (the pre layer on the register route, the rest on
  the Hopper route);
- K9 ``head_rk4_jvp``: the output head for both (split-K over a cluster of
  8 CTAs, each tile 8 poses' primal and tangent rows), then at grid point j

      k_x  = a1[j]*xs + a2[j]*out
      k_lp = a1[j]*sum(e^2) + a2[j]*sum(dout*e)

  (``likelihood.get_div_fn``'s estimator element for element: the
  ``a1*sum(e^2)`` term is the identity part of the Jacobian) and the RK4
  bookkeeping of ``fused_ode.py`` for ``x`` and for ``delta_logp`` [B].

The grid, time rows and the table ``coefs [2*n_steps + 1, 8]`` are
``fused_ode.build_rk4_operands``'s, from eps to T. ``prior_logp`` and the
bits/dim are finished in PyTorch outside the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...diffusion.likelihood import bits_per_dim, draw_epsilon
from ...diffusion.sde import SDE
from . import build
from .fused_em import resolve_device
from .graph_loop import GraphLoop, resolve_loop
from .fused_ode import (DENOISE, STAGE_GRID, build_rk4_operands, check_head_rk4_operands,
                        rk4_stage)
from .score_net import (_check, dense_gn_silu_jvp, dense_gn_silu_jvp_plain_into,
                        hidden_jvp_buffers, network_hidden_jvp)


# ---------------------------------------------------------------------------
# K9 head_rk4_jvp
# ---------------------------------------------------------------------------

def head_rk4_jvp_plain(h, dh, w_post, b_post, coefs, j, stage, x, xs, acc, eps, lp, lacc):
    """Plain K9: returns ``(x, xs, acc, lp, lacc)`` after the stage."""
    D = x.shape[1]
    wf = w_post.float()
    out = (h.to(torch.bfloat16).float() @ wf + b_post)[:, :D]
    dout = (dh.to(torch.bfloat16).float() @ wf)[:, :D]
    cf = coefs[j]
    kl = cf[0] * (eps * eps).sum(dim=1) + cf[1] * (dout * eps).sum(dim=1)
    x, acc, xs = rk4_stage(stage, cf[2], cf[0] * xs + cf[1] * out, x, acc)
    lp, lacc, _ = rk4_stage(stage, cf[2], kl, lp, lacc)
    return x, xs, acc, lp, lacc


def head_rk4_jvp_plain_into(h, dh, w_post, b_post, coefs, j: int, stage: int, x, xs, acc,
                            eps, lp, lacc):
    """The plain version with ``head_rk4_jvp``'s signature, on any device."""
    new = head_rk4_jvp_plain(h, dh, w_post, b_post, coefs, j, stage, x, xs, acc, eps, lp,
                             lacc)
    for dst, src in zip((x, xs, acc, lp, lacc), new):
        if dst is not src:
            dst.copy_(src)


def _head_rk4_jvp_fn():
    fn = build.load("head_rk4").dposer_head_rk4_jvp
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, P, P, P, P, P, P, I, I, I, P]
        fn.restype = I
    return fn


def head_rk4_jvp(h, dh, w_post, b_post, coefs, j: int, stage: int, x, xs, acc, eps, lp,
                 lacc):
    """K9 on ``h``, ``dh`` [B, H], the hidden state and its tangent at the
    stage's state ``xs`` and grid row ``j``: RK4 stage ``stage`` (0..3) on
    ``x``, ``xs``, ``acc`` [B, D] and on ``lp``, ``lacc`` [B], all in place;
    ``eps`` [B, D] is the Hutchinson probe. The head is split over clusters
    of 8 CTAs where H is a multiple of 128 (56 CTAs at 50 rows), else of 4
    (H a multiple of 64, at most 1024), each tile 8 poses' h and dh rows."""
    B, H, D, dev = check_head_rk4_operands(
        "head_rk4_jvp", h, w_post, b_post, coefs, j, stage, DENOISE,
        (("x", x), ("xs", xs), ("acc", acc), ("eps", eps)))
    _check("dh", dh, dev, torch.float32, (B, H))
    _check("lp", lp, dev, torch.float32, (B,))
    _check("lacc", lacc, dev, torch.float32, (B,))
    if H % 64 or H > 1024:
        raise ValueError(f"head_rk4_jvp needs H a multiple of 64 and at most 1024; got H={H}")
    if dev.type == "cpu":
        return head_rk4_jvp_plain_into(h, dh, w_post, b_post, coefs, j, stage, x, xs, acc,
                                       eps, lp, lacc)
    err = _head_rk4_jvp_fn()(h.data_ptr(), dh.data_ptr(), w_post.data_ptr(),
                             b_post.data_ptr(), coefs.data_ptr(), j, stage, x.data_ptr(),
                             xs.data_ptr(), acc.data_ptr(), eps.data_ptr(), lp.data_ptr(),
                             lacc.data_ptr(), B, H, D,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"head_rk4_jvp launch failed: CUDA error {err}")
    head_rk4_jvp.launches += 1


head_rk4_jvp.launches = 0


# ---------------------------------------------------------------------------
# The likelihood
# ---------------------------------------------------------------------------

def get_cuda_likelihood_fn(sde: SDE, model, shape: Tuple[int, int], n_steps: int = 100,
                           hutchinson_type: str = "Rademacher", eps: float = 1e-5,
                           device="cuda", plain: bool = False, loop: Optional[str] = None):
    """Build the kernel likelihood for ``model`` (a ScoreModelFC).

    Returns ``likelihood_fn(generator, data [B, D], epsilon=None) -> (bpd [B],
    z [B, D], nfe)`` with the static ``nfe = 4*n_steps``, the contract of
    ``likelihood.get_likelihood_fn``; ``epsilon`` [B, D] replaces the probe
    drawn from ``generator``. Tables, operands and the loop's buffers are
    made once here; a call launches the kernels only. ``plain=True`` runs
    the same loop on the kernels' plain versions, on any device. ``loop`` is
    ``get_cuda_em_sampler``'s: on the card the integration is by default one
    CUDA graph, captured at the first call and replayed at every call (the
    probe is drawn before it and copied in); ``likelihood_fn.loops`` holds
    its ``GraphLoop``.
    """
    device = resolve_device(device)
    graph = resolve_loop(loop, device, plain) == "graph"
    batch, dim = shape
    net, coefs = build_rk4_operands(sde, model, eps, sde.T, n_steps, device)
    if net["dim"] != dim:
        raise ValueError(f"shape {shape} does not match the model's pose dim {net['dim']}")
    layer, head = ((dense_gn_silu_jvp_plain_into, head_rk4_jvp_plain_into) if plain else
                   (dense_gn_silu_jvp, head_rk4_jvp))
    # the loop's static buffers: the state (acc and lacc are written at each
    # step's first stage before they are read), the layers' buffers, the inputs
    x = torch.empty((batch, dim), dtype=torch.float32, device=device)
    xs, acc = torch.empty_like(x), torch.empty_like(x)
    lp = torch.empty((batch,), dtype=torch.float32, device=device)
    lacc = torch.empty_like(lp)
    bufs = hidden_jvp_buffers(net, batch, device)
    inputs = dict(data=torch.empty_like(x), epsilon=torch.empty_like(x))

    def body(warm_up=False):
        x.copy_(inputs["data"])
        xs.copy_(x)
        lp.zero_()
        epsilon = inputs["epsilon"]
        for i in range(1 if warm_up else n_steps):  # the warm-up: the first step's stages
            for s in range(4):
                j = 2 * i + STAGE_GRID[s]
                h, dh = network_hidden_jvp(net, xs, epsilon, j, bufs, layer)
                head(h, dh, net["w_post"], net["b_post"], coefs, j, s, x, xs, acc, epsilon,
                     lp, lacc)
        return x, lp

    runner = GraphLoop(body, inputs, graph=graph)

    @torch.no_grad()
    def likelihood_fn(generator, data, epsilon=None):
        if epsilon is None:
            epsilon = draw_epsilon(hutchinson_type, shape, generator, device)
        values = dict(data=data.to(device=device, dtype=torch.float32).contiguous(),
                      epsilon=epsilon.to(device=device, dtype=torch.float32).contiguous())
        for nm, t in values.items():
            _check(nm, t, device, torch.float32, (batch, dim))
        x, lp = runner(values)
        return bits_per_dim(sde, x, lp), x, 4 * n_steps

    likelihood_fn.loops = (runner,)
    return likelihood_fn
