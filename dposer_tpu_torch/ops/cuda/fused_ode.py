"""The fixed-grid RK4 probability-flow-ODE sampler on the card: CUDA
kernels, the whole loop replayed as one CUDA graph (``graph_loop.py``).

Port of ``dposer_tpu/ops/pallas/fused_ode.py``. The TPU runs the whole
integration as one program with the weights resident on-core; here each of
the ``4*n_steps`` stages is six launches on one stream, with no host
synchronization inside the loop:

- K1 ``dense_gn_silu`` (``score_net.py``) x (1 + 2*n_blocks): the hidden
  layers at the stage's state ``xs`` and time row;
- K8 ``head_rk4``: the output head fused with the stage's RK4 bookkeeping, so
  the network's output and the slope ``k`` never reach device memory.

Per step i (``h = (eps - T)/n_steps``), with the drift ``a1*x + a2*fwd(x)``
(ref sde_lib.py:98-109, probability_flow=True; ``a2`` folds the model's sigma
output scaling) on the stage-time grid ``tau_j = T + j*h/2``:

    k1 at (x,            j = 2i)      k2 at (x + h/2*k1, j = 2i+1)
    k3 at (x + h/2*k2,   j = 2i+1)    k4 at (x + h*k3,   j = 2i+2)
    x <- x + h/6 * (k1 + 2*k2 + 2*k3 + k4)

``build_network_operands`` over the ``2*n_steps + 1`` stage labels gives the
time rows, and a stage reads row j; the scalars come from the device table
``coefs [2*n_steps + 1, 8]`` (a1, a2, h, cdx, cdo, 0, 0, 0) at row j. The
optional final denoise, one noise-free reverse-diffusion step at eps
(ref sampling.py:492-498), is one more forward and K8 in its denoise mode:
``x <- cdx*x + cdo*fwd(x)``. Deterministic: no noise anywhere.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...diffusion.fast_sampler import denoise_coefs, pf_ode_grid
from ...diffusion.sde import SDE
from ...parallel.sharding import mesh_route, shard_builder
from . import build
from .fused_em import resolve_device
from .graph_loop import GraphLoop, resolve_loop
from .score_net import (HEAD_COLS, _check, build_network_operands, dense_gn_silu,
                        dense_gn_silu_plain_into, network_hidden)

N_COEFS = 8
STAGE_GRID = (0, 1, 1, 2)  # a stage's offset on the stage-time grid from its step's 2i
DENOISE = 4  # K8's stage number for the final denoise


def rk4_stage(stage: int, hstep, k, x, acc):
    """One stage of the RK4 bookkeeping on a state ``x`` (the step's start)
    with its accumulator, given the slope ``k`` at the stage's state: returns
    ``(x, acc, xs)`` with ``xs`` the next stage's state. Stage 0: ``acc = k``,
    ``xs = x + h/2*k``; 1: ``acc += 2k``, the same ``xs``; 2: ``acc += 2k``,
    ``xs = x + h*k``; 3: ``x += h/6*(acc + k)``, ``xs = x``."""
    if stage == 0:
        return x, k, x + (0.5 * hstep) * k
    if stage == 1:
        return x, acc + 2.0 * k, x + (0.5 * hstep) * k
    if stage == 2:
        return x, acc + 2.0 * k, x + hstep * k
    x = x + (hstep / 6.0) * (acc + k)
    return x, acc, x


def build_rk4_operands(sde: SDE, model, t_start: float, t_end: float, n_steps: int,
                       device, denoise_eps: Optional[float] = None):
    """``(net, coefs)`` of an ``n_steps`` RK4 run of the PF-ODE from
    ``t_start`` to ``t_end``: the network operands at the ``2*n_steps + 1``
    stage times and the table ``coefs [2*n_steps + 1, 8]`` fp32 (a1, a2, h,
    cdx, cdo, 0, 0, 0); the denoise columns are 0 unless ``denoise_eps``."""
    mdev = model.sigmas.device
    _, labels, a1, a2, h = pf_ode_grid(sde, model, t_start, t_end, n_steps, mdev)
    net = build_network_operands(model, labels, device)
    coefs = torch.zeros((labels.shape[0], N_COEFS), device=mdev)
    coefs[:, 0], coefs[:, 1], coefs[:, 2] = a1, a2, h
    if denoise_eps is not None:
        coefs[:, 3], coefs[:, 4] = denoise_coefs(sde, model, denoise_eps, mdev)
    return net, coefs.float().to(device).contiguous()


# ---------------------------------------------------------------------------
# K8 head_rk4
# ---------------------------------------------------------------------------

def head_rk4_plain(h, w_post, b_post, coefs, j, stage, x, xs, acc):
    """Plain K8: returns ``(x, xs, acc)`` after the stage (the denoise
    changes ``x`` only)."""
    out = (h.to(torch.bfloat16).float() @ w_post.float() + b_post)[:, :x.shape[1]]
    cf = coefs[j]
    if stage == DENOISE:
        return cf[3] * x + cf[4] * out, xs, acc
    x, acc, xs = rk4_stage(stage, cf[2], cf[0] * xs + cf[1] * out, x, acc)
    return x, xs, acc


def head_rk4_plain_into(h, w_post, b_post, coefs, j: int, stage: int, x, xs, acc):
    """The plain version with ``head_rk4``'s signature, on any device."""
    for dst, src in zip((x, xs, acc), head_rk4_plain(h, w_post, b_post, coefs, j, stage,
                                                     x, xs, acc)):
        if dst is not src:
            dst.copy_(src)


def check_head_rk4_operands(name, h, w_post, b_post, coefs, j, stage, n_stages, state):
    """The operand checks K8 and K9 share; ``state`` are the [B, D] arrays."""
    B, H = h.shape
    dev = h.device
    D = state[0][1].shape[1]
    _check("h", h, dev, torch.float32, (B, H))
    _check("w_post", w_post, dev, torch.bfloat16, (H, HEAD_COLS))
    _check("b_post", b_post, dev, torch.float32, (HEAD_COLS,))
    if coefs.ndim != 2 or coefs.shape[1] != N_COEFS or not 0 <= j < coefs.shape[0]:
        raise ValueError(f"coefs must be [G, {N_COEFS}] with 0 <= j < G")
    _check("coefs", coefs, dev, torch.float32, coefs.shape)
    if stage not in range(n_stages):
        raise ValueError(f"{name}: stage must be in 0..{n_stages - 1}, got {stage!r}")
    for nm, t in state:
        _check(nm, t, dev, torch.float32, (B, D))
    if D > HEAD_COLS:
        raise ValueError(f"pose dim {D} > {HEAD_COLS}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if dev.type == "cuda" and (H % 64 or H > 1024):
        raise ValueError(f"{name} kernel needs H % 64 == 0 and H <= 1024; got {H}")
    return B, H, D, dev


def _head_rk4_fn():
    fn = build.load("head_rk4").dposer_head_rk4
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, P, P, P, I, I, I, P]
        fn.restype = I
    return fn


def head_rk4(h, w_post, b_post, coefs, j: int, stage: int, x, xs, acc):
    """K8 on ``h`` [B, H], the hidden state at the stage's state ``xs`` and
    grid row ``j``: RK4 stage ``stage`` (0..3) on ``x``, ``xs``, ``acc``
    [B, D] in place, or with ``stage=DENOISE`` the final denoise of ``x``."""
    B, H, D, dev = check_head_rk4_operands(
        "head_rk4", h, w_post, b_post, coefs, j, stage, DENOISE + 1,
        (("x", x), ("xs", xs), ("acc", acc)))
    if dev.type == "cpu":
        return head_rk4_plain_into(h, w_post, b_post, coefs, j, stage, x, xs, acc)
    err = _head_rk4_fn()(h.data_ptr(), w_post.data_ptr(), b_post.data_ptr(),
                         coefs.data_ptr(), j, stage, x.data_ptr(), xs.data_ptr(),
                         acc.data_ptr(), B, H, D, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"head_rk4 launch failed: CUDA error {err}")
    head_rk4.launches += 1


head_rk4.launches = 0


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

def get_cuda_ode_sampler(sde: SDE, model, shape: Tuple[int, int], n_steps: int = 125,
                         eps: float = 1e-3, denoise: bool = False, device="cuda",
                         plain: bool = False, loop: Optional[str] = None, mesh=None):
    """Build the kernel RK4 PF-ODE sampler for ``model`` (a ScoreModelFC).

    Returns ``sampler(generator=None, z=None) -> (nfe, x)`` with the static
    ``nfe = 4*n_steps``, the contract of ``sampling.get_ode_sampler`` and
    ``fast_sampler.get_fast_ode_sampler``; ``z`` [B, D] replaces the prior
    draw. Tables, operands and the loop's buffers are made once here; a call
    launches the kernels only. ``plain=True`` runs the same loop on the
    kernels' plain versions, on any device. ``loop`` is
    ``get_cuda_em_sampler``'s: on the card the integration is by default one
    CUDA graph, captured at the first call and replayed at every call (it
    draws no noise); ``sampler.loops`` holds its ``GraphLoop``.

    ``mesh`` of more than one device shards the batch (port of
    ``fused_ode.py::_sharded_ode_sampler``, through
    ``sharding.shard_builder``): one single-device sampler a shard at
    ``(B // n, D)`` with its own operands, buffers and loop (a batch that
    does not divide the mesh raises), ``z`` split by rows, each shard's
    prior drawn from its folded generator; ``sampler.shards`` holds the
    shards' samplers. A mesh of one device is the route above on that
    device, and then ``device`` is not read.
    """
    args = dict(locals())
    mesh, device = mesh_route(mesh, device)
    if mesh is not None:
        return shard_builder(get_cuda_ode_sampler, args, mesh, ("z",),
                             "the sharded RK4 PF-ODE sampler")
    device = resolve_device(device)
    graph = resolve_loop(loop, device, plain) == "graph"
    batch, dim = shape
    net, coefs = build_rk4_operands(sde, model, sde.T, eps, n_steps, device,
                                    denoise_eps=eps if denoise else None)
    if net["dim"] != dim:
        raise ValueError(f"shape {shape} does not match the model's pose dim {net['dim']}")
    layer, head = ((dense_gn_silu_plain_into, head_rk4_plain_into) if plain else
                   (dense_gn_silu, head_rk4))
    stages = [(2 * i + STAGE_GRID[s], s) for i in range(n_steps) for s in range(4)]
    if denoise:
        stages.append((2 * n_steps, DENOISE))
    # the loop's static buffers: the state (acc is written at each step's first
    # stage before it is read), the hidden activations and the input
    x = torch.empty((batch, dim), dtype=torch.float32, device=device)
    xs, acc = torch.empty_like(x), torch.empty_like(x)
    h = torch.empty((batch, net["hidden"]), dtype=torch.float32, device=device)
    h1 = torch.empty_like(h)
    inputs = dict(z=torch.empty_like(x))

    def body(warm_up=False):
        x.copy_(inputs["z"])
        xs.copy_(x)
        # the warm-up: the first step's stages and the last stage (the denoise)
        for j, s in (stages[:4] + stages[-1:] if warm_up else stages):
            network_hidden(net, xs, j, h, h1, layer)
            head(h, net["w_post"], net["b_post"], coefs, j, s, x, xs, acc)
        return x

    runner = GraphLoop(body, inputs, graph=graph)

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, z=None):
        if z is None:
            z = sde.prior_sampling(shape, generator, device)
        z = z.to(device=device, dtype=torch.float32).contiguous()
        _check("z", z, device, torch.float32, (batch, dim))
        return 4 * n_steps, runner(dict(z=z))

    sampler.loops = (runner,)
    return sampler
