"""The completion task's Adam loop on the card: CUDA kernels, the whole
loop replayed as one CUDA graph (``graph_loop.py``).

Port of ``dposer_tpu/ops/pallas/fused_comp.py``. DPoserComp optimises poses
against the DPoser one-step-denoise loss plus a masked data term. The
denoised estimate is detached, so every step is a forward-only network
evaluation plus elementwise arithmetic, and both losses are means of
per-element terms, so the gradient never couples rows. The TPU runs the whole
loop as one program with the weights resident on-core; here each step is
six launches on one stream, with no host synchronization in the loop:

- K5 ``comp_perturb``: ``pert = c_m*x + c_s*z`` (the marginal perturbation),
  at a solve's first step only;
- K1 ``dense_gn_silu`` (``score_net.py``) x (1 + 2*n_blocks): the hidden layers;
- K6 ``head_adam``: the output head fused with the one-step denoise, the
  gradient and the Adam update, ``x``, ``m1`` and ``v`` in place; before the
  last step as ``head_adam_perturb``, which then writes the next step's
  ``pert`` from the new ``x`` (K5's work at that step, bit for bit), and on
  the last step with the paste of the observed dims.

The step's scalars come from the device table ``coefs [T, 8]``: c_m, c_s, ca,
cb, cd, cp, clr, cv, with ``x0_hat = ca*pert + cb*raw``, ``cd = 2*w_data/n``
and ``cp = w_dposer*sqrt(1+snr)/n`` folding the per-iteration loss weights
(data ``100/(1+it)``, dposer ``0.1*(it+1)``) and the mean's divisor, and
``clr``, ``cv`` folding Adam's bias corrections.

Hypotheses run as extra rows: each hypothesis's mean-loss gradient is
per-element with the same 1/(B*D) divisor, so flattening is exact. Time
strategies '2' and '3' are deterministic per step and become tables; strategy
'1' (a random t per step) stays on the autograd solver.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...diffusion.fast_sampler import _corrector_tables, _labels_for
from ...diffusion.sde import SDE
from ...parallel.sharding import mesh_route, shard_builder
from ...tasks.prior import sample_quan_t
from ...utils import profiling
from . import build
from .fused_em import _check_coefs, _noise_args, draw_seed, host_slabs, resolve_device
from .graph_loop import GraphLoop, resolve_loop
from .score_net import (HEAD_COLS, _check, _ptr, build_network_operands,
                        dense_gn_silu, dense_gn_silu_plain_into, handoff_buffers,
                        network_hidden)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


# ---------------------------------------------------------------------------
# K5 comp_perturb
# ---------------------------------------------------------------------------

def comp_perturb_plain(x, coefs, step, noise):
    """Plain K5: ``c_m*x + c_s*z`` with the step's columns 0, 1 of ``coefs``,
    each operation rounded on its own (the kernels' order)."""
    return coefs[step, 0] * x + coefs[step, 1] * noise


def comp_perturb_plain_into(x, pert, coefs, step: int, *, noise=None, seed=None,
                            slab: int = 0):
    """The plain version with ``comp_perturb``'s signature, on any device; it
    takes host normals only."""
    if noise is None:
        raise ValueError("the plain comp_perturb takes host normals (noise=)")
    pert.copy_(comp_perturb_plain(x, coefs, step, noise))


def _comp_perturb_fn():
    fn = build.load("pose_elementwise").dposer_comp_perturb
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, P, P, I, I, I, P]
        fn.restype = I
    return fn


def comp_perturb(x, pert, coefs, step: int, *, noise=None, seed=None, slab: int = 0):
    """K5: write the step's perturbation of ``x`` [R, D] into ``pert``."""
    R, D = x.shape
    dev = x.device
    _check("x", x, dev, torch.float32, (R, D))
    _check("pert", pert, dev, torch.float32, (R, D))
    if pert.data_ptr() == x.data_ptr():
        raise ValueError("pert must not alias x: head_adam reads both")
    _check_coefs(coefs, step, dev)
    seed = _noise_args("comp_perturb", noise, seed, dev, (R, D))
    if dev.type == "cpu":
        return comp_perturb_plain_into(x, pert, coefs, step, noise=noise)
    if dev.type != "cuda":
        raise ValueError(f"comp_perturb runs on cpu or cuda, not {dev}")
    err = _comp_perturb_fn()(x.data_ptr(), pert.data_ptr(), coefs.data_ptr(), step,
                             _ptr(noise), _ptr(seed), slab, R, D,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"comp_perturb launch failed: CUDA error {err}")
    comp_perturb.launches += 1
    comp_perturb.programmatic += 1


comp_perturb.launches = 0
comp_perturb.programmatic = 0


# ---------------------------------------------------------------------------
# K6 head_adam
# ---------------------------------------------------------------------------

def head_adam_plain(h, w_post, b_post, coefs, step, x, pert, obs, mask, m1, v,
                    paste: bool = False):
    """Plain K6: returns ``(x_new, m1_new, v_new)``."""
    raw = (h.to(torch.bfloat16).float() @ w_post.float() + b_post)[:, :x.shape[1]]
    cf = coefs[step]
    x0_hat = cf[2] * pert + cf[3] * raw
    g = cf[4] * (mask * (x - obs)) + cf[5] * (x - x0_hat)
    m1 = ADAM_B1 * m1 + (1.0 - ADAM_B1) * g
    v = ADAM_B2 * v + (1.0 - ADAM_B2) * (g * g)
    x = x - cf[6] * m1 / (torch.sqrt(v * cf[7]) + ADAM_EPS)
    if paste:
        x = obs * mask + x * (1.0 - mask)
    return x, m1, v


def head_adam_plain_into(h, w_post, b_post, coefs, step: int, x, pert, obs, mask, m1, v,
                         paste: bool = False):
    """The plain version with ``head_adam``'s signature, on any device."""
    for dst, src in zip((x, m1, v), head_adam_plain(h, w_post, b_post, coefs, step, x,
                                                    pert, obs, mask, m1, v, paste)):
        dst.copy_(src)


def head_adam_perturb_plain_into(h, w_post, b_post, coefs, step: int, x, pert, obs, mask,
                                 m1, v, *, noise=None, seed=None, slab: int = 0):
    """The plain version with ``head_adam_perturb``'s signature, on any
    device: plain K6 at ``step``, then plain K5 at ``step + 1`` on the new
    ``x`` into ``pert`` (host normals only)."""
    head_adam_plain_into(h, w_post, b_post, coefs, step, x, pert, obs, mask, m1, v)
    comp_perturb_plain_into(x, pert, coefs, step + 1, noise=noise, seed=seed, slab=slab)


def _head_adam_fn():
    fn = build.load("head_adam").dposer_head_adam
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, P, P, P, P, P, P, I, I, I, I, P]
        fn.restype = I
    return fn


def _check_adam(name, h, w_post, b_post, coefs, step, x, pert, obs, mask, m1, v):
    """K6's operands on one CPU or CUDA device, and the kernel's limits on
    H there; returns ``(R, H, D, device)``."""
    R, H = h.shape
    D = x.shape[1]
    dev = h.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    _check("h", h, dev, torch.float32, (R, H))
    _check("w_post", w_post, dev, torch.bfloat16, (H, HEAD_COLS))
    _check("b_post", b_post, dev, torch.float32, (HEAD_COLS,))
    _check_coefs(coefs, step, dev)
    for nm, t in (("x", x), ("pert", pert), ("obs", obs), ("mask", mask), ("m1", m1),
                  ("v", v)):
        _check(nm, t, dev, torch.float32, (R, D))
    if D > HEAD_COLS:
        raise ValueError(f"pose dim {D} > {HEAD_COLS}")
    if dev.type == "cuda" and (H % 64 or H > 1024):
        raise ValueError(f"{name} kernel needs H % 64 == 0 and H <= 1024; got {H}")
    return R, H, D, dev


def head_adam(h, w_post, b_post, coefs, step: int, x, pert, obs, mask, m1, v,
              paste: bool = False, *, perturb_next=None):
    """K6 on ``h`` [R, H]: one Adam step of ``x`` [R, D] with its moments
    ``m1``, ``v``, all in place; ``paste`` then overwrites the observed dims
    of ``x`` with ``obs`` (the solver's last step).

    ``perturb_next=dict(noise=..., seed=..., slab=0)`` (``head_adam_perturb``)
    then writes step ``step + 1``'s perturbation of the new ``x`` into
    ``pert``: K5 at that step, bit for bit. It never pastes."""
    if perturb_next is not None:
        if paste:
            raise ValueError("perturb_next: the paste step (the solver's last) perturbs "
                             "no next step")
        return head_adam_perturb(h, w_post, b_post, coefs, step, x, pert, obs, mask, m1, v,
                                 **perturb_next)
    R, H, D, dev = _check_adam("head_adam", h, w_post, b_post, coefs, step, x, pert, obs,
                               mask, m1, v)
    if dev.type == "cpu":
        return head_adam_plain_into(h, w_post, b_post, coefs, step, x, pert, obs, mask,
                                    m1, v, paste)
    err = _head_adam_fn()(h.data_ptr(), w_post.data_ptr(), b_post.data_ptr(),
                          coefs.data_ptr(), step, x.data_ptr(), pert.data_ptr(),
                          obs.data_ptr(), mask.data_ptr(), m1.data_ptr(), v.data_ptr(),
                          int(paste), R, H, D, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"head_adam launch failed: CUDA error {err}")
    head_adam.launches += 1
    head_adam.programmatic += 1


head_adam.launches = 0
head_adam.programmatic = 0


def _head_adam_perturb_fn():
    fn = build.load("head_adam").dposer_head_adam_perturb
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, P, P, P, P, P, P, P, P, I, I, I, I, P]
        fn.restype = I
    return fn


def head_adam_perturb(h, w_post, b_post, coefs, step: int, x, pert, obs, mask, m1, v, *,
                      noise=None, seed=None, slab: int = 0):
    """K6's perturbing instantiation: ``head_adam(..., perturb_next=...)``,
    launched and counted on its own. After the Adam step (no paste) it
    writes ``pert`` <- ``c_m*x + c_s*z`` with row ``step + 1`` of ``coefs``
    and the host normals ``noise`` [R, D] or, with ``seed``, the in-kernel
    draw (seed, step + 1, slab): K5 at step + 1."""
    R, H, D, dev = _check_adam("head_adam_perturb", h, w_post, b_post, coefs, step, x, pert,
                               obs, mask, m1, v)
    if step + 1 >= coefs.shape[0]:
        raise ValueError(f"head_adam_perturb: step {step} is the table's last; no step "
                         f"{step + 1} to perturb for")
    if pert.data_ptr() == x.data_ptr():
        raise ValueError("pert must not alias x: the kernel reads both")
    seed = _noise_args("head_adam_perturb", noise, seed, dev, (R, D))
    if dev.type == "cpu":
        return head_adam_perturb_plain_into(h, w_post, b_post, coefs, step, x, pert, obs,
                                            mask, m1, v, noise=noise)
    err = _head_adam_perturb_fn()(h.data_ptr(), w_post.data_ptr(), b_post.data_ptr(),
                                  coefs.data_ptr(), step, x.data_ptr(), pert.data_ptr(),
                                  obs.data_ptr(), mask.data_ptr(), m1.data_ptr(),
                                  v.data_ptr(), _ptr(noise), _ptr(seed),
                                  slab, R, H, D, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"head_adam_perturb launch failed: CUDA error {err}")
    head_adam_perturb.launches += 1
    head_adam_perturb.programmatic += 1


head_adam_perturb.launches = 0
head_adam_perturb.programmatic = 0


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

@torch.no_grad()
def build_solver_operands(sde: SDE, model, n_elems: int, lr: float, iterations: int,
                          steps_per_iter: int, time_strategy: str, sample_trun: float,
                          sample_time: int, eps: float, device):
    """``(net, coefs)``: the network operands at the per-step time labels and
    the scalar table ``coefs [T, 8]`` fp32 (c_m, c_s, ca, cb, cd, cp, clr, cv)."""
    total_steps = iterations * steps_per_iter
    mdev = model.sigmas.device
    quan_t = [sample_quan_t(i, total_steps, sde.N, time_strategy, sample_trun,
                            sample_time, offset=2) for i in range(total_steps)]
    if not 0 <= min(quan_t) <= max(quan_t) < sde.N:
        raise ValueError(f"time indices {min(quan_t)}..{max(quan_t)} leave the "
                         f"{sde.N}-step grid")
    t = sde.timesteps(eps, device=mdev)[torch.as_tensor(quan_t, device=mdev)]
    net = build_network_operands(model, _labels_for(sde, t), device)

    c_m = sde.marginal_prob(torch.ones_like(t), t)[0]
    c_s = sde.marginal_prob(torch.zeros_like(t), t)[1]
    alpha, sigma = sde.return_alpha_sigma(t)
    alpha = alpha.reshape(total_steps)
    sigma2 = sigma ** 2
    # model output -> score: -1/std for VP and sub-VP, identity for VE, with
    # the model's own 1/sigma output scaling folded in
    score_scale, _ = _corrector_tables(sde, t, net["out_scale"])
    ca = 1.0 / alpha
    cb = sigma2 * score_scale / alpha
    snr = alpha / torch.sqrt(sigma2)
    it = torch.arange(total_steps, device=mdev) // steps_per_iter
    cd = 2.0 * (100.0 / (1.0 + it)) / n_elems
    cp = 0.1 * (it + 1.0) * torch.sqrt(1.0 + snr) / n_elems
    tcount = torch.arange(1, total_steps + 1, dtype=torch.float32, device=mdev)
    clr = lr / (1.0 - ADAM_B1 ** tcount)
    cv = 1.0 / (1.0 - ADAM_B2 ** tcount)
    coefs = torch.stack([c_m, c_s, ca, cb, cd, cp, clr, cv], dim=1)
    return net, coefs.float().to(device).contiguous()


def adam_step(net: dict, coefs, i: int, x, m1, v, obs, mask, scratch: dict, noise, *,
              seed=None, paste: bool = False, plain: bool = False, perturbed: bool = False,
              perturb_next: bool = False, next_noise=None) -> None:
    """Adam step ``i`` on ``x`` [R, D] and its moments in place. ``noise`` is
    the step's host normals [R, D], or None with ``seed`` for in-kernel
    normals. ``scratch`` holds ``pert`` [R, D], ``h``, ``h1`` [R, H] and ``q``
    (their bf16 copies, handed on from layer to layer).
    ``perturbed``: step ``i - 1``'s K6 already wrote this step's ``pert``,
    so K5 does not run. ``perturb_next``: K6 writes step ``i + 1``'s ``pert``
    from the new ``x`` (``head_adam_perturb``), from ``next_noise`` (host
    normals [R, D]) or ``seed``. ``plain=True`` runs the kernels' plain
    versions instead, on any device."""
    if perturb_next and paste:
        raise ValueError("the paste step (the solver's last) perturbs no next step")
    perturb, layer, head, head_next = (
        (comp_perturb_plain_into, dense_gn_silu_plain_into, head_adam_plain_into,
         head_adam_perturb_plain_into) if plain else
        (comp_perturb, dense_gn_silu, head_adam, head_adam_perturb))
    pert, h, h1 = scratch["pert"], scratch["h"], scratch["h1"]
    if not perturbed:
        perturb(x, pert, coefs, i, noise=noise, seed=seed)
    network_hidden(net, pert, i, h, h1, layer, scratch["q"])
    args = (h, net["w_post"], net["b_post"], coefs, i, x, pert, obs, mask, m1, v)
    if perturb_next:
        head_next(*args, noise=next_noise, seed=seed)
    else:
        head(*args, paste)


def solver_scratch(net: dict, rows: int, device) -> dict:
    """The buffers ``adam_step`` works in."""
    h = torch.empty((rows, net["hidden"]), dtype=torch.float32, device=device)
    return dict(h=h, h1=torch.empty_like(h), q=handoff_buffers(net, rows, device),
                pert=torch.empty((rows, net["dim"]), dtype=torch.float32, device=device))


def get_cuda_comp_solver(sde: SDE, model, shape: Tuple[int, int], n_elems: int,
                         lr: float = 0.1, iterations: int = 2,
                         steps_per_iter: int = 100, time_strategy: str = "3",
                         sample_trun: float = 5.0, sample_time: int = 900,
                         eps: float = 1e-3, rng_mode: str = "host",
                         continuous: bool = True, device="cuda", plain: bool = False,
                         loop: Optional[str] = None, mesh=None):
    """Build the kernel completion solver for ``model`` (a ScoreModelFC).

    Returns ``solve(generator, observation, mask, noise=None) -> x`` [R, D].
    ``shape`` is ``(rows, D)``, the rows hypothesis-flattened or not;
    ``n_elems`` is the per-hypothesis element count B*D that the reference's
    mean losses divide by (ref completion.py:196-201), not rows*D.

    ``rng_mode="host"`` draws each step's perturbation normals [R, D] from
    the generator, one step early and in step order (``noise=[T, R, D]``
    injects them); ``"kernel"`` draws them in K5 and K6 (card only). Tables,
    operands and the loop's buffers are made once here; a call launches the
    kernels only: K5 at the first step, K6 with the next step's perturbation
    (``head_adam_perturb``) before the last, K6 with the paste at the last.
    ``plain=True`` runs the unfused loop (K5, K1, K6 every step) on the
    kernels' plain versions (host normals only), on any device: the
    reference the fold is held to.

    ``loop`` is ``get_cuda_em_sampler``'s: by default the whole solve is one
    CUDA graph, captured at the first call and replayed at every call, on
    the card under ``rng_mode="kernel"``; ``"graph"`` under ``"host"`` needs
    ``noise=`` at every call. ``solve.loops`` holds its ``GraphLoop``.

    ``mesh`` of more than one device shards the rows (port of
    ``fused_comp.py::_sharded_comp_solver``, through
    ``sharding.shard_builder``): one single-device solver a shard at
    ``(rows // n, D)``, each with its own operands, buffers and loop; rows
    that do not divide the mesh raise. ``n_elems`` stays global: every shard
    divides its mean losses by the caller's B*D. A call splits the
    observation, the mask and the injected ``noise`` [T, R, D] by rows and
    gives each shard its folded generator; ``solve.shards`` holds the
    shards' solvers. A mesh of one device is the route above on that
    device, and then ``device`` is not read.
    """
    args = dict(locals())
    mesh, device = mesh_route(mesh, device)
    if mesh is not None:
        return shard_builder(get_cuda_comp_solver, args, mesh, ("observation", "mask", "noise"),
                             "the sharded completion solver")
    if rng_mode not in ("host", "kernel"):
        raise ValueError(f"rng_mode must be 'host' or 'kernel', got {rng_mode!r}")
    if not continuous:
        raise NotImplementedError(
            "the kernel completion solver folds the continuous-time score "
            "convention into its tables; discrete training uses backend='torch'")
    if time_strategy not in ("2", "3"):
        raise NotImplementedError(
            "the kernel completion solver supports the deterministic time "
            "strategies '2' and '3'; strategy '1' draws a random t per step: "
            "use backend='torch'")
    device = resolve_device(device)
    if rng_mode == "kernel" and (device.type != "cuda" or plain):
        raise ValueError("rng_mode='kernel' draws normals in the CUDA kernels; use "
                         "rng_mode='host' on the CPU or with plain=True")
    graph = resolve_loop(loop, device, plain, rng_mode == "kernel") == "graph"
    rows, dim = shape
    total_steps = iterations * steps_per_iter
    with profiling.setup_span("build.solver"):
        net, coefs = build_solver_operands(sde, model, n_elems, lr, iterations,
                                           steps_per_iter, time_strategy, sample_trun,
                                           sample_time, eps, device)
        if net["dim"] != dim:
            raise ValueError(f"shape {shape} does not match the model's pose dim {net['dim']}")
        fold = not plain  # K6 perturbs for the next step; K5 runs once a solve

        # the loop's static buffers: x and its moments, the scratch and the inputs
        x = torch.empty((rows, dim), dtype=torch.float32, device=device)
        m1, v = torch.empty_like(x), torch.empty_like(x)
        scratch = solver_scratch(net, rows, device)
        inputs = dict(observation=torch.empty_like(x), mask=torch.empty_like(x))
        if rng_mode == "kernel":
            inputs["seed"] = torch.zeros((1,), dtype=torch.int64, device=device)
        elif graph:
            inputs["noise"] = torch.empty((total_steps, rows, dim), dtype=torch.float32,
                                          device=device)

    def body(noise=None, generator=None, warm_up=False):
        obs, msk = inputs["observation"], inputs["mask"]
        x.copy_(obs)
        m1.zero_()
        v.zero_()
        seed = inputs.get("seed")
        steps = (host_slabs(inputs["noise"] if graph else noise, 0, total_steps, (rows, dim),
                            generator, device)
                 if rng_mode == "host" else ((None, None) for _ in range(total_steps)))
        for i, (z, z_next) in enumerate(steps):
            last = i == total_steps - 1
            if warm_up and 0 < i and not last:
                continue  # the first and the last step launch every kernel of the loop
            adam_step(net, coefs, i, x, m1, v, obs, msk, scratch, z, seed=seed, paste=last,
                      plain=plain, perturbed=fold and i > 0, perturb_next=fold and not last,
                      next_noise=z_next)
        return x

    runner = GraphLoop(body, inputs, graph=graph)

    @profiling.spanned("loop.call")
    @torch.no_grad()
    def solve(generator: Optional[torch.Generator], observation, mask, noise=None):
        values = {}
        for nm, t in (("observation", observation), ("mask", mask)):
            values[nm] = t.to(device=device, dtype=torch.float32).contiguous()
            _check(nm, values[nm], device, torch.float32, (rows, dim))
        if noise is not None:
            if rng_mode != "host":
                raise ValueError("noise= is the host-mode stream; this solver "
                                 "draws its normals in-kernel")
            _check("noise", noise, device, torch.float32, (total_steps, rows, dim))
        elif graph and rng_mode == "host":
            raise ValueError("loop='graph' under rng_mode='host' replays injected normals: "
                             "pass noise=")
        if rng_mode == "kernel":
            values["seed"] = draw_seed(generator)
        if graph:
            if noise is not None:
                values["noise"] = noise
            return runner(values)
        return runner(values, noise=noise, generator=generator)

    solve.loops = (runner,)
    return solve
