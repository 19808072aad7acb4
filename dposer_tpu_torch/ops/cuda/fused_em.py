"""The reverse-diffusion loop on the card: CUDA kernels, the whole loop
replayed as one CUDA graph.

Port of ``dposer_tpu/ops/pallas/fused_em.py``. The TPU runs the whole
N-step loop as one program with ~8.3 MB of bf16 weights resident on-core.
An H100 SM has 227 KB of shared memory, so here each step is a short
sequence of launches on one stream, with no host synchronization inside
the loop (the weights stay in the 50 MB L2), and the host submits the loop
once: on the card it is captured into a CUDA graph at the first call and
replayed at every call (``graph_loop.py``), as the TPU program runs its loop
inside one ``pallas_call``:

- K1 ``dense_gn_silu`` (``score_net.py``) x (1 + 2*n_blocks): the hidden layers,
  or K13 ``dense_gn_silu_int8`` in the int8 serving mode (``quant="int8"``);
- K2 ``head_em``: the output head fused with the EM update, or, for the
  corrector, with the score and its row norms (split-K over a cluster of 4
  CTAs a 16-row tile; the head padded to 64 columns, or to 128 for a pose of
  65-128 dims, rot6d's 126); with ``imputation=True`` its imputation instantiation
  (``head_em_impute``) also runs the masked re-noise of the observed dims
  after the update and, where no corrector follows, the next step's before
  its predictor;
- K3 ``langevin_update``: the corrector's batch-mean norms and update (one
  cluster of 16 CTAs);
- K4 ``masked_renoise``: the masked re-noise where no K2 comes before it:
  at a call's first step and after the corrector.

Per step: ``[corrector: fwd -> K2(score) -> K3] * S``, then ``[K4] -> fwd ->
K2(EM[+re-noise])``. With imputation and no corrector a call launches K4
once, at its first step; with the corrector, once a step. The step's scalars
come from the device table ``coefs [N, 8]`` (cx, cout, cnoise, score_scale,
alpha, imputation mean, imputation std, 0), read by the kernels at the step
index.

Noise: ``rng_mode="host"`` takes ``[N, K, B, D]`` slabs in the order
corr_0..corr_{S-1}, imput_c, predictor, imput_p (injected with ``noise=``,
else drawn from the generator a step at a time, one step ahead where K2
re-noises for the next step); ``rng_mode="kernel"`` draws Philox normals
inside K2, K3 and K4 (card only), keyed by (seed, step, slab, row, column)
with the slab's index in that order (their plain versions are in
``philox.py``), whichever kernel draws them. Each kernel's plain PyTorch
version is here or in ``score_net.py``; a wrapper given CPU tensors runs it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ...diffusion.fast_sampler import (_corrector_tables, _imputation_tables,
                                       _labels_for, _pred_tables,
                                       check_imputation_args)
from ...diffusion.sde import SDE
from ...models import ScoreModelFC
from ...parallel.sharding import mesh_route, shard_builder
from ...utils import profiling
from . import build
from .graph_loop import GraphLoop, resolve_loop
from .philox import seed_bits
from .score_net import (HEAD_COLS, WIDE_HEAD_COLS, _check, _ptr, build_network_operands,
                        dense_gn_silu, dense_gn_silu_int8, dense_gn_silu_jvp,
                        handoff_buffers, head_cols, hidden_layer, network_hidden)

N_COEFS = 8


# ---------------------------------------------------------------------------
# K2 head_em
# ---------------------------------------------------------------------------

def _head_out(h, w_post, b_post, dim):
    return (h.to(torch.bfloat16).float() @ w_post.float() + b_post)[:, :dim]


def head_em_plain(h, w_post, b_post, coefs, step, mode, dim, x=None, noise=None):
    """Plain K2. ``mode="em"``: returns ``(x_new, x_mean)`` from ``x`` and
    the step's normals ``noise`` [B, D]; ``mode="score"``: returns
    ``(score, score_sq)``."""
    out = _head_out(h, w_post, b_post, dim)
    cf = coefs[step]
    if mode == "em":
        x_mean = cf[0] * x + cf[1] * out
        return x_mean + cf[2] * noise, x_mean
    score = cf[3] * out
    return score, (score * score).sum(dim=1)


def head_em_plain_into(h, w_post, b_post, coefs, step: int, mode: str, *, x=None,
                       x_mean=None, score=None, score_sq=None, noise=None, seed=None,
                       slab: int = 0, observed=None, renoise_noise=None,
                       renoise_next=None):
    """The plain version with ``head_em``'s signature, on any device; it
    takes host normals only. With ``observed`` it is the EM update followed
    by ``masked_renoise_plain`` at ``step`` and, with ``renoise_next``, at
    ``step + 1``: the same operations in the same order as K2 then K4
    then K4."""
    if mode == "em":
        if noise is None:
            raise ValueError("the plain head_em takes host normals (noise=)")
        x_new, xm = head_em_plain(h, w_post, b_post, coefs, step, mode, x.shape[1],
                                  x=x, noise=noise)
        if x_mean is not None:
            x_mean.copy_(xm)
        if observed is not None:
            passes = 1 if renoise_next is None else 2
            if renoise_noise is None or len(renoise_noise) != passes:
                raise ValueError(f"the plain head_em takes the re-noise's host normals: "
                                 f"renoise_noise must hold {passes} slab(s)")
            for p in range(passes):
                x_new = masked_renoise_plain(x_new, *observed, coefs, step + p,
                                             renoise_noise[p])
        x.copy_(x_new)
    else:
        s, sq = head_em_plain(h, w_post, b_post, coefs, step, mode, score.shape[1])
        score.copy_(s)
        score_sq.copy_(sq)


def _head_em_fn():
    fn = build.load("head_em").dposer_head_em
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, P, P, P, P, P, P, I, I, I, I, P]
        fn.restype = I
    return fn


def _check_coefs(coefs, step, dev):
    if coefs.ndim != 2 or coefs.shape[1] != N_COEFS or not 0 <= step < coefs.shape[0]:
        raise ValueError(f"coefs must be [N, {N_COEFS}] with 0 <= step < N")
    _check("coefs", coefs, dev, torch.float32, coefs.shape)


def seed_tensor(seed, device) -> torch.Tensor:
    """``seed`` as the kernels read it: a one-element int64 tensor on
    ``device`` holding the seed's 64 bits (the kernels load it from device
    memory, so a captured graph draws with whatever seed a replay finds
    there). An int is written into a new one on the current stream; a tensor
    must be one already."""
    if isinstance(seed, torch.Tensor):
        _check("seed", seed, device, torch.int64, (1,))
        return seed
    bits = seed_bits(seed)
    return torch.full((1,), bits - 2 ** 64 if bits >= 2 ** 63 else bits, dtype=torch.int64,
                      device=device)


def _noise_args(name, noise, seed, dev, shape):
    """Check the normals' source: exactly one of the host normals ``noise``
    and the in-kernel seed ``seed`` (an int or a one-element int64 tensor,
    CUDA only). Returns the seed tensor, or None."""
    if (noise is None) == (seed is None):
        raise ValueError(f"{name}: pass exactly one of noise= (host normals) "
                         f"or seed= (in-kernel normals)")
    if noise is not None:
        _check("noise", noise, dev, torch.float32, shape)
        return None
    if dev.type != "cuda":
        raise ValueError(f"{name}: in-kernel normals (seed=) need CUDA tensors")
    return seed_tensor(seed, dev)


def _check_head(h, w_post, b_post, D: int):
    """The output head's operands for a pose of ``D`` dims: h [B, H] fp32,
    w_post [H, P] bf16, b_post [P] fp32 with ``P = head_cols(D)`` (64, or 128
    for 65-128 dims), on one device. Returns ``(B, H, device, route)``, the
    route K2 takes: ``"head64"`` or ``"head128"``, its wide tile."""
    B, H = h.shape
    dev = h.device
    cols = head_cols(D)
    _check("h", h, dev, torch.float32, (B, H))
    _check("w_post", w_post, dev, torch.bfloat16, (H, cols))
    _check("b_post", b_post, dev, torch.float32, (cols,))
    return B, H, dev, f"head{cols}"


def head_em(h, w_post, b_post, coefs, step: int, mode: str, *, x=None,
            x_mean=None, score=None, score_sq=None, noise=None, seed=None,
            slab: int = 0, observed=None, renoise_noise=None, renoise_next=None):
    """K2 on ``h`` [B, H]. ``mode="em"`` updates ``x`` [B, D] in place (and
    writes ``x_mean`` when given); ``mode="score"`` writes ``score`` [B, D]
    and ``score_sq`` [B]. A pose of at most 64 dims takes the head padded to
    64 columns, one of 65-128 (rot6d's 126) K2's 128-column tile; each launch
    adds one to its route's count in ``routes`` (``"head64"``, ``"head128"``).

    ``observed=(obs, mask)`` (EM mode; ``head_em_impute``) follows the update
    with the masked re-noise of ``step`` from slab ``slab + 1`` and, with
    ``renoise_next=s``, that of ``step + 1`` from slab ``s`` (its re-noise
    before its predictor): K4 at those steps and slabs, bit for bit.
    ``renoise_noise`` holds their host normals (one [B, D] slab a re-noise)
    when ``noise`` is given; ``x_mean`` is the state before them."""
    if observed is not None:
        if mode != "em":
            raise ValueError("observed= re-noises after the EM update (mode='em')")
        return head_em_impute(h, w_post, b_post, coefs, step, x=x, observed=observed,
                              x_mean=x_mean, noise=noise, seed=seed, slab=slab,
                              renoise_noise=renoise_noise, renoise_next=renoise_next)
    if mode not in ("em", "score"):
        raise ValueError(f"mode must be 'em' or 'score', got {mode!r}")
    D = (x if mode == "em" else score).shape[1]
    B, H, dev, route = _check_head(h, w_post, b_post, D)
    _check_coefs(coefs, step, dev)
    if mode == "em":
        _check("x", x, dev, torch.float32, (B, D))
        if x_mean is not None:
            _check("x_mean", x_mean, dev, torch.float32, (B, D))
        seed = _noise_args("head_em", noise, seed, dev, (B, D))
    else:
        _check("score", score, dev, torch.float32, (B, D))
        _check("score_sq", score_sq, dev, torch.float32, (B,))
    if dev.type == "cpu":
        return head_em_plain_into(h, w_post, b_post, coefs, step, mode, x=x,
                                  x_mean=x_mean, score=score, score_sq=score_sq,
                                  noise=noise)
    if dev.type != "cuda":
        raise ValueError(f"head_em runs on cpu or cuda, not {dev}")
    if H % 64 or H > 1024:
        raise ValueError(f"head_em kernel needs H % 64 == 0 and H <= 1024; got {H}")
    err = _head_em_fn()(h.data_ptr(), w_post.data_ptr(), b_post.data_ptr(),
                        coefs.data_ptr(), step, 0 if mode == "em" else 1,
                        _ptr(x), _ptr(x_mean), _ptr(score), _ptr(score_sq),
                        _ptr(noise), _ptr(seed), slab, B, H, D,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"head_em launch failed: CUDA error {err}")
    head_em.launches += 1
    head_em.programmatic += 1
    head_em.routes[route] += 1


head_em.launches = 0
head_em.programmatic = 0
head_em.routes = {"head64": 0, "head128": 0}


def _head_em_impute_fn():
    fn = build.load("head_em").dposer_head_em_impute
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, P, P, P, P, I, P, P, P, I, P, I, I, I, I, I, P]
        fn.restype = I
    return fn


def head_em_impute(h, w_post, b_post, coefs, step: int, *, x, observed, x_mean=None,
                   noise=None, seed=None, slab: int = 0, renoise_noise=None,
                   renoise_next=None):
    """K2's imputation instantiation: ``head_em(..., "em", observed=...)``,
    launched and counted on its own (its routes as ``head_em``'s)."""
    D = x.shape[1]
    B, H, dev, route = _check_head(h, w_post, b_post, D)
    passes = 1 if renoise_next is None else 2
    _check_coefs(coefs, step + passes - 1, dev)
    for nm, t in (("x", x), ("obs", observed[0]), ("mask", observed[1])):
        _check(nm, t, dev, torch.float32, (B, D))
    if x_mean is not None:
        _check("x_mean", x_mean, dev, torch.float32, (B, D))
    seed = _noise_args("head_em", noise, seed, dev, (B, D))
    if noise is not None:
        if renoise_noise is None or len(renoise_noise) != passes:
            raise ValueError(f"host normals: renoise_noise must hold {passes} slab(s)")
        for z in renoise_noise:
            _check("renoise_noise", z, dev, torch.float32, (B, D))
    elif renoise_noise is not None and any(z is not None for z in renoise_noise):
        raise ValueError("in-kernel normals (seed=) draw the re-noise too: no renoise_noise")
    if dev.type == "cpu":
        return head_em_plain_into(h, w_post, b_post, coefs, step, "em", x=x, x_mean=x_mean,
                                  noise=noise, observed=observed, renoise_noise=renoise_noise,
                                  renoise_next=renoise_next)
    if dev.type != "cuda":
        raise ValueError(f"head_em runs on cpu or cuda, not {dev}")
    if H % 64 or H > 1024:
        raise ValueError(f"head_em kernel needs H % 64 == 0 and H <= 1024; got {H}")
    zs = tuple(renoise_noise) if noise is not None else (None, None)
    err = _head_em_impute_fn()(h.data_ptr(), w_post.data_ptr(), b_post.data_ptr(),
                               coefs.data_ptr(), step, x.data_ptr(), _ptr(x_mean),
                               _ptr(noise), _ptr(seed), slab,
                               observed[0].data_ptr(), observed[1].data_ptr(), _ptr(zs[0]),
                               slab + 1, _ptr(zs[1]) if passes == 2 else None, renoise_next or 0,
                               passes, B, H, D,
                               torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"head_em (imputation) launch failed: CUDA error {err}")
    head_em_impute.launches += 1
    head_em_impute.programmatic += 1
    head_em_impute.routes[route] += 1


head_em_impute.launches = 0
head_em_impute.programmatic = 0
head_em_impute.routes = {"head64": 0, "head128": 0}


# ---------------------------------------------------------------------------
# K3 langevin_update
# ---------------------------------------------------------------------------

def langevin_update_plain(x, score, score_sq, coefs, step, snr, noise):
    """Plain K3: returns ``(x_new, step_size)``."""
    grad_norm = torch.sqrt(score_sq).mean()
    noise_norm = torch.sqrt((noise * noise).sum(dim=1)).mean()
    step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * coefs[step, 4]
    return x + step_size * score + torch.sqrt(step_size * 2) * noise, step_size


def langevin_update_plain_into(x, score, score_sq, coefs, step: int, snr: float, *,
                               noise=None, seed=None, slab: int = 0, step_out=None):
    """The plain version with ``langevin_update``'s signature, on any
    device; it takes host normals only."""
    if noise is None:
        raise ValueError("the plain langevin_update takes host normals (noise=)")
    x_new, st = langevin_update_plain(x, score, score_sq, coefs, step, snr, noise)
    x.copy_(x_new)
    if step_out is not None:
        step_out.copy_(st.reshape(1))


def _langevin_fn():
    fn = build.load("langevin_update").dposer_langevin_update
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, ctypes.c_float, P, P, I, P, I, I, P]
        fn.restype = I
    return fn


def langevin_update(x, score, score_sq, coefs, step: int, snr: float, *,
                    noise=None, seed=None, slab: int = 0, step_out=None):
    """K3: one langevin step on ``x`` [B, D] in place; ``step_out`` [1]
    receives the step size when given."""
    B, D = x.shape
    dev = x.device
    _check("x", x, dev, torch.float32, (B, D))
    _check("score", score, dev, torch.float32, (B, D))
    _check("score_sq", score_sq, dev, torch.float32, (B,))
    _check_coefs(coefs, step, dev)
    if step_out is not None:
        _check("step_out", step_out, dev, torch.float32, (1,))
    seed = _noise_args("langevin_update", noise, seed, dev, (B, D))
    if dev.type == "cpu":
        return langevin_update_plain_into(x, score, score_sq, coefs, step, snr,
                                          noise=noise, step_out=step_out)
    if dev.type != "cuda":
        raise ValueError(f"langevin_update runs on cpu or cuda, not {dev}")
    if B > 12288:
        raise ValueError(f"langevin_update kernel takes at most 12288 rows: batch {B}")
    err = _langevin_fn()(x.data_ptr(), score.data_ptr(), score_sq.data_ptr(),
                         coefs.data_ptr(), step, float(snr), _ptr(noise),
                         _ptr(seed), slab, _ptr(step_out), B, D,
                         torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"langevin_update launch failed: CUDA error {err}")
    langevin_update.launches += 1


langevin_update.launches = 0


# ---------------------------------------------------------------------------
# K4 masked_renoise
# ---------------------------------------------------------------------------

def masked_renoise_plain(x, obs, mask, coefs, step, noise):
    """Plain K4: ``x*(1-m) + (mc*obs + sd*z)*m`` with the step's imputation
    mean coefficient and std (columns 5, 6 of ``coefs``)."""
    cf = coefs[step]
    return x * (1.0 - mask) + (cf[5] * obs + cf[6] * noise) * mask


def masked_renoise_plain_into(x, obs, mask, coefs, step: int, *, noise=None, seed=None,
                              slab: int = 0):
    """The plain version with ``masked_renoise``'s signature, on any device;
    it takes host normals only."""
    if noise is None:
        raise ValueError("the plain masked_renoise takes host normals (noise=)")
    x.copy_(masked_renoise_plain(x, obs, mask, coefs, step, noise))


def _masked_renoise_fn():
    fn = build.load("pose_elementwise").dposer_masked_renoise
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, P, P, I, I, I, P]
        fn.restype = I
    return fn


def masked_renoise(x, obs, mask, coefs, step: int, *, noise=None, seed=None,
                   slab: int = 0):
    """K4: overwrite the observed dims (``mask == 1``) of ``x`` [R, D] in
    place with ``obs`` re-noised to the step's time."""
    R, D = x.shape
    dev = x.device
    for nm, t in (("x", x), ("obs", obs), ("mask", mask)):
        _check(nm, t, dev, torch.float32, (R, D))
    _check_coefs(coefs, step, dev)
    seed = _noise_args("masked_renoise", noise, seed, dev, (R, D))
    if dev.type == "cpu":
        return masked_renoise_plain_into(x, obs, mask, coefs, step, noise=noise)
    if dev.type != "cuda":
        raise ValueError(f"masked_renoise runs on cpu or cuda, not {dev}")
    err = _masked_renoise_fn()(x.data_ptr(), obs.data_ptr(), mask.data_ptr(),
                               coefs.data_ptr(), step, _ptr(noise),
                               _ptr(seed), slab, R, D,
                               torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"masked_renoise launch failed: CUDA error {err}")
    masked_renoise.launches += 1


masked_renoise.launches = 0


def _counted():
    from .chain_link import chain_link
    from .fused_comp import comp_perturb, head_adam, head_adam_perturb  # they import this module
    from .fused_lik import head_rk4_jvp
    from .fused_ode import head_rk4
    from .fused_train import dense_gn_silu_bwd, dense_gn_silu_train, head_dsm

    return (dense_gn_silu, head_em, head_em_impute, langevin_update, masked_renoise,
            comp_perturb, head_adam, head_adam_perturb, dense_gn_silu_jvp, head_rk4,
            head_rk4_jvp, dense_gn_silu_train, head_dsm, dense_gn_silu_bwd, dense_gn_silu_int8,
            chain_link)


def launch_counts() -> dict:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {fn.__name__: fn.launches for fn in _counted()}


def route_counts() -> dict:
    """Launches of each kernel with more than one route (a Hopper main loop,
    or a head width), by route, since the last ``reset_launch_counts``: K1
    ``{"wgmma_bf16": n, "pre_wgmma": n, "pre_wgmma2": n}`` (from the bf16
    copy, from fp32 A at K <= 64 over one K-tile, at 64 < K <= 128 over two),
    K2 and its imputation instantiation ``{"head64": n, "head128": n}`` (the
    head padded to 64 columns, to 128), K7 and K10 ``{"wgmma": n,
    "register": n}``, K12 ``{"wgmma": n}`` (its one route), K13
    ``{"wgmma_int8": n, "pre_wgmma8": n, "register": n}`` (from the int8
    copy, from fp32 A at K <= 64, from fp32 A beyond: a forward is 4/1/0),
    K14 ``{"wgmma_int8": n, "register": n}`` and ``"wgmma"``, its bf16
    modes."""
    return {fn.__name__: dict(fn.routes) for fn in _counted() if hasattr(fn, "routes")}


def programmatic_counts() -> dict:
    """Launches of each programmatically launched kernel since the last
    ``reset_launch_counts``: the kernels of the sampling chains (K1, K2, K5,
    K6, K13), whose every launch sets programmatic stream serialization, so
    each starts its prologue under the tail of the launch before it
    (``csrc/mbarrier.cuh``)."""
    return {fn.__name__: fn.programmatic for fn in _counted() if hasattr(fn, "programmatic")}


def scope_refused_counts() -> dict:
    """The kernels' scope checks' refusals since the last
    ``reset_launch_counts``, by reason (``in_kernel_scope``'s and
    ``narrow_head_scope``'s)."""
    return dict(SCOPE_REFUSED)


def reset_launch_counts() -> None:
    for fn in _counted():
        fn.launches = 0
        if hasattr(fn, "programmatic"):
            fn.programmatic = 0
        for route in getattr(fn, "routes", ()):
            fn.routes[route] = 0
    for reason in SCOPE_REFUSED:
        SCOPE_REFUSED[reason] = 0


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

@torch.no_grad()
def build_sampler_operands(sde: SDE, model, eps: float, predictor: str, device,
                           tables_override=None, probability_flow: bool = False,
                           quant=None, act_amax=None):
    """``(net, coefs)`` for the kernels: the network operands of
    ``build_network_operands`` and the per-step scalar table ``coefs [N, 8]``
    fp32 (cx, cout, cnoise, score_scale, alpha, imputation mean, imputation
    std, 0), with the model's ``1/sigma`` output scale folded into cout and
    score_scale. ``tables_override=(timesteps, cx, cout, cnoise)`` replaces
    the predictor's rows (and the step count) with caller-built ones whose
    ``cout`` already folds that scale. ``probability_flow`` makes the
    predictor's rows the deterministic PF-ODE step (``cnoise`` 0). ``quant``
    and ``act_amax`` go to ``build_network_operands``."""
    mdev = model.sigmas.device
    if tables_override is None:
        timesteps = sde.timesteps(eps, device=mdev)
        cx, cout, cnoise = _pred_tables(sde, timesteps, predictor, probability_flow)
    else:
        timesteps, cx, cout, cnoise = (t.to(mdev) for t in tables_override)
    net = build_network_operands(model, _labels_for(sde, timesteps), device, quant=quant,
                                 act_amax=act_amax)
    out_scale = net["out_scale"]
    score_scale, alpha = _corrector_tables(sde, timesteps, out_scale)
    imput_mc, imput_std = _imputation_tables(sde, timesteps)
    if out_scale is not None and tables_override is None:
        cout = cout * out_scale
    coefs = torch.stack([cx, cout, cnoise, score_scale, alpha, imput_mc,
                         imput_std, torch.zeros_like(cx)], dim=1)
    return net, coefs.float().to(device).contiguous()


@torch.no_grad()
def load_operands_(dst, src) -> None:
    """Copy the operands ``src`` into ``dst`` in place, tensor by tensor
    (``(net, coefs)`` of ``build_sampler_operands``, or any dict, list or
    tensor of them): the addresses a captured graph and K1's tensor-map
    cache hold stay valid. Entries that are not tensors (sizes) must
    agree."""
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"operand {tuple(src.shape)} {src.dtype} does not fit "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            load_operands_(v, src[k])
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError(f"{len(src)} operands do not fit {len(dst)}")
        for d, t in zip(dst, src):
            load_operands_(d, t)
    elif dst != src and not (dst is None and src is None):
        raise ValueError(f"operand {src!r} does not match {dst!r}")


def pc_step(net: dict, coefs, i: int, x, scratch: dict, slabs, *, n_corr: int,
            snr: float, seed=None, x_mean=None, observed=None, renoised: bool = False,
            renoise_next: bool = False, next_slabs=None, plain: bool = False) -> None:
    """Reverse step ``i`` on ``x`` [B, D] in place: ``n_corr`` langevin
    corrector steps, then the EM update (``x_mean``, when given, receives the
    denoised state, before any imputation). ``observed=(obs, mask)`` wraps the
    EM update in the masked re-noise of the observed dims: before it K4
    (unless ``renoised``: step ``i - 1``'s K2 did it), after it K2's
    imputation epilogue, which with ``renoise_next`` (no corrector) also runs
    step ``i + 1``'s re-noise before its predictor, from ``next_slabs``; that
    step then runs with ``renoised``. ``slabs[k]`` are the host normals of
    slab ``k`` (corr_0.., [imput_c], em, [imput_p]), or None with ``seed``
    for in-kernel normals. ``scratch`` holds ``h``, ``h1``
    [B, H], ``q`` (their bf16 or int8 copies, handed on from layer to layer)
    and, with a corrector, ``score`` [B, D] and ``score_sq`` [B].
    ``plain=True`` runs the kernels' plain versions instead, on any device:
    the reference the card's kernels are held to. The hidden layers are K1,
    or K13 for int8 operands (the plain versions hand on the same copies)."""
    if renoise_next and (observed is None or n_corr):
        raise ValueError("renoise_next folds the next step's re-noise into K2: "
                         "imputation without a corrector only")
    layer = hidden_layer(net, plain)
    head, langevin, renoise = (
        (head_em_plain_into, langevin_update_plain_into, masked_renoise_plain_into) if plain
        else (head_em, langevin_update, masked_renoise))
    h, h1, q = scratch["h"], scratch["h1"], scratch["q"]
    for j in range(n_corr):
        network_hidden(net, x, i, h, h1, layer, q)
        head(h, net["w_post"], net["b_post"], coefs, i, "score",
             score=scratch["score"], score_sq=scratch["score_sq"])
        langevin(x, scratch["score"], scratch["score_sq"], coefs, i, snr,
                 noise=slabs[j], seed=seed, slab=j)
    k = n_corr
    impute = {}
    if observed is not None:
        if not renoised:
            renoise(x, *observed, coefs, i, noise=slabs[k], seed=seed, slab=k)
        k += 1
        zs = None  # in-kernel normals: K2 draws the re-noise's too
        if seed is None:
            zs = (slabs[k + 1],) + ((next_slabs[n_corr],) if renoise_next else ())
        impute = dict(observed=observed, renoise_noise=zs,
                      renoise_next=n_corr if renoise_next else None)
    network_hidden(net, x, i, h, h1, layer, q)
    head(h, net["w_post"], net["b_post"], coefs, i, "em", x=x, x_mean=x_mean,
         noise=slabs[k], seed=seed, slab=k, **impute)


def pc_scratch(net: dict, batch: int, n_corr: int, device) -> dict:
    """The buffers ``pc_step`` works in."""
    h = torch.empty((batch, net["hidden"]), dtype=torch.float32, device=device)
    out = dict(h=h, h1=torch.empty_like(h), q=handoff_buffers(net, batch, device))
    if n_corr:
        out["score"] = torch.empty((batch, net["dim"]), dtype=torch.float32, device=device)
        out["score_sq"] = torch.empty((batch,), dtype=torch.float32, device=device)
    return out


def host_slabs(noise, lo: int, hi: int, shape, generator, device):
    """Steps ``lo..hi-1``'s host normals: yields ``(slabs, next_slabs)``, the
    [K, B, D] slabs of step i (``noise[i - lo]`` when injected, else one
    ``torch.randn`` a step from ``generator``) and step i + 1's (None past
    ``hi``), drawn one step early for K2's re-noise of step i + 1. The
    generator still draws the steps in their order, one at a time."""
    def draw(i):
        if noise is not None:
            return noise[i - lo]
        return torch.randn(tuple(shape), generator=generator, device=device)

    nxt = draw(lo)
    for i in range(lo, hi):
        slabs, nxt = nxt, (draw(i + 1) if i + 1 < hi else None)
        yield slabs, nxt


def resolve_device(device) -> torch.device:
    """``device`` as tensors report it: "cuda" becomes the current "cuda:N"
    (the wrappers compare devices exactly)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def draw_seed(generator: Optional[torch.Generator]) -> torch.Tensor:
    """The Philox seed of one call's in-kernel normals, from ``generator``:
    a one-element int64 tensor on the generator's device (no host
    synchronisation), which the call copies into its seed buffer."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device if generator is not None else "cpu")


KERNEL_PREDICTORS = ("euler_maruyama", "reverse_diffusion")
# The routes whose head kernel is 64 columns wide (their pre layers too take
# K <= 64 alone): the completion solver (K6), the RK4 PF-ODE sampler (K8),
# the likelihood (K7's pre layer, K9) and the train step (K10's pre layer,
# K11). A pose of more dims (rot6d's 126) is refused there.
NARROW_HEAD_ROUTES = ("solver", "ode", "likelihood", "train")
# Refusals of the scope checks by reason: the sampler's predictor, its
# corrector, the model, a pose wider than any head, and a pose wider than a
# narrow route's head (``wide_pose_<route>``).
SCOPE_REFUSED = dict.fromkeys(("predictor", "corrector", "model", "pose_dim")
                              + tuple(f"wide_pose_{r}" for r in NARROW_HEAD_ROUTES), 0)


def _refused(reason: str) -> bool:
    SCOPE_REFUSED[reason] += 1
    return False


def in_kernel_scope(sampling, model, corrector=None) -> bool:
    """Whether the kernel sampler runs the pc sampler of ``sampling`` (a
    config's ``sampling`` block): an Euler-Maruyama or reverse-diffusion
    predictor, a none or langevin corrector (``corrector`` in place of the
    block's), and a ScoreModelFC with the positional time embedding and a
    pose of at most 128 dims (K2's wide tile; the denoise is K2's x_mean).
    A refusal is counted by its reason (``scope_refused_counts``)."""
    if sampling.predictor not in KERNEL_PREDICTORS:
        return _refused("predictor")
    if (corrector or sampling.corrector) not in ("none", "langevin"):
        return _refused("corrector")
    if not isinstance(model, ScoreModelFC) or model.embedding_type != "positional":
        return _refused("model")
    if model.n_poses * model.pose_dim > WIDE_HEAD_COLS:
        return _refused("pose_dim")
    return True


def narrow_head_scope(model, route: str) -> bool:
    """Whether the kernels of ``route`` (``NARROW_HEAD_ROUTES``: their head
    tile 64 columns wide) take ``model``'s pose: at most 64 dims. A wider
    pose (rot6d's 126) is refused and counted as ``wide_pose_<route>``: the
    caller chooses the plain path where the request is made (the demo's, the
    completion CLI's, ``--train-kernel auto``); a kernel builder handed such
    a model fails its head's operand checks."""
    if route not in NARROW_HEAD_ROUTES:
        raise ValueError(f"route must be one of {NARROW_HEAD_ROUTES}, got {route!r}")
    if model.n_poses * model.pose_dim <= HEAD_COLS:
        return True
    return _refused(f"wide_pose_{route}")



def get_cuda_em_sampler(sde: SDE, model, shape: Tuple[int, int], eps: float = 1e-3,
                        denoise: bool = True, rng_mode: str = "host",
                        corrector: str = "none", snr: float = 0.16,
                        n_corrector_steps: int = 1, imputation: bool = False,
                        predictor: str = "euler_maruyama",
                        probability_flow: bool = False,
                        step_range: Optional[Tuple[int, int]] = None,
                        quant: Optional[str] = None, act_amax=None,
                        bf16_tail_steps: int = 0,
                        _tables_override=None, device="cuda", plain: bool = False,
                        loop: Optional[str] = None, mesh=None,
                        trajectory_steps: Optional[Sequence[int]] = None):
    """Build the kernel PC sampler for ``model`` (a ScoreModelFC).

    Returns ``sampler(generator=None, observation=None, mask=None, z=None,
    noise=None) -> x`` [B, D]: ``z`` replaces the prior draw and ``noise``
    ([N, K, B, D], or [N, B, D] when K == 1) the host-mode normals;
    ``observation`` and ``mask`` [B, D] come iff ``imputation=True``. Tables,
    operands and the loop's buffers are made once here; a call launches the
    kernels only.

    ``loop="graph"`` (``graph_loop.GraphLoop``) captures the whole loop into
    one CUDA graph at the first call and replays it at every call, the
    counterpart of the TPU program's in-kernel loop; ``"eager"`` submits the
    launches from Python at every call. The default is the graph on the card
    for ``rng_mode="kernel"``, else the eager loop; ``"graph"`` needs a CUDA
    device and ``plain=False``, and under ``rng_mode="host"`` every call
    must inject ``noise=`` (a replay cannot draw from a generator step by
    step). The prior draw and the seed draw stay outside the graph, in the
    eager order, so both loops give the same bits from one generator state.
    ``sampler.loops`` holds the call's ``GraphLoop`` (two for the mixed
    schedule). ``sampler.load_params(model)`` rewrites the network operands
    in place from ``model``'s weights (a model of the same architecture):
    the next call runs on them, and a captured graph is replayed, not
    captured again (int8 operands keep ``act_amax``'s ranges).

    ``probability_flow=True`` is the deterministic PF-ODE Euler decode of the
    interpolation task: the same launches on tables whose score term is
    halved and whose noise coefficient is 0, so the normals, host-drawn or
    in-kernel, have no effect.

    ``step_range=(lo, hi)`` runs rows ``lo..hi`` of the N-step grid, the
    state carried in through ``z=`` and out through the return; ``noise`` then
    has ``hi - lo`` rows. The tables keep all N rows and the loop walks
    ``lo..hi``, so the in-kernel normals are keyed by the grid's own step
    index: head then tail under one seed draw what the full run draws.
    ``_tables_override=(timesteps, cx, cout, cnoise)`` replaces the
    predictor's rows with caller-built ones (``cout`` with any sigma output
    scaling folded in): the few-step DDIM path runs through the kernels this
    way. ``plain=True`` runs the same loop on the kernels' plain versions
    (host normals only), on any device.

    ``quant="int8"`` (the opt-in W8A8 serving mode; ``act_amax`` from
    ``quant.calibrate_act_amax`` or ``calibrate_act_amax_per_channel``) runs
    the hidden layers on K13: int8 weights and activations, int32 sums, the
    head and all the update arithmetic unchanged. ``bf16_tail_steps=K`` (with
    ``quant="int8"``) composes the mixed schedule: int8 for rows ``0..N-K``
    (``denoise=False``), then the bf16 kernels for the last K rows, the state
    carried between them and host noise split as ``noise[:N-K]``,
    ``noise[N-K:]``. Under in-kernel normals both parts draw with the seed of
    one call, keyed by the grid's step, so they draw what one full run draws;
    on the graph each part is a graph of its own.

    ``mesh`` (``parallel.sharding.Mesh``) of more than one device shards the
    batch (port of ``fused_em.py::_sharded_sampler``, through
    ``sharding.shard_builder``): one sampler, mixed schedule included, a
    shard at ``(B // n, D)`` on its device; ``z``, the observation, the mask
    and ``noise`` split by rows; each shard's prior draw, host normals or
    in-kernel seed from its folded generator. The langevin corrector's
    batch-mean norms are per shard, as in JAX: each shard is a langevin
    batch of its own. A mesh of one device is the route above on that
    device, and then ``device`` is not read.

    ``trajectory_steps`` (grid steps inside the run's rows) makes a call
    return ``(trajs [T, B, D], x)``, ``trajs[j]`` the state ``x`` after step
    ``trajectory_steps[j]`` (the noised state, also at the last step, as the
    JAX sampler's ``return_trajectory`` records it). The loop body copies
    ``x`` into a static buffer after each named step, so a captured graph
    records the copies too, and a call returns a clone of that buffer; the
    final ``x`` is the sampler's without ``trajectory_steps``, bit for bit.
    Corrector-free imputation then re-noises before each predictor (K4 at
    every step) instead of folding the next step's re-noise into K2, so the
    recorded state is the step's own. Under a mesh each shard records its
    rows and the trajectories join along their rows (axis 1). It does not
    combine with ``bf16_tail_steps``.
    """
    args = dict(locals())
    mesh, device = mesh_route(mesh, device)
    if mesh is not None:
        return shard_builder(get_cuda_em_sampler, args, mesh,
                             ("observation", "mask", "z", "noise"), "the sharded kernel sampler")
    if bf16_tail_steps:
        if trajectory_steps is not None:
            raise ValueError("trajectory_steps records one run's steps; the mixed schedule "
                             "(bf16_tail_steps) runs two")
        if quant != "int8" or _tables_override is not None or step_range is not None:
            raise ValueError("bf16_tail_steps requires quant='int8' and is incompatible "
                             "with _tables_override/step_range")
        n_total, k_tail = int(sde.N), int(bf16_tail_steps)
        if not 0 < k_tail < n_total:
            raise ValueError(f"bf16_tail_steps must be in (0, {n_total}); got {k_tail}")
        common = dict(eps=eps, rng_mode=rng_mode, corrector=corrector, snr=snr,
                      n_corrector_steps=n_corrector_steps, imputation=imputation,
                      predictor=predictor, probability_flow=probability_flow,
                      device=device, plain=plain, loop=loop)
        cut = n_total - k_tail
        head = get_cuda_em_sampler(sde, model, shape, denoise=False, quant="int8",
                                   act_amax=act_amax, step_range=(0, cut), **common)
        tail = get_cuda_em_sampler(sde, model, shape, denoise=denoise,
                                   step_range=(cut, n_total), **common)
        dev = resolve_device(device)

        def mixed(generator: Optional[torch.Generator] = None, observation=None,
                  mask=None, z=None, noise=None):
            nh = nt = None
            if noise is not None:
                if noise.ndim == 3:
                    noise = noise[:, None]
                nh, nt = noise[:cut], noise[cut:]
            if z is None:
                z = sde.prior_sampling(tuple(shape), generator, dev)
            state = (generator.get_state() if rng_mode == "kernel" and generator is not None
                     else None)
            x = head(generator, observation=observation, mask=mask, z=z, noise=nh)
            if state is not None:  # the tail draws the head's seed
                generator.set_state(state)
            return tail(generator, observation=observation, mask=mask, z=x, noise=nt)

        mixed.loops = head.loops + tail.loops
        mixed.load_params = lambda m: (head.load_params(m), tail.load_params(m))
        return mixed

    if rng_mode not in ("host", "kernel"):
        raise ValueError(f"rng_mode must be 'host' or 'kernel', got {rng_mode!r}")
    if corrector not in ("none", "langevin"):
        raise NotImplementedError(f"corrector {corrector!r} is not supported")
    if step_range is not None and _tables_override is not None:
        raise ValueError("step_range slices the N-step grid; overridden tables "
                         "are cut where they are made")
    device = resolve_device(device)
    if rng_mode == "kernel" and (device.type != "cuda" or plain):
        raise ValueError("rng_mode='kernel' draws normals in the CUDA kernels; use "
                         "rng_mode='host' on the CPU or with plain=True")
    graph = resolve_loop(loop, device, plain, rng_mode == "kernel") == "graph"
    n_corr = n_corrector_steps if corrector == "langevin" else 0
    K = n_corr + (2 if imputation else 0) + 1
    batch, dim = shape
    if probability_flow and _tables_override is not None:
        raise ValueError("overridden tables carry their own noise coefficients")
    with profiling.setup_span("build.sampler"):
        net, coefs = build_sampler_operands(sde, model, eps, predictor, device,
                                            _tables_override, probability_flow, quant, act_amax)
        if net["dim"] != dim:
            raise ValueError(f"shape {shape} does not match the model's pose dim {net['dim']}")
        lo, hi = (0, int(coefs.shape[0])) if step_range is None else step_range
        if not 0 <= lo < hi <= int(coefs.shape[0]):
            raise ValueError(f"step_range {step_range} out of bounds for the "
                             f"{int(coefs.shape[0])}-step grid")
        n_steps = hi - lo
        record = {}  # grid step -> its row of the trajectory buffer
        if trajectory_steps is not None:
            record = {int(s): j for j, s in enumerate(trajectory_steps)}
            if len(record) != len(trajectory_steps) or not all(lo <= s < hi for s in record):
                raise ValueError(f"trajectory_steps must be distinct grid steps in [{lo}, {hi})")
        # corrector-free imputation: K2 re-noises for the next step, K4 runs once
        # (unless a trajectory records each step's own state)
        fold = imputation and n_corr == 0 and trajectory_steps is None

        # the loop's static buffers: the state, its scratch and the inputs
        x = torch.empty((batch, dim), dtype=torch.float32, device=device)
        x_mean = torch.empty_like(x) if denoise else None
        scratch = pc_scratch(net, batch, n_corr, device)
        trajs = (torch.empty((len(record), batch, dim), dtype=torch.float32, device=device)
                 if trajectory_steps is not None else None)
        inputs = dict(z=torch.empty_like(x))
        if imputation:
            inputs.update(observation=torch.empty_like(x), mask=torch.empty_like(x))
        if rng_mode == "kernel":
            inputs["seed"] = torch.zeros((1,), dtype=torch.int64, device=device)
        elif graph:
            inputs["noise"] = torch.empty((n_steps, K, batch, dim), dtype=torch.float32,
                                          device=device)

    def body(noise=None, generator=None, warm_up=False):
        x.copy_(inputs["z"])
        observed = (inputs["observation"], inputs["mask"]) if imputation else None
        seed = inputs.get("seed")
        if rng_mode == "host":
            steps = host_slabs(inputs["noise"] if graph else noise, lo, hi,
                               (K, batch, dim), generator, device)
        else:
            steps = (([None] * K, None) for _ in range(lo, hi))
        for i, (slabs, next_slabs) in zip(range(lo, hi), steps):
            if warm_up and lo < i < hi - 1:
                continue  # the first and the last step launch every kernel of the loop
            pc_step(net, coefs, i, x, scratch, slabs, n_corr=n_corr, snr=snr, seed=seed,
                    x_mean=x_mean if i == hi - 1 else None, observed=observed,
                    renoised=fold and i > lo, renoise_next=fold and i + 1 < hi,
                    next_slabs=next_slabs, plain=plain)
            if i in record:
                trajs[record[i]].copy_(x)
        out = x_mean if denoise else x
        return out if trajs is None else (trajs, out)

    runner = GraphLoop(body, inputs, graph=graph)

    @profiling.spanned("loop.call")
    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, observation=None,
                mask=None, z=None, noise=None):
        check_imputation_args(imputation, observation, mask)
        values = {}
        if imputation:
            for nm, t in (("observation", observation), ("mask", mask)):
                values[nm] = t.to(device=device, dtype=torch.float32).contiguous()
                _check(nm, values[nm], device, torch.float32, (batch, dim))
        if noise is not None:
            if rng_mode != "host":
                raise ValueError("noise= is the host-mode stream; this sampler "
                                 "draws its normals in-kernel")
            if noise.ndim == 3:
                noise = noise[:, None]
            _check("noise", noise, device, torch.float32, (n_steps, K, batch, dim))
        elif graph and rng_mode == "host":
            raise ValueError("loop='graph' under rng_mode='host' replays injected normals: "
                             "pass noise=")
        if z is None:
            values["z"] = sde.prior_sampling(shape, generator, device)
        else:
            values["z"] = z.to(device=device, dtype=torch.float32)
        if rng_mode == "kernel":
            values["seed"] = draw_seed(generator)
        if graph:
            if noise is not None:
                values["noise"] = noise
            return runner(values)
        return runner(values, noise=noise, generator=generator)

    def load_params(model_new) -> None:
        load_operands_((net, coefs), build_sampler_operands(
            sde, model_new, eps, predictor, device, _tables_override, probability_flow, quant,
            act_amax))

    sampler.loops, sampler.load_params = (runner,), load_params
    return sampler


def get_cuda_em_hypo_sampler(sde: SDE, model, shape: Tuple[int, int], hypo_num: int,
                             **kw):
    """Multi-hypothesis masked imputation in one pass of the kernel sampler:
    the hypotheses tile into rows (the flattening the completion solver uses
    for its hypotheses).

    ``sampler(generator, observation [B, D], mask [B, D], z=None, noise=None)
    -> [B, H, D]``. Rows decorrelate through the prior draw and the noise
    streams, which cover the whole ``H*B`` row space; ``z`` and ``noise`` are
    taken in that tiled row space (``[H*B, D]``, ``[N, K, H*B, D]``). With
    ``mesh=`` the tiled rows, hypothesis-major, are what the mesh shards.
    """
    batch, dim = shape
    kw.setdefault("imputation", True)
    inner = get_cuda_em_sampler(sde, model, (hypo_num * batch, dim), **kw)

    def sampler(generator, observation, mask, z=None, noise=None):
        out = inner(generator, observation=observation.repeat(hypo_num, 1),
                    mask=mask.repeat(hypo_num, 1), z=z, noise=noise)
        return out.reshape(hypo_num, batch, dim).transpose(0, 1)

    sampler.loops, sampler.load_params = inner.loops, inner.load_params
    return sampler
