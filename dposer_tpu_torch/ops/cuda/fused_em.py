"""The reverse-diffusion loop on the card: a host loop of CUDA kernels.

Port of ``dposer_tpu/ops/pallas/fused_em.py``. The TPU runs the whole
N-step loop as one program with ~8.3 MB of bf16 weights resident on-core.
An H100 SM has 227 KB of shared memory, so here each step is a short
sequence of launches on one stream, with no host synchronization inside
the loop (the weights stay in the 50 MB L2):

- K1 ``dense_gn_silu`` (``score_net.py``) x (1 + 2*n_blocks): the hidden layers;
- K2 ``head_em``: the output head fused with the EM update, or, for the
  corrector, with the score and its row norms;
- K3 ``langevin_update``: the corrector's batch-mean norms and update.

Per step: ``[corrector: fwd -> K2(score) -> K3] * S``, then ``fwd -> K2(EM)``.
The step's scalars come from the device table ``coefs [N, 8]`` (cx, cout,
cnoise, score_scale, alpha, imputation mean, imputation std, 0), read by
the kernels at the step index.

Noise: ``rng_mode="host"`` takes ``[N, K, B, D]`` slabs in the order
corr_0..corr_{S-1}, predictor (injected with ``noise=``, else drawn from the
generator per step); ``rng_mode="kernel"`` draws Philox normals inside K2
and K3 (card only). Each kernel's plain PyTorch version is here or in
``score_net.py``; a wrapper given CPU tensors runs it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...diffusion.fast_sampler import (_corrector_tables, _imputation_tables,
                                       _labels_for, _pred_tables)
from ...diffusion.sde import SDE
from . import build
from .score_net import (HEAD_COLS, _check, _ptr, build_network_operands,
                        dense_gn_silu, dense_gn_silu_plain_into, network_hidden)

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
                       slab: int = 0):
    """The plain version with ``head_em``'s signature, on any device; it
    takes host normals only."""
    if mode == "em":
        if noise is None:
            raise ValueError("the plain head_em takes host normals (noise=)")
        x_new, xm = head_em_plain(h, w_post, b_post, coefs, step, mode, x.shape[1],
                                  x=x, noise=noise)
        if x_mean is not None:
            x_mean.copy_(xm)
        x.copy_(x_new)
    else:
        s, sq = head_em_plain(h, w_post, b_post, coefs, step, mode, score.shape[1])
        score.copy_(s)
        score_sq.copy_(sq)


def _head_em_fn():
    fn = build.load("head_em").dposer_head_em
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, P, P, P, P, P, ctypes.c_ulonglong, I,
                       I, I, I, P]
        fn.restype = I
    return fn


def _noise_args(name, noise, seed, dev, shape):
    if (noise is None) == (seed is None):
        raise ValueError(f"{name}: pass exactly one of noise= (host normals) "
                         f"or seed= (in-kernel normals)")
    if noise is not None:
        _check("noise", noise, dev, torch.float32, shape)
    elif dev.type != "cuda":
        raise ValueError(f"{name}: in-kernel normals (seed=) need CUDA tensors")


def head_em(h, w_post, b_post, coefs, step: int, mode: str, *, x=None,
            x_mean=None, score=None, score_sq=None, noise=None, seed=None,
            slab: int = 0):
    """K2 on ``h`` [B, H]. ``mode="em"`` updates ``x`` [B, D] in place (and
    writes ``x_mean`` when given); ``mode="score"`` writes ``score`` [B, D]
    and ``score_sq`` [B]."""
    B, H = h.shape
    dev = h.device
    _check("h", h, dev, torch.float32, (B, H))
    _check("w_post", w_post, dev, torch.bfloat16, (H, HEAD_COLS))
    _check("b_post", b_post, dev, torch.float32, (HEAD_COLS,))
    if coefs.ndim != 2 or coefs.shape[1] != N_COEFS or not 0 <= step < coefs.shape[0]:
        raise ValueError(f"coefs must be [N, {N_COEFS}] with 0 <= step < N")
    _check("coefs", coefs, dev, torch.float32, coefs.shape)
    if mode == "em":
        D = x.shape[1]
        _check("x", x, dev, torch.float32, (B, D))
        if x_mean is not None:
            _check("x_mean", x_mean, dev, torch.float32, (B, D))
        _noise_args("head_em", noise, seed, dev, (B, D))
    elif mode == "score":
        D = score.shape[1]
        _check("score", score, dev, torch.float32, (B, D))
        _check("score_sq", score_sq, dev, torch.float32, (B,))
    else:
        raise ValueError(f"mode must be 'em' or 'score', got {mode!r}")
    if D > HEAD_COLS:
        raise ValueError(f"pose dim {D} > {HEAD_COLS}")
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
                        _ptr(noise), 0 if seed is None else seed, slab, B, H, D,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"head_em launch failed: CUDA error {err}")
    head_em.launches += 1


head_em.launches = 0


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
        fn.argtypes = [P, P, P, P, I, ctypes.c_float, P, ctypes.c_ulonglong, I,
                       P, I, I, P]
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
    if coefs.ndim != 2 or coefs.shape[1] != N_COEFS or not 0 <= step < coefs.shape[0]:
        raise ValueError(f"coefs must be [N, {N_COEFS}] with 0 <= step < N")
    _check("coefs", coefs, dev, torch.float32, coefs.shape)
    if step_out is not None:
        _check("step_out", step_out, dev, torch.float32, (1,))
    _noise_args("langevin_update", noise, seed, dev, (B, D))
    if dev.type == "cpu":
        return langevin_update_plain_into(x, score, score_sq, coefs, step, snr,
                                          noise=noise, step_out=step_out)
    if dev.type != "cuda":
        raise ValueError(f"langevin_update runs on cpu or cuda, not {dev}")
    if B > 12288:
        raise ValueError(f"langevin_update kernel keeps one float per row in shared "
                         f"memory: batch {B} > 12288")
    err = _langevin_fn()(x.data_ptr(), score.data_ptr(), score_sq.data_ptr(),
                         coefs.data_ptr(), step, float(snr), _ptr(noise),
                         0 if seed is None else seed, slab, _ptr(step_out), B, D,
                         torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"langevin_update launch failed: CUDA error {err}")
    langevin_update.launches += 1


langevin_update.launches = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {"dense_gn_silu": dense_gn_silu.launches, "head_em": head_em.launches,
            "langevin_update": langevin_update.launches}


def reset_launch_counts() -> None:
    dense_gn_silu.launches = head_em.launches = langevin_update.launches = 0


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

@torch.no_grad()
def build_sampler_operands(sde: SDE, model, eps: float, predictor: str, device):
    """``(net, coefs)`` for the kernels: the network operands of
    ``build_network_operands`` and the per-step scalar table ``coefs [N, 8]``
    fp32 (cx, cout, cnoise, score_scale, alpha, imputation mean, imputation
    std, 0), with the model's ``1/sigma`` output scale folded into cout and
    score_scale."""
    timesteps = sde.timesteps(eps, device=model.sigmas.device)
    cx, cout, cnoise = _pred_tables(sde, timesteps, predictor)
    net = build_network_operands(model, _labels_for(sde, timesteps), device)
    out_scale = net["out_scale"]
    score_scale, alpha = _corrector_tables(sde, timesteps, out_scale)
    imput_mc, imput_std = _imputation_tables(sde, timesteps)
    if out_scale is not None:
        cout = cout * out_scale
    coefs = torch.stack([cx, cout, cnoise, score_scale, alpha, imput_mc,
                         imput_std, torch.zeros_like(cx)], dim=1)
    return net, coefs.float().to(device).contiguous()


def pc_step(net: dict, coefs, i: int, x, scratch: dict, slabs, *, n_corr: int,
            snr: float, seed=None, x_mean=None, plain: bool = False) -> None:
    """Reverse step ``i`` on ``x`` [B, D] in place: ``n_corr`` langevin
    corrector steps, then the EM update (``x_mean``, when given, receives the
    denoised state). ``slabs[k]`` are the host normals of slab ``k`` (corr_0..,
    em), or None with ``seed`` for in-kernel normals. ``scratch`` holds ``h``,
    ``h1`` [B, H] and, with a corrector, ``score`` [B, D] and ``score_sq``
    [B]. ``plain=True`` runs the kernels' plain versions instead, on any
    device: the reference the card's kernels are held to."""
    layer, head, langevin = ((dense_gn_silu_plain_into, head_em_plain_into,
                              langevin_update_plain_into) if plain else
                             (dense_gn_silu, head_em, langevin_update))
    h, h1 = scratch["h"], scratch["h1"]
    for j in range(n_corr):
        network_hidden(net, x, i, h, h1, layer)
        head(h, net["w_post"], net["b_post"], coefs, i, "score",
             score=scratch["score"], score_sq=scratch["score_sq"])
        langevin(x, scratch["score"], scratch["score_sq"], coefs, i, snr,
                 noise=slabs[j], seed=seed, slab=j)
    network_hidden(net, x, i, h, h1, layer)
    head(h, net["w_post"], net["b_post"], coefs, i, "em", x=x, x_mean=x_mean,
         noise=slabs[n_corr], seed=seed, slab=n_corr)


def pc_scratch(net: dict, batch: int, n_corr: int, device) -> dict:
    """The buffers ``pc_step`` works in."""
    h = torch.empty((batch, net["hidden"]), dtype=torch.float32, device=device)
    out = dict(h=h, h1=torch.empty_like(h))
    if n_corr:
        out["score"] = torch.empty((batch, net["dim"]), dtype=torch.float32, device=device)
        out["score_sq"] = torch.empty((batch,), dtype=torch.float32, device=device)
    return out


def get_cuda_em_sampler(sde: SDE, model, shape: Tuple[int, int], eps: float = 1e-3,
                        denoise: bool = True, rng_mode: str = "host",
                        corrector: str = "none", snr: float = 0.16,
                        n_corrector_steps: int = 1,
                        predictor: str = "euler_maruyama", device="cuda",
                        plain: bool = False):
    """Build the kernel PC sampler for ``model`` (a ScoreModelFC).

    Returns ``sampler(generator=None, z=None, noise=None) -> x`` [B, D]:
    ``z`` replaces the prior draw and ``noise`` ([N, K, B, D], or [N, B, D]
    when K == 1) the host-mode normals. Tables and operands are built once
    here; a call launches the kernels only. ``plain=True`` runs the same
    loop on the kernels' plain versions (host normals only), on any device.
    """
    if rng_mode not in ("host", "kernel"):
        raise ValueError(f"rng_mode must be 'host' or 'kernel', got {rng_mode!r}")
    if corrector not in ("none", "langevin"):
        raise NotImplementedError(f"corrector {corrector!r} is not supported")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # tensors report "cuda:N"; the wrappers compare devices exactly
        device = torch.device("cuda", torch.cuda.current_device())
    if rng_mode == "kernel" and (device.type != "cuda" or plain):
        raise ValueError("rng_mode='kernel' draws normals in the CUDA kernels; use "
                         "rng_mode='host' on the CPU or with plain=True")
    n_corr = n_corrector_steps if corrector == "langevin" else 0
    K = n_corr + 1
    batch, dim = shape
    net, coefs = build_sampler_operands(sde, model, eps, predictor, device)
    if net["dim"] != dim:
        raise ValueError(f"shape {shape} does not match the model's pose dim {net['dim']}")
    n_steps = int(coefs.shape[0])

    @torch.no_grad()
    def sampler(generator: Optional[torch.Generator] = None, z=None, noise=None):
        if noise is not None:
            if rng_mode != "host":
                raise ValueError("noise= is the host-mode stream; this sampler "
                                 "draws its normals in-kernel")
            if noise.ndim == 3:
                noise = noise[:, None]
            _check("noise", noise, device, torch.float32, (n_steps, K, batch, dim))
        if z is None:
            x = sde.prior_sampling(shape, generator, device)
        else:
            x = z.to(device=device, dtype=torch.float32).clone()
        x = x.contiguous()
        scratch = pc_scratch(net, batch, n_corr, device)
        x_mean = torch.empty_like(x) if denoise else None
        seed = None
        if rng_mode == "kernel":
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device if generator is not None else "cpu"))
        slabs = [None] * K
        for i in range(n_steps):
            if rng_mode == "host":
                slabs = (noise[i] if noise is not None else
                         torch.randn((K, batch, dim), generator=generator, device=device))
            pc_step(net, coefs, i, x, scratch, slabs, n_corr=n_corr, snr=snr, seed=seed,
                    x_mean=x_mean if i == n_steps - 1 else None, plain=plain)
        return x_mean if denoise else x

    return sampler
