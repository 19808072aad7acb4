"""Post-training int8 quantization for the kernel sampler (the opt-in W8A8
serving mode). Port of ``dposer_tpu/ops/pallas/quant.py``.

- weights: symmetric per-output-column int8 (``quantize_cols``); the column
  scales fold into the one fp32 rescale row K13 applies per matmul;
- activations: symmetric int8 with STATIC ranges calibrated on a real
  sampling trajectory, per tensor (``calibrate_act_amax``) or per channel
  (``calibrate_act_amax_per_channel``, folded into the weights by
  ``smooth_fold``, SmoothQuant-style);
- the output head stays bf16: the one matmul with no GroupNorm after it.

``make_fast_forward_int8`` is the plain int8 twin of the whole forward in the
model's own parameter order, for tests and for measuring quantization error
without the kernels. The operands the kernels read are built by
``score_net.build_network_operands(quant="int8", act_amax=...)``.

Calibration runs the fp32 tabled forward (``diffusion/fast_sampler.py``) for
the full ``sde.N`` steps, drawing from a ``torch.Generator``; ``z=`` and
``noise=`` ([N, K, B, D], slabs corr_0..corr_{S-1}, predictor) inject the
prior draw and the normals instead. Like the JAX package, the trajectory
applies the model's sigma output scale twice when ``scale_by_sigma`` (once in
the forward, once in the folded tables): the ranges are those the measured
int8 quality was obtained with.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...diffusion.fast_sampler import (_corrector_tables, _group_norm, _labels_for,
                                       _pred_tables, precompute_time_tables)
from ...diffusion.sde import SDE
from ...utils import profiling


def n_matmuls(model) -> int:
    """Matmul count of the forward: pre + 2*n_blocks + post."""
    return 2 + 2 * model.n_blocks


def _dense(model, name, h):
    layer = getattr(model, name)
    return F.linear(h, layer.weight, layer.bias)


def _make_amax_forward(model, tprojs, out_scale, per_channel: bool = False):
    """``fwd(x, i) -> (model_out, amaxes)``: the fast forward instrumented to
    record the absolute max of every matmul INPUT, in kernel matmul order x,
    h_pre, (h1, h_res) per block, h_post; stacked [n_mm] scalars, or a list of
    per-channel vectors when ``per_channel``."""
    act = model.act

    def reduce_in(v):
        return v.abs().amax(0) if per_channel else v.abs().max()

    def gnorm(name, h):
        g = getattr(model, name)
        return act(_group_norm(h, g.weight, g.bias))

    def fwd(x, i):
        amaxes = [reduce_in(x)]
        h = gnorm("pre_gnorm", _dense(model, "pre_dense", x) + tprojs["pre_dense_t"][i])
        for blk in range(model.n_blocks):
            b = f"b{blk + 1}_"
            amaxes.append(reduce_in(h))
            h1 = gnorm(b + "gnorm1", _dense(model, b + "dense1", h) + tprojs[b + "dense1_t"][i])
            amaxes.append(reduce_in(h1))
            h2 = gnorm(b + "gnorm2", _dense(model, b + "dense2", h1) + tprojs[b + "dense2_t"][i])
            h = h + h2
        amaxes.append(reduce_in(h))
        res = _dense(model, "post_dense", h)
        if out_scale is not None:
            res = res * out_scale[i]
        return res, (amaxes if per_channel else torch.stack(amaxes))

    return fwd


@torch.no_grad()
def _trajectory_amax(sde: SDE, model, shape, generator, eps, corrector, snr,
                     n_corrector_steps, predictor, z, noise, device, per_channel):
    """Running max |matmul input| along the fp32 tabled EM (or PC) trajectory."""
    if corrector not in ("none", "langevin"):
        raise ValueError(f"corrector must be 'none' or 'langevin', got {corrector!r}")
    device = torch.device(device)
    timesteps = sde.timesteps(eps, device=device)
    labels = _labels_for(sde, timesteps)
    cx, cout, cnoise = _pred_tables(sde, timesteps, predictor)
    tprojs, out_scale = precompute_time_tables(model, labels)
    fwd = _make_amax_forward(model, tprojs, out_scale, per_channel)
    score_scale, alpha = _corrector_tables(sde, timesteps, out_scale)
    if out_scale is not None:
        cout = cout * out_scale
    n_corr = n_corrector_steps if corrector == "langevin" else 0
    n_steps = int(timesteps.shape[0])
    if noise is not None:
        noise = noise.to(device=device, dtype=torch.float32)
        if noise.ndim == 3:
            noise = noise[:, None]
        if tuple(noise.shape) != (n_steps, n_corr + 1) + tuple(shape):
            raise ValueError(f"noise must be {(n_steps, n_corr + 1) + tuple(shape)}, got "
                             f"{tuple(noise.shape)}")
    x = (sde.prior_sampling(tuple(shape), generator, device) if z is None else
         z.to(device=device, dtype=torch.float32))
    amax = None

    def running_max(amax, am):
        if amax is None:
            return am
        if per_channel:
            return [torch.maximum(a, b) for a, b in zip(amax, am)]
        return torch.maximum(amax, am)

    for i in range(n_steps):
        zs = (noise[i] if noise is not None else
              torch.randn((n_corr + 1,) + tuple(shape), generator=generator, device=device))
        for j in range(n_corr):
            out, am = fwd(x, i)
            amax = running_max(amax, am)
            score = score_scale[i] * out
            grad_norm = torch.linalg.vector_norm(score, dim=-1).mean()
            noise_norm = torch.linalg.vector_norm(zs[j], dim=-1).mean()
            step_size = (snr * noise_norm / grad_norm) ** 2 * 2.0 * alpha[i]
            x = x + step_size * score + torch.sqrt(2.0 * step_size) * zs[j]
        out, am = fwd(x, i)
        amax = running_max(amax, am)
        x = cx[i] * x + cout[i] * out + cnoise[i] * zs[n_corr]
    return amax


def calibrate_act_amax(sde: SDE, model, shape: Tuple[int, int],
                       generator: Optional[torch.Generator] = None, eps: float = 1e-3,
                       margin: float = 1.1, corrector: str = "none", snr: float = 0.16,
                       n_corrector_steps: int = 1, predictor: str = "euler_maruyama",
                       z=None, noise=None, device="cuda") -> np.ndarray:
    """Per-matmul-input activation ranges along a real sampling trajectory:
    the running max |input| of each of the ``n_matmuls(model)`` matmuls over
    the fp32 tabled EM (or PC, ``corrector="langevin"``) loop at batch
    ``shape[0]``, times ``margin``; fp32 [n_mm]. It feeds
    ``get_cuda_em_sampler(quant="int8", act_amax=...)``; inputs beyond the
    range saturate at +-127."""
    amax = _trajectory_amax(sde, model, shape, generator, eps, corrector, snr,
                            n_corrector_steps, predictor, z, noise, device, False)
    amax = amax.double().cpu().numpy() * margin
    if not np.all(amax > 0):
        raise ValueError(f"calibration produced non-positive ranges: {amax}")
    return amax.astype(np.float32)


def calibrate_act_amax_per_channel(sde: SDE, model, shape: Tuple[int, int],
                                   generator: Optional[torch.Generator] = None,
                                   eps: float = 1e-3, margin: float = 1.1,
                                   corrector: str = "none", snr: float = 0.16,
                                   n_corrector_steps: int = 1,
                                   predictor: str = "euler_maruyama", z=None, noise=None,
                                   device="cuda") -> List[np.ndarray]:
    """Per-CHANNEL ranges along the same trajectory: a list of ``n_matmuls``
    fp32 vectors (``[dim]`` for the input matmul, ``[hidden]`` for the rest),
    each the running max |input| per channel times ``margin``. Trained GN
    scales develop outlier channels (~100 against O(1-5)); a per-tensor scale
    leaves ordinary channels a few levels, which ``smooth_fold`` avoids.
    Channels that never light up take the vector's max, so the fold leaves
    them alone. The set-up span ``quant.calibrate``."""
    with profiling.setup_span("quant.calibrate"):
        amax = _trajectory_amax(sde, model, shape, generator, eps, corrector, snr,
                                n_corrector_steps, predictor, z, noise, device, True)
    out = [a.double().cpu().numpy() * margin for a in amax]
    if not all(np.all(np.isfinite(a)) and a.max() > 0 for a in out):
        raise ValueError("per-channel calibration produced invalid ranges")
    return [np.where(a > 0, a, a.max()).astype(np.float32) for a in out]


def quantize_cols(Wf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-column int8 of ``Wf`` [in, out] fp32: ``(Wq int8
    [in, out], scales fp32 [out])`` with ``W ~= Wq * scales``. All-zero
    columns quantize to zero with scale zero. Divides by the scale (not by a
    multiply with its reciprocal), rounds half to even, as JAX does."""
    Wf = Wf.float()
    s = Wf.abs().amax(0) / 127.0
    q = torch.clamp(torch.round(Wf / torch.clamp(s, min=1e-30)), -127, 127)
    return q.to(torch.int8), s


def smooth_fold(amax_ch, Wf, alpha: float = 0.5):
    """SmoothQuant-style difficulty migration for one matmul, in float64
    numpy as the JAX package computes it: per-input-channel scales ``s_k =
    amax_k^alpha / wmax_k^(1-alpha)`` normalized to geometric mean 1 over the
    valid channels, returning ``(inv_in [in] fp32, W_folded [in, out] fp32,
    amax_t)`` with ``h @ W == (h / s) @ (s[:, None] * W)``; ``inv_in = 127 /
    (s * amax_t)`` is the runtime quantization row and ``amax_t =
    max_k(amax_k / s_k)`` the folded per-tensor range."""
    amax_ch = np.asarray(amax_ch, np.float64)
    wmax = np.abs(np.asarray(Wf, np.float64)).max(axis=1)
    valid = (amax_ch > 0) & (wmax > 0)
    s = np.ones_like(amax_ch)
    s[valid] = amax_ch[valid] ** alpha / wmax[valid] ** (1.0 - alpha)
    s /= np.exp(np.log(s[valid]).mean()) if valid.any() else 1.0
    amax_t = float((amax_ch / s).max())
    inv_in = (127.0 / (s * amax_t)).astype(np.float32)
    return inv_in, (s[:, None] * np.asarray(Wf, np.float64)).astype(np.float32), amax_t


def quantize_act(a: torch.Tensor, qinv: torch.Tensor) -> torch.Tensor:
    """The kernels' activation quantizer, as float values in [-127, 127]:
    ``clamp(rint(a * qinv), -127, 127)``, half to even."""
    return torch.clamp(torch.round(a * qinv), -127.0, 127.0)


def int8_matmul(aq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``aq @ wq`` of int8-valued operands (``aq`` float, ``wq`` int8 [in, out])
    as the int32 sums in fp32. Computed in float64, which is exact (|sum| <=
    1024 * 127^2 < 2^24); the CPU's own int8 matmul wraps in int8."""
    return (aq.double() @ wq.double()).float()


def make_fast_forward_int8(model, tprojs, out_scale, act_amax, alpha: float = 0.5):
    """The plain int8 twin of the kernels' forward, in the model's parameter
    order: the same per-column weight scales, static activation scales and
    saturating round, in plain PyTorch; ``fwd(x, i) -> model_out``.
    ``act_amax``: per-tensor ``[n_mm]`` scalars, or the per-channel list
    (then each matmul applies ``smooth_fold`` with ``alpha``). The head stays
    unquantized (fp32 here, bf16 in the kernels); ``act_amax``'s last entry is
    accepted and ignored."""
    act = model.act
    n_mm = n_matmuls(model)
    per_channel = isinstance(act_amax, (list, tuple))
    if not per_channel:
        act_amax = np.asarray(act_amax, np.float32)
        if act_amax.shape != (n_mm,):
            raise ValueError(f"act_amax must have shape ({n_mm},)")
    elif len(act_amax) != n_mm:
        raise ValueError(f"per-channel act_amax must have {n_mm} entries")
    dev = model.post_dense.weight.device
    names = ["pre_dense"] + [f"b{b + 1}_dense{j}" for b in range(model.n_blocks)
                             for j in (1, 2)]
    quant = {}
    for k, name in enumerate(names):
        Wf = getattr(model, name).weight.detach().t().float().cpu().numpy()
        if per_channel:
            inv_k, Wf, amax_t = smooth_fold(act_amax[k], Wf, alpha=alpha)
            inv = torch.from_numpy(inv_k)
            deq_t = amax_t / 127.0
        else:
            inv = torch.full((Wf.shape[0],), float(np.float32(127.0) / act_amax[k]))
            deq_t = float(act_amax[k]) / 127.0
        wq, sw = quantize_cols(torch.from_numpy(np.ascontiguousarray(Wf)))
        quant[name] = (inv.to(dev), wq.to(dev), (sw * float(np.float32(deq_t))).to(dev))

    def qmm(name, h):
        inv, wq, deq = quant[name]
        return int8_matmul(quantize_act(h, inv), wq) * deq

    def dense(name, h):
        return qmm(name, h) + getattr(model, name).bias

    def gnorm(name, h):
        g = getattr(model, name)
        return act(_group_norm(h, g.weight, g.bias))

    @torch.no_grad()
    def fwd(x, i):
        h = gnorm("pre_gnorm", dense("pre_dense", x) + tprojs["pre_dense_t"][i])
        for blk in range(model.n_blocks):
            b = f"b{blk + 1}_"
            h1 = gnorm(b + "gnorm1", dense(b + "dense1", h) + tprojs[b + "dense1_t"][i])
            h2 = gnorm(b + "gnorm2", dense(b + "dense2", h1) + tprojs[b + "dense2_t"][i])
            h = h + h2
        res = _dense(model, "post_dense", h)
        return res * out_scale[i] if out_scale is not None else res

    return fwd
