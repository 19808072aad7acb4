"""The ScoreModelFC forward for the CUDA reverse-diffusion loop.

Port of ``dposer_tpu/ops/pallas/score_net.py``:

- ``build_network_operands``: the host-side prep. bf16 weights in the
  natural feature order, ``tp_all [N, 1+2*n_blocks, H]`` fp32 (each layer's
  time projection plus its dense bias, per step), the GroupNorm scale and
  bias rows, and the head zero-padded to 64 output columns. The model's
  ``1/sigma`` output scaling comes back as ``out_scale`` to fold into the
  coefficient tables. The TPU's lane-strided GroupNorm permutation and its
  8-sublane / 128-lane paddings have no counterpart here: a 64-wide GEMM
  tile holds whole 32-feature groups in the natural order.
- kernel K1 ``dense_gn_silu`` (``csrc/dense_gn_silu.cu``) with its plain
  PyTorch version, and ``network_hidden``, which runs the layers with it.
- kernel K7 ``dense_gn_silu_jvp`` (``csrc/dense_gn_silu_jvp.cu``): the same
  layer with its forward-mode tangent, the tangent rules written out by hand
  (port of ``bind_fwd_jvp``), its plain version, and ``network_hidden_jvp``.

``labels`` may be any grid of times: the samplers pass their N steps, the
RK4 integrators their ``2*n_steps + 1`` stage times, and a layer reads row
``i`` of ``tp_all`` either way.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...diffusion.fast_sampler import _group_norm, precompute_time_tables
from . import build

NUM_GROUPS = 32
HEAD_COLS = 64  # the head's output width, zero-padded for 16x16 MMA tiles


def _nvbf16(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.bfloat16).contiguous()


@torch.no_grad()
def build_network_operands(model, labels: torch.Tensor, device=None) -> dict:
    """Kernel operands of a ScoreModelFC for the step labels ``labels`` [N].

    Returns ``W`` (list of bf16 [K, H]: pre-dense, then dense1/dense2 per
    block), ``gn_scale``/``gn_bias`` ([1+2*n_blocks, H] fp32), ``tp_all``
    ([N, 1+2*n_blocks, H] fp32), ``w_post`` ([H, 64] bf16), ``b_post``
    ([64] fp32), ``out_scale`` ([N] or None), on ``device``.
    """
    if model.embedding_type != "positional":
        raise NotImplementedError("the fused kernels support positional embeddings")
    if model.act_name != "swish":
        raise NotImplementedError(f"the fused kernels hardcode SiLU; model uses "
                                  f"{model.act_name!r}")
    dim = model.n_poses * model.pose_dim
    if dim > HEAD_COLS:
        raise NotImplementedError(f"pose dim {dim} > {HEAD_COLS}")
    device = torch.device(device) if device is not None else labels.device
    tprojs, out_scale = precompute_time_tables(model, labels)

    names = ["pre_dense"] + [f"b{b + 1}_dense{j}" for b in range(model.n_blocks)
                             for j in (1, 2)]
    gn_names = ["pre_gnorm"] + [f"b{b + 1}_gnorm{j}" for b in range(model.n_blocks)
                                for j in (1, 2)]
    W = [_nvbf16(getattr(model, n).weight.t()).to(device) for n in names]
    tp_all = torch.stack([tprojs[n + "_t"] + getattr(model, n).bias[None, :]
                          for n in names], dim=1).float()
    gn_scale = torch.stack([getattr(model, n).weight for n in gn_names]).float()
    gn_bias = torch.stack([getattr(model, n).bias for n in gn_names]).float()
    w_post = torch.zeros(model.hidden_dim, HEAD_COLS, dtype=torch.bfloat16)
    w_post[:, :dim] = model.post_dense.weight.t().to(torch.bfloat16).cpu()
    b_post = torch.zeros(HEAD_COLS)
    b_post[:dim] = model.post_dense.bias.float().cpu()
    return dict(W=W, tp_all=tp_all.to(device).contiguous(),
                gn_scale=gn_scale.to(device).contiguous(),
                gn_bias=gn_bias.to(device).contiguous(),
                w_post=w_post.to(device), b_post=b_post.to(device),
                out_scale=out_scale, dim=dim, hidden=model.hidden_dim,
                n_blocks=model.n_blocks)


# ---------------------------------------------------------------------------
# K1 dense_gn_silu
# ---------------------------------------------------------------------------

def dense_gn_silu_plain(a, w, tp_row, gamma, beta, residual=None):
    """``SiLU(GN32(bf16(a) @ w + tp_row)*gamma + beta) [+ residual]`` in
    fp32, with the matmul inputs rounded to bf16 as the kernel rounds them."""
    h = a.to(torch.bfloat16).float() @ w.float() + tp_row
    y = F.silu(_group_norm(h, gamma, beta, num_groups=NUM_GROUPS))
    return y if residual is None else y + residual


def dense_gn_silu_plain_into(a, w, tp_row, gamma, beta, residual=None, out=None):
    """The plain version with the wrapper's signature, on any device: the
    reference path the kernels are held to on the card."""
    y = dense_gn_silu_plain(a, w, tp_row, gamma, beta, residual)
    return y if out is None else out.copy_(y)


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _dense_gn_silu_fn():
    fn = build.load("dense_gn_silu").dposer_dense_gn_silu
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, P]
        fn.restype = I
    return fn


def dense_gn_silu(a, w, tp_row, gamma, beta, residual=None, out=None):
    """K1 on ``a`` [B, K] fp32 and ``w`` [K, N] bf16; writes ``out`` [B, N]
    fp32 (may be ``residual`` itself) and returns it."""
    B, K = a.shape
    N = w.shape[1]
    if out is None:
        out = torch.empty((B, N), dtype=torch.float32, device=a.device)
    dev = a.device
    _check("a", a, dev, torch.float32, (B, K))
    _check("w", w, dev, torch.bfloat16, (K, N))
    for nm, t in (("tp_row", tp_row), ("gamma", gamma), ("beta", beta)):
        _check(nm, t, dev, torch.float32, (N,))
    if residual is not None:
        _check("residual", residual, dev, torch.float32, (B, N))
    _check("out", out, dev, torch.float32, (B, N))
    if dev.type == "cpu":
        return dense_gn_silu_plain_into(a, w, tp_row, gamma, beta, residual, out)
    if dev.type != "cuda":
        raise ValueError(f"dense_gn_silu runs on cpu or cuda, not {dev}")
    gs = N // NUM_GROUPS
    if N % 64 or gs not in (2, 4, 8, 16, 32):
        raise ValueError(f"dense_gn_silu kernel needs N % 64 == 0 and a group "
                         f"size N/32 in {{2,4,8,16,32}}; got N={N}")
    err = _dense_gn_silu_fn()(a.data_ptr(), w.data_ptr(), tp_row.data_ptr(),
                              gamma.data_ptr(), beta.data_ptr(), _ptr(residual),
                              out.data_ptr(), B, K, N,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"dense_gn_silu launch failed: CUDA error {err}")
    dense_gn_silu.launches += 1
    return out


dense_gn_silu.launches = 0


def network_hidden(net: dict, x: torch.Tensor, i: int, h: torch.Tensor,
                   h1: torch.Tensor, layer=dense_gn_silu) -> torch.Tensor:
    """The network's last hidden activation at row ``i`` of the time grid into ``h``
    (``h1`` is scratch): ``layer`` (K1, or its plain version) once for the
    pre layer and twice per block."""
    tp = net["tp_all"][i]
    W, gs, gb = net["W"], net["gn_scale"], net["gn_bias"]
    layer(x, W[0], tp[0], gs[0], gb[0], out=h)
    for blk in range(net["n_blocks"]):
        j = 1 + 2 * blk
        layer(h, W[j], tp[j], gs[j], gb[j], out=h1)
        layer(h1, W[j + 1], tp[j + 1], gs[j + 1], gb[j + 1], residual=h, out=h)
    return h


# ---------------------------------------------------------------------------
# K7 dense_gn_silu_jvp
# ---------------------------------------------------------------------------

def dense_gn_silu_jvp_plain(a, da, w, tp_row, gamma, beta, residual=None, dresidual=None):
    """Plain K7: ``(out, dout)``, K1's layer and its tangent along ``da``, the
    rules of the kernel written out in fp32 (matmul inputs rounded to bf16)."""
    wf = w.float()
    h = a.to(torch.bfloat16).float() @ wf + tp_row
    dh = da.to(torch.bfloat16).float() @ wf
    B, N = h.shape

    def mean_g(v):
        return v.reshape(B, NUM_GROUPS, N // NUM_GROUPS).mean(-1, keepdim=True) \
            .expand(B, NUM_GROUPS, N // NUM_GROUPS).reshape(B, N)

    d = h - mean_g(h)
    rstd = torch.rsqrt(mean_g(d * d) + 1e-5)
    drstd = -0.5 * rstd ** 3 * (2.0 * mean_g(d * dh))
    y = d * rstd * gamma + beta
    dy = ((dh - mean_g(dh)) * rstd + d * drstd) * gamma
    sig = torch.sigmoid(y)
    out, dout = y * sig, sig * (1.0 + y * (1.0 - sig)) * dy
    if residual is not None:
        out, dout = out + residual, dout + dresidual
    return out, dout


def dense_gn_silu_jvp_plain_into(a, da, w, tp_row, gamma, beta, residual=None,
                                 dresidual=None, out=None, dout=None):
    """The plain version with the wrapper's signature, on any device."""
    y, dy = dense_gn_silu_jvp_plain(a, da, w, tp_row, gamma, beta, residual, dresidual)
    if out is None:
        return y, dy
    return out.copy_(y), dout.copy_(dy)


def _dense_gn_silu_jvp_fn():
    fn = build.load("dense_gn_silu_jvp").dposer_dense_gn_silu_jvp
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 10 + [I, I, I, P]
        fn.restype = I
    return fn


def dense_gn_silu_jvp(a, da, w, tp_row, gamma, beta, residual=None, dresidual=None,
                      out=None, dout=None):
    """K7 on ``a``, ``da`` [B, K] fp32 and ``w`` [K, N] bf16; writes ``out``
    and ``dout`` [B, N] fp32 (which may be ``residual`` and ``dresidual``
    themselves) and returns them."""
    B, K = a.shape
    N = w.shape[1]
    dev = a.device
    if (out is None) != (dout is None) or (residual is None) != (dresidual is None):
        raise ValueError("out/dout and residual/dresidual come in pairs")
    if out is None:
        out = torch.empty((B, N), dtype=torch.float32, device=dev)
        dout = torch.empty_like(out)
    _check("a", a, dev, torch.float32, (B, K))
    _check("da", da, dev, torch.float32, (B, K))
    _check("w", w, dev, torch.bfloat16, (K, N))
    for nm, t in (("tp_row", tp_row), ("gamma", gamma), ("beta", beta)):
        _check(nm, t, dev, torch.float32, (N,))
    for nm, t in (("residual", residual), ("dresidual", dresidual), ("out", out),
                  ("dout", dout)):
        if t is not None:
            _check(nm, t, dev, torch.float32, (B, N))
    if dev.type == "cpu":
        return dense_gn_silu_jvp_plain_into(a, da, w, tp_row, gamma, beta, residual,
                                            dresidual, out, dout)
    if dev.type != "cuda":
        raise ValueError(f"dense_gn_silu_jvp runs on cpu or cuda, not {dev}")
    gs = N // NUM_GROUPS
    if N % 64 or gs not in (2, 4, 8, 16, 32):
        raise ValueError(f"dense_gn_silu_jvp kernel needs N % 64 == 0 and a group "
                         f"size N/32 in {{2,4,8,16,32}}; got N={N}")
    err = _dense_gn_silu_jvp_fn()(a.data_ptr(), da.data_ptr(), w.data_ptr(),
                                  tp_row.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                  _ptr(residual), _ptr(dresidual), out.data_ptr(),
                                  dout.data_ptr(), B, K, N,
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"dense_gn_silu_jvp launch failed: CUDA error {err}")
    dense_gn_silu_jvp.launches += 1
    return out, dout


dense_gn_silu_jvp.launches = 0


def network_hidden_jvp(net: dict, x, dx, i: int, bufs, layer=dense_gn_silu_jvp):
    """The network's last hidden activation at row ``i`` of the time grid and
    its tangent along ``dx``, into ``bufs = (h, dh, h1, dh1)`` (the last two
    are scratch): ``layer`` (K7, or its plain version) once for the pre layer
    and twice per block. Returns ``(h, dh)``."""
    h, dh, h1, dh1 = bufs
    tp = net["tp_all"][i]
    W, gs, gb = net["W"], net["gn_scale"], net["gn_bias"]
    layer(x, dx, W[0], tp[0], gs[0], gb[0], out=h, dout=dh)
    for blk in range(net["n_blocks"]):
        j = 1 + 2 * blk
        layer(h, dh, W[j], tp[j], gs[j], gb[j], out=h1, dout=dh1)
        layer(h1, dh1, W[j + 1], tp[j + 1], gs[j + 1], gb[j + 1], residual=h,
              dresidual=dh, out=h, dout=dh)
    return h, dh
