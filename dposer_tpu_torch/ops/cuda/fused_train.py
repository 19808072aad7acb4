"""The DSM train step with the network's forward and backward as CUDA kernels.

Port of ``dposer_tpu/ops/pallas/fused_train.py``. The TPU kernel keeps a
batch block's whole forward, the loss seed and the backward data chain in
VMEM; an SM cannot hold the 8 MB of bf16 weights, so here each layer is a
launch, 11 a step:

- K10 ``dense_gn_silu_train`` (``csrc/dense_gn_silu_train.cu``), 1 + 2 *
  n_blocks launches: ``bf16(A) @ W + proj``, GroupNorm, SiLU, dropout and
  the block's residual; it writes the layer's output, its bf16 copy (the
  stash: the next dense layer's A, which the weight-gradient GEMMs read
  too), bf16 xhat and rstd per (row, group). The activations are handed on
  in bf16: every layer but the pre one reads the stash the layer before
  wrote (the Hopper route, ``csrc/dense_wgmma_ss.cuh``), which is the
  product's rounding of the fp32 output anyway; the pre layer reads the fp32
  perturbed pose (the register route). A block's first layer writes no fp32
  output, since only its stash is read, and neither does the last layer.
- K11 ``head_dsm`` (``csrc/head_dsm.cu``), 1 launch: the post-dense and the
  DSM loss seed, per-row losses and ``dout``, reading the last layer's stash
  (split-K over a thread-block cluster, ``csrc/head_cluster.cuh``).
- K12 ``dense_gn_silu_bwd`` (``csrc/dense_gn_silu_bwd.cu``), 1 + 2 *
  n_blocks launches, all on the Hopper loop of ``csrc/dense_wgmma_ss.cuh``:
  the hop ``dh_next @ W_next^T`` (+ the residual stream's carried gradient),
  then the dropout, SiLU and GroupNorm backward, writing bf16 ``dh`` and
  dgamma and dbeta (per-row-block sums that the kernel's last CTA of each
  column tile adds in a fixed order).

Everything around them is plain PyTorch, as it is plain XLA in JAX: the
time-embedding path (differentiated by autograd through the per-row
projections it feeds), the weight-gradient GEMMs ``dW = in^T @ dh``, the
bias folding, and the clip, Adam and EMA of ``diffusion/losses.py``.

Dropout masks come from a counter-based hash of (seed, layer, row, column)
(``csrc/dropout_hash.cuh``), so K12 regenerates K10's mask; ``dropout_keep``
computes the same bits in int64 arithmetic, and the plain versions use it.
The stream differs from the autograd route's, as the TPU kernel's differs
from XLA's.

Numerics: the matmul operands are rounded to the weights' dtype (bf16 on the
card; the plain versions also take fp32 weights, the exactness mode the CPU
tests hold to JAX); GroupNorm statistics are fp32 (the TPU kernel rounds its
group-indicator matmuls to bf16). The weights are fp32 parameters, cast to
bf16 inside the step, ``W`` for the forward and the Linear weight itself,
which is ``W^T``, for the backward hops. The weight-gradient GEMMs multiply
bf16-valued fp32 operands, exact under TF32, and the kernel route's
loss-and-gradient call runs with TF32 enabled (``tf32``), its time path
included; it is restored after.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from ...diffusion.sde import SDE, VPSDE, SubVPSDE
from ...models.time_embedding import get_timestep_embedding
from . import build
from .score_net import HEAD_COLS, NUM_GROUPS, _check, _ptr

GN_EPS = 1e-5
KEEP_BITS = 24
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_COL_MUL = 0x85EBCA6B


# ---------------------------------------------------------------------------
# The dropout hash (csrc/dropout_hash.cuh), exact in int64 arithmetic
# ---------------------------------------------------------------------------

def _mul32(a, c: int):
    """``a * c mod 2^32`` for 32-bit ``a`` (int or int64 tensor): ``c`` in
    16-bit halves, so no product passes 2^48."""
    return ((a * (c & 0xFFFF)) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


@functools.lru_cache(maxsize=None)
def keep_threshold(keep: float) -> int:
    """The kernels' integer keep test: top 24 hash bits below this; 2^24
    (keep >= 1) turns dropout off."""
    return min(1 << KEEP_BITS, int(round(keep * (1 << KEEP_BITS))))


def dropout_keep(seed: int, layer: int, rows: int, cols: int, keep: float,
                 device=None) -> torch.Tensor:
    """Bool [rows, cols]: the elements K10 and K12 keep at (seed, layer)."""
    lkey = _fmix32((seed & _M32) ^ _fmix32((layer + _GOLDEN) & _M32))
    r = torch.arange(rows, dtype=torch.int64, device=device)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    rkey = _fmix32(lkey ^ _mul32(r, _GOLDEN))
    u = _fmix32(rkey[:, None] ^ _mul32(c, _COL_MUL)[None, :])
    return (u >> 8) < keep_threshold(keep)


def dropout_mask(seed: int, layer: int, rows: int, cols: int, keep: float,
                 device=None) -> Optional[torch.Tensor]:
    """fp32 [rows, cols] of 0 and 1/keep, the factor the kernels apply, or
    None when nothing is dropped."""
    if keep_threshold(keep) >= 1 << KEEP_BITS:
        return None
    kept = dropout_keep(seed, layer, rows, cols, keep, device)
    return kept.float() * torch.tensor(1.0 / keep, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _inv_keep(keep: float) -> float:
    return float(torch.tensor(1.0 / keep, dtype=torch.float32))


def _mean_g(v: torch.Tensor) -> torch.Tensor:
    B, N = v.shape
    return v.reshape(B, NUM_GROUPS, N // NUM_GROUPS).mean(-1, keepdim=True)


# ---------------------------------------------------------------------------
# Plain versions (the weights' dtype is the compute dtype: bf16 or fp32)
# ---------------------------------------------------------------------------

def dense_gn_silu_train_plain(a, w, proj, gamma, beta, seed: int, layer: int, keep: float,
                              residual=None, a_b=None):
    """Plain K10: ``(out fp32, out in w's dtype, xhat in w's dtype, rstd
    [B, 32] fp32)``. ``a_b``, ``a`` already in w's dtype (the stash the
    layer before wrote), takes the place of ``a``, which may then be None.
    The stash is a tensor of its own, also in fp32."""
    cdt = w.dtype
    h = (a.to(cdt) if a_b is None else a_b).float() @ w.float() + proj.float()
    B, N = h.shape
    hg = h.reshape(B, NUM_GROUPS, N // NUM_GROUPS)
    d = hg - hg.mean(-1, keepdim=True)
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + GN_EPS)
    xhat = (d * rstd).reshape(B, N)
    s = F.silu(xhat * gamma + beta)
    mask = dropout_mask(seed, layer, B, N, keep, h.device)
    if mask is not None:
        s = s * mask
    out = s if residual is None else s + residual
    return out, out.to(cdt, copy=True), xhat.to(cdt), rstd.reshape(B, NUM_GROUPS)


def head_dsm_plain(h, w_post, b_post, coefs, z):
    """Plain K11: ``(loss_rows [B], dout [B, D])`` with ``w_post`` [H, 64]
    (zero-padded), ``b_post`` [64], ``coefs`` [B, 3] = (a, v, s); ``h`` fp32
    or already in ``w_post``'s dtype (rounded first either way)."""
    D = z.shape[1]
    out = (h.to(w_post.dtype).float() @ w_post.float() + b_post)[:, :D]
    a, v, s = coefs[:, 0:1], coefs[:, 1:2], coefs[:, 2:3]
    r = a * out + v * z
    return s[:, 0] * (r * r).sum(1), 2.0 * s * a * r


def dense_gn_silu_bwd_plain(dh_next, w_t, xhat, rstd, gamma, beta, seed: int, layer: int,
                            keep: float, g_res=None):
    """Plain K12: ``(dh in w_t's dtype, g fp32, dgamma [N], dbeta [N])``."""
    g = dh_next.float() @ w_t.float()
    if g_res is not None:
        g = g + g_res
    B, N = g.shape
    gd = g
    mask = dropout_mask(seed, layer, B, N, keep, g.device)
    if mask is not None:
        gd = g * mask
    xh = xhat.float()
    y = xh * gamma + beta
    sig = torch.sigmoid(y)
    g_gn = sig * (1.0 + y * (1.0 - sig)) * gd
    gx = g_gn * gamma

    def bcast(m):
        return m.expand(B, NUM_GROUPS, N // NUM_GROUPS).reshape(B, N)

    rs = bcast(rstd.reshape(B, NUM_GROUPS, 1))
    g_pre = rs * (gx - bcast(_mean_g(gx)) - xh * bcast(_mean_g(gx * xh)))
    return g_pre.to(w_t.dtype), g, (g_gn * xh).sum(0), g_gn.sum(0)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _lib_fn(lib: str, sym: str, argtypes: list):
    fn = getattr(build.load(lib), sym)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


def _kernel_device(name: str, dev: torch.device, cdt, N: int) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if cdt != torch.bfloat16:
        raise TypeError(f"the {name} kernel computes in bf16; fp32 weights run the "
                        f"plain version on the CPU only")
    if N % 64 or N // NUM_GROUPS not in (2, 4, 8, 16, 32):
        raise ValueError(f"{name} kernel needs N % 64 == 0 and a group size N/32 in "
                         f"{{2,4,8,16,32}}; got N={N}")


def check_stash_input(a_b, w, B: int, K: int) -> None:
    """Raise unless K10's Hopper route can take ``a_b`` as A: ``w``'s dtype,
    [B, K] contiguous, 16-byte aligned, K % 8 == 0 (TMA rows). Checked on
    every device, so the CPU's plain path takes the operands the card
    takes."""
    _check("a_b", a_b, w.device, w.dtype, (B, K))
    if a_b.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("a_b and w must be 16-byte aligned for TMA")
    if K % 8:
        raise ValueError(f"a_b needs K % 8 == 0 (16-byte TMA rows); got K={K}")


def dense_gn_silu_train(a, w, proj, gamma, beta, seed: int, layer: int, keep: float,
                        residual=None, out=None, stash=None, xhat=None, rstd=None, *,
                        a_b=None, write_out: bool = True):
    """K10 on ``a`` [B, K] fp32, ``w`` [K, N] and ``proj`` [B, N] in the
    compute dtype; returns ``(out, stash, xhat, rstd)`` (allocated when not
    given; ``out`` may be ``residual`` itself).

    ``a_b`` [B, K] in the compute dtype, the stash the layer before wrote,
    routes the layer through the Hopper loop (TMA and ``wgmma`` from shared
    memory; ``a`` may then be None); without it the register-staged loop
    rounds ``a``. ``write_out=False`` writes no fp32 output (``out`` is then
    None): the caller reads only the stash. Each launch adds one to
    ``launches`` and to its route's count in ``routes``."""
    B, K = (a if a_b is None else a_b).shape
    N = w.shape[1]
    dev, cdt = w.device, w.dtype
    if not write_out:
        if out is not None:
            raise ValueError("write_out=False takes no out")
    elif out is None:
        out = torch.empty((B, N), dtype=torch.float32, device=dev)
    if stash is None:
        stash = torch.empty((B, N), dtype=cdt, device=dev)
    if xhat is None:
        xhat = torch.empty((B, N), dtype=cdt, device=dev)
    if rstd is None:
        rstd = torch.empty((B, NUM_GROUPS), dtype=torch.float32, device=dev)
    if a_b is None or a is not None:
        _check("a", a, dev, torch.float32, (B, K))
    _check("w", w, dev, cdt, (K, N))
    _check("proj", proj, dev, cdt, (B, N))
    for nm, t in (("gamma", gamma), ("beta", beta)):
        _check(nm, t, dev, torch.float32, (N,))
    if residual is not None:
        _check("residual", residual, dev, torch.float32, (B, N))
    if out is not None:
        _check("out", out, dev, torch.float32, (B, N))
    _check("stash", stash, dev, cdt, (B, N))
    _check("xhat", xhat, dev, cdt, (B, N))
    _check("rstd", rstd, dev, torch.float32, (B, NUM_GROUPS))
    if a_b is not None:
        check_stash_input(a_b, w, B, K)
    if dev.type == "cpu":
        res = dense_gn_silu_train_plain(a, w, proj, gamma, beta, seed, layer, keep, residual,
                                        a_b=a_b)
        for dst, src in zip((out, stash, xhat, rstd), res):
            if dst is not None:
                dst.copy_(src)
        return out, stash, xhat, rstd
    _kernel_device("dense_gn_silu_train", dev, cdt, N)
    hopper = a_b is not None
    fn = _lib_fn("dense_gn_silu_train", "dposer_dense_gn_silu_train",
                 [_P] * 11 + [_U, _I, _U, _F, _I, _I, _I, _P])
    err = fn(None if hopper else a.data_ptr(), _ptr(a_b), w.data_ptr(), proj.data_ptr(),
             gamma.data_ptr(), beta.data_ptr(), _ptr(residual), _ptr(out), stash.data_ptr(),
             xhat.data_ptr(), rstd.data_ptr(), seed & 0xFFFFFFFF, layer, keep_threshold(keep),
             _inv_keep(keep), B, K, N, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"dense_gn_silu_train launch failed: CUDA error {err}")
    dense_gn_silu_train.launches += 1
    dense_gn_silu_train.routes["wgmma" if hopper else "register"] += 1
    return out, stash, xhat, rstd


dense_gn_silu_train.launches = 0
dense_gn_silu_train.routes = {"wgmma": 0, "register": 0}


def head_dsm(h, w_post, b_post, coefs, z, loss_rows=None, dout=None):
    """K11 on ``h`` [B, H] with ``w_post`` [H, 64] in the compute dtype;
    returns ``(loss_rows [B], dout [B, D])`` fp32. ``h`` is fp32 or in the
    compute dtype: the train step hands the kernel its stash of the last
    block's output, which is ``h`` rounded as the head rounds it, so both
    give the same bits (on the card each launches its own instantiation)."""
    B, H = h.shape
    D = z.shape[1]
    dev, cdt = h.device, w_post.dtype
    if loss_rows is None:
        loss_rows = torch.empty((B,), dtype=torch.float32, device=dev)
    if dout is None:
        dout = torch.empty((B, D), dtype=torch.float32, device=dev)
    if h.dtype not in (torch.float32, cdt):
        raise TypeError(f"h has dtype {h.dtype}, expected float32 or {cdt}")
    _check("h", h, dev, h.dtype, (B, H))
    _check("w_post", w_post, dev, cdt, (H, HEAD_COLS))
    _check("b_post", b_post, dev, torch.float32, (HEAD_COLS,))
    _check("coefs", coefs, dev, torch.float32, (B, 3))
    _check("z", z, dev, torch.float32, (B, D))
    _check("loss_rows", loss_rows, dev, torch.float32, (B,))
    _check("dout", dout, dev, torch.float32, (B, D))
    if dev.type == "cpu":
        lr, do = head_dsm_plain(h, w_post, b_post, coefs, z)
        return loss_rows.copy_(lr), dout.copy_(do)
    if dev.type != "cuda":
        raise ValueError(f"head_dsm runs on cpu or cuda, not {dev}")
    if cdt != torch.bfloat16:
        raise TypeError("the head_dsm kernel computes in bf16")
    if H % 64 or H > 1024 or D > HEAD_COLS:
        raise ValueError(f"head_dsm kernel needs H % 64 == 0, H <= 1024 and D <= 64; "
                         f"got H={H}, D={D}")
    if h.data_ptr() % 16 or w_post.data_ptr() % 16:
        raise ValueError("head_dsm kernel needs h and w_post 16-byte aligned (bulk copies)")
    fn = _lib_fn("head_dsm", "dposer_head_dsm", [_P, _I] + [_P] * 6 + [_I, _I, _I, _P])
    err = fn(h.data_ptr(), int(h.dtype == torch.bfloat16), w_post.data_ptr(),
             b_post.data_ptr(), coefs.data_ptr(), z.data_ptr(), loss_rows.data_ptr(),
             dout.data_ptr(), B, H, D, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"head_dsm launch failed: CUDA error {err}")
    head_dsm.launches += 1
    return loss_rows, dout


head_dsm.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_tile_rows() -> int:
    """The rows a K12 CTA sums dgamma and dbeta over (the partials' rows are
    ceil(B / this))."""
    fn = _lib_fn("dense_gn_silu_bwd", "dposer_dense_gn_silu_bwd_tile_rows", [])
    return int(fn())


def dense_gn_silu_bwd(dh_next, w_t, xhat, rstd, gamma, beta, seed: int, layer: int,
                      keep: float, g_res=None, g_out=None, dh=None):
    """K12 on ``dh_next`` [B, K] and ``w_t`` [K, N] in the compute dtype (on
    the card K % 8 == 0 and both 16-byte aligned: TMA rows); returns ``(dh
    [B, N], g_out, dgamma [N], dbeta [N])``. ``g_out`` (may be ``g_res``
    itself) receives the hop's fp32 gradient when given. Each launch adds one
    to ``launches`` and to ``routes["wgmma"]``, its one route."""
    B, K = dh_next.shape
    N = w_t.shape[1]
    dev, cdt = dh_next.device, w_t.dtype
    if dh is None:
        dh = torch.empty((B, N), dtype=cdt, device=dev)
    _check("dh_next", dh_next, dev, cdt, (B, K))
    _check("w_t", w_t, dev, cdt, (K, N))
    _check("xhat", xhat, dev, cdt, (B, N))
    _check("rstd", rstd, dev, torch.float32, (B, NUM_GROUPS))
    for nm, t in (("gamma", gamma), ("beta", beta)):
        _check(nm, t, dev, torch.float32, (N,))
    for nm, t in (("g_res", g_res), ("g_out", g_out)):
        if t is not None:
            _check(nm, t, dev, torch.float32, (B, N))
    _check("dh", dh, dev, cdt, (B, N))
    if dev.type == "cpu":
        d, g, dg, db = dense_gn_silu_bwd_plain(dh_next, w_t, xhat, rstd, gamma, beta, seed,
                                               layer, keep, g_res)
        if g_out is not None:
            g_out.copy_(g)
        return dh.copy_(d), g_out, dg, db
    _kernel_device("dense_gn_silu_bwd", dev, cdt, N)
    if K % 8 or dh_next.data_ptr() % 16 or w_t.data_ptr() % 16:
        raise ValueError(f"dense_gn_silu_bwd kernel needs K % 8 == 0 (zero-pad) and dh_next, "
                         f"w_t 16-byte aligned (TMA rows); got K={K}")
    n_blk = -(-B // _bwd_tile_rows())
    parts = torch.empty((2, n_blk, N), dtype=torch.float32, device=dev)
    fn = _lib_fn("dense_gn_silu_bwd", "dposer_dense_gn_silu_bwd",
                 [_P] * 11 + [_U, _I, _U, _F, _I, _I, _I, _P])
    err = fn(dh_next.data_ptr(), w_t.data_ptr(), _ptr(g_res), _ptr(g_out), xhat.data_ptr(),
             rstd.data_ptr(), gamma.data_ptr(), beta.data_ptr(), dh.data_ptr(),
             parts[0].data_ptr(), parts[1].data_ptr(), seed & 0xFFFFFFFF, layer,
             keep_threshold(keep), _inv_keep(keep), B, K, N,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"dense_gn_silu_bwd launch failed: CUDA error {err}")
    dense_gn_silu_bwd.launches += 1
    dense_gn_silu_bwd.routes["wgmma"] += 1
    # the kernel added the row blocks' partials in a fixed order into row 0
    return dh, g_out, parts[0, 0], parts[1, 0]


dense_gn_silu_bwd.launches = 0
dense_gn_silu_bwd.routes = {"wgmma": 0}


def dense_gn_silu_train_plain_into(a, w, proj, gamma, beta, seed: int, layer: int,
                                   keep: float, residual=None, out=None, *, a_b=None,
                                   write_out: bool = True, **_):
    """The plain K10 with the wrapper's signature, on any device: the
    reference path the kernels are held to on the card."""
    res = dense_gn_silu_train_plain(a, w, proj, gamma, beta, seed, layer, keep, residual,
                                    a_b=a_b)
    if not write_out:
        return (None,) + res[1:]
    return res if out is None else (out.copy_(res[0]),) + res[1:]


def dense_gn_silu_bwd_plain_into(dh_next, w_t, xhat, rstd, gamma, beta, seed: int,
                                 layer: int, keep: float, g_res=None, g_out=None, **_):
    """The plain K12 with the wrapper's signature, on any device."""
    dh, g, dg, db = dense_gn_silu_bwd_plain(dh_next, w_t, xhat, rstd, gamma, beta, seed,
                                            layer, keep, g_res)
    return dh, None if g_out is None else g_out.copy_(g), dg, db


PLAIN_LAYERS = SimpleNamespace(fwd=dense_gn_silu_train_plain_into, head=head_dsm_plain,
                               bwd=dense_gn_silu_bwd_plain_into)
KERNEL_LAYERS = SimpleNamespace(fwd=dense_gn_silu_train, head=head_dsm, bwd=dense_gn_silu_bwd)


# ---------------------------------------------------------------------------
# The network's forward and backward as an autograd Function
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tf32(enabled: bool = True):
    """TF32 tensor-core matmuls inside the block only; the previous setting
    is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _copy_as(dst_dtype, src):
    return torch.empty(src.shape, dtype=dst_dtype, device=src.device).copy_(src)


def _padded(src, rows: int, cols: int, dtype):
    out = torch.zeros((rows, cols), dtype=dtype, device=src.device)
    out[:src.shape[0], :src.shape[1]].copy_(src)
    return out


def kernel_weights(cdt, w_post, b_post, weights) -> dict:
    """The kernels' copies of the fp32 weights in the compute dtype, rebuilt
    every step: ``w_fwd`` [in, out] per dense layer, ``w_bwd`` [out, in]
    (the Linear weight: W^T, the backward hop into layer j reads j + 1's),
    the head ``wpost_k`` [H, 64] and ``wpost_t`` [64, H] zero-padded from 63
    columns, and ``bpost`` [64] fp32."""
    H = weights[0].shape[0]
    return dict(w_fwd=[_copy_as(cdt, w.t()) for w in weights],
                w_bwd=[_copy_as(cdt, w) for w in weights[1:]],
                wpost_k=_padded(w_post.t(), H, HEAD_COLS, cdt),
                wpost_t=_padded(w_post, HEAD_COLS, H, cdt),
                bpost=_padded(b_post[None], 1, HEAD_COLS, torch.float32)[0])


class _DSMNet(torch.autograd.Function):
    """``loss = sum_rows s * |a * net(x_pert) + v * z|^2`` through K10 x
    n_tp, K11 and, backward, K12 x n_tp. Inputs are fp32: ``proj`` [B, n_tp,
    H] (each layer's per-row time projection with both biases), the
    GroupNorm rows ``gn_w``/``gn_b`` [n_tp, H], the head's weight [D, H] and
    bias [D], and the dense weights ([out, in], torch's layout). The grads
    returned are dproj = dh, dgamma, dbeta, and the weights' ``in^T @ dh``."""

    @staticmethod
    def forward(ctx, cfg, x_pert, z, coefs, proj, gn_w, gn_b, w_post, b_post, *weights):
        cdt, seed, keep = cfg.cdt, cfg.seed, cfg.keep
        n_tp = len(weights)
        w_fwd, w_bwd, wpost_k, wpost_t, bpost = kernel_weights(cdt, w_post, b_post,
                                                                weights).values()
        proj_c = _copy_as(cdt, proj.transpose(0, 1))  # [n_tp, B, H]
        x_pert = x_pert.contiguous()
        fwd = cfg.layers.fwd
        h, st, xh, rs = fwd(x_pert, w_fwd[0], proj_c[0], gn_w[0], gn_b[0], seed, 0, keep)
        stash, xhats, rstds = [st], [xh], [rs]
        # every layer after the pre one reads the stash of the layer before;
        # a block's first layer and the last layer write only their stash
        # (the head reads the last one: h rounded as the head rounds it)
        for j in range(1, n_tp, 2):
            _, st, xh, rs = fwd(None, w_fwd[j], proj_c[j], gn_w[j], gn_b[j], seed, j, keep,
                                a_b=stash[-1], write_out=False)
            stash.append(st), xhats.append(xh), rstds.append(rs)
            last = j + 2 >= n_tp
            h, st, xh, rs = fwd(None, w_fwd[j + 1], proj_c[j + 1], gn_w[j + 1], gn_b[j + 1],
                                seed, j + 1, keep, residual=h, out=None if last else h,
                                a_b=stash[-1], write_out=not last)
            stash.append(st), xhats.append(xh), rstds.append(rs)
        loss_rows, dout = cfg.layers.head(stash[-1], wpost_k, bpost, coefs, z)
        ctx.cfg = cfg
        ctx.bufs = (x_pert, w_bwd, wpost_t, stash, xhats, rstds, dout)
        ctx.save_for_backward(gn_w, gn_b)
        return loss_rows.sum()

    @staticmethod
    def backward(ctx, grad_loss):
        cfg = ctx.cfg
        cdt, seed, keep = cfg.cdt, cfg.seed, cfg.keep
        x_pert, w_bwd, wpost_t, stash, xhats, rstds, dout = ctx.bufs
        del ctx.bufs
        gn_w, gn_b = ctx.saved_tensors
        n_tp = len(stash)
        B, D = dout.shape
        H = gn_w.shape[1]
        dout = dout * grad_loss
        dpad = _padded(dout, B, HEAD_COLS, cdt)
        dh, dgam, dbet = [None] * n_tp, [None] * n_tp, [None] * n_tp
        g_carry = torch.empty((B, H), dtype=torch.float32, device=dout.device)
        for j in reversed(range(n_tp)):
            last = j == n_tp - 1
            g_res = g_carry if j % 2 == 0 and not last else None
            g_out = g_carry if j % 2 == 0 and j > 0 else None
            dh[j], _, dgam[j], dbet[j] = cfg.layers.bwd(
                dpad if last else dh[j + 1], wpost_t if last else w_bwd[j], xhats[j],
                rstds[j], gn_w[j], gn_b[j], seed, j, keep, g_res=g_res, g_out=g_out)
        with tf32(cfg.tf32):
            ins = [x_pert.to(cdt)] + stash[:-1]
            d_w = [torch.matmul(dh[j].float().t(), ins[j].float()) for j in range(n_tp)]
            d_wpost = torch.matmul(dpad[:, :D].float().t(), stash[-1].float())
        d_proj = torch.stack(dh, dim=1).float()
        return (None, None, None, None, d_proj, torch.stack(dgam), torch.stack(dbet),
                d_wpost, dout.sum(0), *d_w)


# ---------------------------------------------------------------------------
# The loss and the step
# ---------------------------------------------------------------------------

def scope_error(sde: SDE, model, continuous: bool = True,
                auxiliary_loss: bool = False) -> Optional[str]:
    """Why ``model`` under ``sde`` is outside the kernels' scope, or None."""
    dim = model.n_poses * model.pose_dim
    hidden = model.hidden_dim
    if not isinstance(sde, (VPSDE, SubVPSDE)) or not continuous:
        return "the train kernels support continuous VP/subVP DSM only"
    if auxiliary_loss:
        return "the auxiliary body loss is outside the train kernels' scope"
    if model.embedding_type != "positional":
        return "the train kernels need positional time embeddings"
    if model.act_name != "swish":
        return "the train kernels hardcode SiLU"
    if model.n_blocks > 3:
        return "the train kernels support n_blocks <= 3"
    # K10/K12's GroupNorm epilogue holds whole groups of H/32 <= 32 features
    # in a 64-wide tile; K11's head tile is 64 columns wide and <= 1024 deep
    if hidden % 64 or hidden // NUM_GROUPS not in (2, 4, 8, 16, 32):
        return f"the train kernels need hidden % 64 == 0 and hidden/32 <= 32 (got {hidden})"
    if dim > HEAD_COLS:
        return f"the train kernels need a pose dim <= {HEAD_COLS} (got {dim})"
    return None


def get_cuda_train_loss_fn(sde: SDE, model, *, reduce_mean: bool = False,
                           likelihood_weighting: bool = False, eps: float = 1e-5,
                           compute_dtype=torch.bfloat16, plain: bool = False):
    """``loss_fn(batch, t=None, z=None, dropout_seed=None, generator=None) ->
    loss``: continuous VP/subVP DSM through the kernels, differentiable in
    ``model``'s parameters (autograd runs K12 and the GEMMs around it).

    ``t`` [B] and ``z`` [B, D] are drawn from ``generator`` when not given,
    as the autograd loss draws them; ``dropout_seed`` keys the kernels' mask
    hash (drawn from ``generator`` when not given). ``compute_dtype=float32``
    (CPU only) is the exactness mode; ``plain=True`` runs the kernels' plain
    versions on any device. Raises NotImplementedError outside the kernels'
    scope (``scope_error``)."""
    why = scope_error(sde, model)
    if why is not None:
        raise NotImplementedError(why)
    n_blocks = model.n_blocks
    dense = [model.pre_dense] + [getattr(model, f"b{b + 1}_dense{d}")
                                 for b in range(n_blocks) for d in (1, 2)]
    dense_t = [model.pre_dense_t] + [getattr(model, f"b{b + 1}_dense{d}_t")
                                     for b in range(n_blocks) for d in (1, 2)]
    gnorms = [model.pre_gnorm] + [getattr(model, f"b{b + 1}_gnorm{d}")
                                  for b in range(n_blocks) for d in (1, 2)]
    layers = PLAIN_LAYERS if plain else KERNEL_LAYERS
    keep = 1.0 - float(model.dropout.p)
    n_tp = len(dense)

    def inputs(batch, t, z):
        """``(x_pert, proj [B, n_tp, H], coefs [B, 3], gn_w, gn_b)``; proj and
        the GroupNorm rows carry autograd to the parameters."""
        B, D = batch.shape
        mean, std = sde.marginal_prob(batch, t)
        x_pert = mean + std[:, None] * z
        labels = t * 999
        temb = model.shared_time_embed(get_timestep_embedding(labels, model.embed_dim))
        w_t = torch.cat([m.weight for m in dense_t], 0)  # [n_tp*H, E]
        b_t = torch.cat([mt.bias + m.bias for mt, m in zip(dense_t, dense)], 0)
        proj = F.linear(temb, w_t, b_t).reshape(B, n_tp, -1)

        with torch.no_grad():
            oscale = (1.0 / model.sigmas[labels.long()] if model.scale_by_sigma
                      else torch.ones_like(t))
            red = (1.0 / D) if reduce_mean else 0.5
            if likelihood_weighting:
                g2 = sde.sde(torch.zeros_like(batch), t)[1] ** 2
                coefs = torch.stack([-oscale / std, 1.0 / std, g2 * (red / B)], 1)
            else:
                coefs = torch.stack([-oscale, torch.ones_like(t),
                                     torch.full_like(t, red / B)], 1)
        gn_w = torch.stack([g.weight for g in gnorms])
        gn_b = torch.stack([g.bias for g in gnorms])
        return x_pert.detach(), proj, coefs.contiguous().float(), gn_w, gn_b

    def loss_fn(batch, t=None, z=None, dropout_seed=None, generator=None):
        B = batch.shape[0]
        dev = batch.device
        if t is None:
            t = torch.rand(B, generator=generator, device=dev) * (sde.T - eps) + eps
        if z is None:
            z = torch.randn(batch.shape, generator=generator, device=dev)
        if dropout_seed is None:
            dropout_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                             device=dev))
        x_pert, proj, coefs, gn_w, gn_b = inputs(batch, t, z)
        cfg = SimpleNamespace(cdt=compute_dtype, seed=int(dropout_seed), keep=keep,
                              layers=layers, tf32=dev.type == "cuda")
        return _DSMNet.apply(cfg, x_pert, z.contiguous(), coefs, proj, gn_w, gn_b,
                             model.post_dense.weight, model.post_dense.bias,
                             *[m.weight for m in dense])

    @torch.no_grad()
    def operands(batch, t, z) -> dict:
        """What the kernels are handed for ``batch``, ``t`` and ``z``: the
        inputs of ``inputs`` in the kernels' layouts and ``kernel_weights``."""
        x_pert, proj, coefs, gn_w, gn_b = inputs(batch, t, z)
        return dict(x_pert=x_pert, z=z.contiguous(), coefs=coefs, gn_w=gn_w, gn_b=gn_b,
                    proj=_copy_as(compute_dtype, proj.transpose(0, 1)), keep=keep,
                    **kernel_weights(compute_dtype, model.post_dense.weight,
                                     model.post_dense.bias, [m.weight for m in dense]))

    loss_fn.operands = operands
    return loss_fn


def get_cuda_train_loss_and_grad(sde: SDE, model, **kw):
    """``fn(batch, **noise) -> (loss, {parameter name: grad})``: the kernel
    route's counterpart of ``jax.value_and_grad(get_sde_loss_fn(...))``;
    parameters the loss does not reach (the dead ``pre_dense_cond``) get
    zeros, as ``jax.grad`` gives them."""
    loss_fn = get_cuda_train_loss_fn(sde, model, **kw)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    def fn(batch, **noise):
        with tf32(batch.device.type == "cuda"):
            loss = loss_fn(batch, **noise)
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                               for (n, p), g in zip(named, grads)}

    return fn


def get_cuda_step_fn(sde: SDE, model, **kw):
    """Drop-in for ``losses.get_step_fn(train=True, ...)`` with the network's
    forward and backward through the kernels: ``step_fn(state, batch,
    t=None, z=None, dropout_seed=None, generator=None) -> loss dict``,
    updating ``state`` in place (clip, Adam, EMA, step)."""
    from ...diffusion.losses import apply_train_update

    loss_fn = get_cuda_train_loss_fn(sde, model, **kw)

    def step_fn(state, batch, **noise):
        state.tx.zero_grad()
        with tf32(batch.device.type == "cuda"):
            loss = loss_fn(batch, **noise)
            loss.backward()
        apply_train_update(state)
        loss = loss.detach()
        return {"step_loss": loss, "score_loss": loss}

    return step_fn
