"""The ScoreModelFC forward for the CUDA reverse-diffusion loop.

Port of ``dposer_tpu/ops/pallas/score_net.py``:

- ``build_network_operands``: the host-side prep. bf16 weights in the
  natural feature order, ``tp_all [N, 1+2*n_blocks, H]`` fp32 (each layer's
  time projection plus its dense bias, per step), the GroupNorm scale and
  bias rows, and the head zero-padded to 64 output columns (128 for a pose
  of 65-128 dims, rot6d's 126: ``head_cols``). The model's
  ``1/sigma`` output scaling comes back as ``out_scale`` to fold into the
  coefficient tables. The TPU's lane-strided GroupNorm permutation and its
  8-sublane / 128-lane paddings have no counterpart here: a 64-wide GEMM
  tile holds whole 32-feature groups in the natural order.
  With ``quant="int8"`` (the opt-in W8A8 serving mode, port of the quant
  branch of the JAX build) the hidden layers' weights are per-output-column
  int8 ``Wq`` instead, with the rescale rows ``qs`` and the activation
  quantization rows ``qinv`` (per-tensor immediates or per-channel
  ``smooth_fold`` rows, one layout for both); the head stays bf16.
- kernel K1 ``dense_gn_silu`` (``csrc/dense_gn_silu.cu``) with its plain
  PyTorch version, and ``network_hidden``, which runs the layers with it and
  hands the activations on in bf16 (each epilogue writes the next layer's
  rounded input, which the bf16 Hopper route reads: TMA and ``wgmma`` with
  both operands from shared memory; the pre layer, on the fp32 state, runs
  the pre route: its rows bulk-loaded and rounded once into shared memory,
  one ``wgmma`` stage a 64-deep K-tile, one at K <= 64, two at K <= 128).
- kernel K13 ``dense_gn_silu_int8`` (``csrc/dense_gn_silu_int8.cu``): K1's
  layer on int8 operands (port of ``bind_fwd``'s quant ``mm``), its plain
  version; ``network_hidden`` takes it for int8 operands and hands the
  activations on as int8 (each epilogue writes the next layer's quantized
  input, which the Hopper int8 loop ``csrc/dense_wgmma_int8.cuh`` reads;
  the pre layer, on the fp32 state, runs the pre route: its rows
  bulk-loaded and quantized once into shared memory, one ``wgmma`` s8
  stage).
- kernel K7 ``dense_gn_silu_jvp`` (``csrc/dense_gn_silu_jvp.cu``): the same
  layer with its forward-mode tangent, the tangent rules written out by hand
  (port of ``bind_fwd_jvp``), its plain version, and ``network_hidden_jvp``,
  which hands the activations on in bf16 (each epilogue writes the next
  layer's rounded input, which the Hopper route reads: TMA, ``wgmma``, split-K
  over a thread-block cluster; the pre layer, on the fp32 state, runs the
  register-staged loop).

``labels`` may be any grid of times: the samplers pass their N steps, the
RK4 integrators their ``2*n_steps + 1`` stage times, and a layer reads row
``i`` of ``tp_all`` either way.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ...diffusion.fast_sampler import _group_norm, precompute_time_tables
from . import build
from .quant import int8_matmul, quantize_act, quantize_cols, smooth_fold

NUM_GROUPS = 32
HEAD_COLS = 64  # the head's output width, zero-padded for 16x16 MMA tiles
WIDE_HEAD_COLS = 128  # K2's wide tile: a pose of 65-128 dims (rot6d's 126)
PRE_KTILE = 64  # K-columns a K-tile of K1's pre route: one at K <= 64, two at K <= 128


def head_cols(dim: int) -> int:
    """The width the output head is zero-padded to for a pose of ``dim``:
    ``HEAD_COLS`` up to 64 dims (axis-angle's 63; every head kernel takes
    it), ``WIDE_HEAD_COLS`` up to 128 (rot6d's 126; K2 alone takes it: the
    other routes refuse such a pose in their scope checks). Beyond, no
    kernel: ``NotImplementedError``."""
    if dim <= HEAD_COLS:
        return HEAD_COLS
    if dim <= WIDE_HEAD_COLS:
        return WIDE_HEAD_COLS
    raise NotImplementedError(f"pose dim {dim} > {WIDE_HEAD_COLS}")


def _nvbf16(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.bfloat16).contiguous()


@torch.no_grad()
def build_network_operands(model, labels: torch.Tensor, device=None, quant=None,
                           act_amax=None) -> dict:
    """Kernel operands of a ScoreModelFC for the step labels ``labels`` [N].

    Returns ``W`` (list of bf16 [K, H]: pre-dense, then dense1/dense2 per
    block), ``gn_scale``/``gn_bias`` ([1+2*n_blocks, H] fp32), ``tp_all``
    ([N, 1+2*n_blocks, H] fp32), ``w_post`` ([H, P] bf16), ``b_post``
    ([P] fp32), with ``P = head_cols(dim)`` (64, or 128 for a pose of 65-128
    dims), ``out_scale`` ([N] or None), on ``device``.

    ``quant="int8"`` (requires ``act_amax`` from ``quant.calibrate_act_amax``,
    [n_mm] per-tensor ranges, or the list of ``calibrate_act_amax_per_channel``)
    replaces ``W`` with ``Wq``: per-output-column int8 in the kernel's [N, K]
    layout (nn.Linear's [out, in]), with ``qs`` [1+2*n_blocks, H] fp32 (row k
    = ``(amax_k/127)*s_k``, the activation range times the weight column
    scales) and ``qinv`` [1+2*n_blocks, H] fp32, the quantization rows: the
    float32 ``127/amax_k`` per tensor, or the ``smooth_fold`` rows per channel
    (whose channel scales are folded into ``Wq``); row 0 uses its first
    ``dim`` entries. The head stays bf16.
    """
    if quant not in (None, "int8"):
        raise ValueError(f"quant must be None or 'int8', got {quant!r}")
    if (quant == "int8") != (act_amax is not None):
        raise ValueError("act_amax must be passed iff quant='int8'")
    if model.embedding_type != "positional":
        raise NotImplementedError("the fused kernels support positional embeddings")
    if model.act_name != "swish":
        raise NotImplementedError(f"the fused kernels hardcode SiLU; model uses "
                                  f"{model.act_name!r}")
    dim = model.n_poses * model.pose_dim
    cols = head_cols(dim)
    device = torch.device(device) if device is not None else labels.device
    tprojs, out_scale = precompute_time_tables(model, labels)

    names = ["pre_dense"] + [f"b{b + 1}_dense{j}" for b in range(model.n_blocks)
                             for j in (1, 2)]
    gn_names = ["pre_gnorm"] + [f"b{b + 1}_gnorm{j}" for b in range(model.n_blocks)
                                for j in (1, 2)]
    tp_all = torch.stack([tprojs[n + "_t"] + getattr(model, n).bias[None, :]
                          for n in names], dim=1).float()
    gn_scale = torch.stack([getattr(model, n).weight for n in gn_names]).float()
    gn_bias = torch.stack([getattr(model, n).bias for n in gn_names]).float()
    w_post = torch.zeros(model.hidden_dim, cols, dtype=torch.bfloat16)
    w_post[:, :dim] = model.post_dense.weight.t().to(torch.bfloat16).cpu()
    b_post = torch.zeros(cols)
    b_post[:dim] = model.post_dense.bias.float().cpu()
    net = dict(tp_all=tp_all.to(device).contiguous(),
               gn_scale=gn_scale.to(device).contiguous(),
               gn_bias=gn_bias.to(device).contiguous(),
               w_post=w_post.to(device), b_post=b_post.to(device),
               out_scale=out_scale, dim=dim, hidden=model.hidden_dim,
               n_blocks=model.n_blocks)
    if quant is None:
        net["W"] = [_nvbf16(getattr(model, n).weight.t()).to(device) for n in names]
    else:
        Wf = [getattr(model, n).weight.detach().t().float().cpu().numpy() for n in names]
        net.update({k: ([t.to(device) for t in v] if isinstance(v, list) else v.to(device))
                    for k, v in _int8_operands(Wf, act_amax, model.hidden_dim).items()})
        # each layer's rows as views made once: the sampler's host loop slices nothing
        net["qinv_rows"] = [net["qinv"][j, :w.shape[1]] for j, w in enumerate(net["Wq"])]
        net["qs_rows"] = list(net["qs"].unbind(0))
    return net


def _int8_operands(Wf, act_amax, hidden: int) -> dict:
    """``Wq``, ``qs`` and ``qinv`` for the hidden layers' fp32 weights ``Wf``
    ([in, out] numpy, pre-dense first), as the quant branch of the JAX build
    computes them, in the natural feature order without its 128-row padding
    of the pre layer: the padded rows are zero, so ``smooth_fold`` leaves them
    out of its geometric mean and the fold is the same."""
    n_layers = len(Wf)
    n_mm = n_layers + 1
    per_channel = isinstance(act_amax, (list, tuple))
    qinv = np.zeros((n_layers, hidden), np.float32)
    if per_channel:
        if len(act_amax) != n_mm:
            raise ValueError(f"per-channel act_amax must have {n_mm} entries "
                             f"(quant.calibrate_act_amax_per_channel); got {len(act_amax)}")
        amax_t = []
        for k in range(n_layers):
            inv_k, Wf[k], a_t = smooth_fold(np.asarray(act_amax[k], np.float32).reshape(-1),
                                            Wf[k])
            qinv[k, :inv_k.shape[0]] = inv_k
            amax_t.append(a_t)
        amax = np.asarray(amax_t, np.float32)
    else:
        amax = np.asarray(act_amax, np.float32).reshape(-1)
        if amax.shape != (n_mm,) or not np.all(amax > 0):
            raise ValueError(f"act_amax must be {n_mm} positive ranges (one per matmul "
                             f"input: x, h_pre, (h1, h_res) per block, h_post); got "
                             f"{amax!r}")
        for k in range(n_layers):
            qinv[k] = np.float32(127.0) / amax[k]  # the TPU kernel's immediate
    Wq, qs = [], np.zeros((n_layers, hidden), np.float32)
    for k in range(n_layers):
        q, s = quantize_cols(torch.from_numpy(np.ascontiguousarray(Wf[k])))
        Wq.append(q.t().contiguous())
        qs[k] = (amax[k] / 127.0) * s.numpy()
    return dict(Wq=Wq, qs=torch.from_numpy(qs), qinv=torch.from_numpy(qinv))


# ---------------------------------------------------------------------------
# K1 dense_gn_silu
# ---------------------------------------------------------------------------

def dense_gn_silu_plain(a, w, tp_row, gamma, beta, residual=None, a_b=None):
    """``SiLU(GN32(bf16(a) @ w + tp_row)*gamma + beta) [+ residual]`` in
    fp32, with the matmul inputs rounded to bf16 as the kernel rounds them.
    ``a_b`` (bf16), when given, is ``bf16(a)`` already and ``a`` is not read."""
    h = (a.to(torch.bfloat16) if a_b is None else a_b).float() @ w.float() + tp_row
    y = F.silu(_group_norm(h, gamma, beta, num_groups=NUM_GROUPS))
    return y if residual is None else y + residual


def dense_gn_silu_plain_into(a, w, tp_row, gamma, beta, residual=None, out=None, *, a_b=None,
                             out_b=None, write_out: bool = True):
    """The plain version with the wrapper's signature, on any device: the
    reference path the kernels are held to on the card. With ``out_b`` it
    also writes the bf16 copy of the output; ``write_out=False`` returns
    that copy and keeps no fp32 output."""
    y = dense_gn_silu_plain(a, w, tp_row, gamma, beta, residual, a_b)
    if out_b is not None:
        out_b.copy_(y)
    if not write_out:
        return out_b
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
        fn.argtypes = [P] * 9 + [I, I, I, P]
        fn.restype = I
    return fn


def check_bf16_copy(a_b, w, B: int, K: int) -> None:
    """Raise unless K1's bf16 route can take ``a_b`` and ``w``: ``a_b`` bf16
    [B, K] contiguous, K a multiple of 8 (TMA rows), both 16-byte aligned.
    Checked on every device, so the CPU's plain path takes the operands the
    card takes."""
    _check("a_b", a_b, w.device, torch.bfloat16, (B, K))
    if K % 8:
        raise ValueError(f"a_b needs K % 8 == 0 (TMA rows); got K={K}")
    for nm, t in (("a_b", a_b), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{nm} must be 16-byte aligned for TMA")


def _k1_route(a, a_b, w) -> str:
    """The route K1's library takes (``dense_gn_silu.cu``): the bf16 copy, or
    fp32 A at K <= 128 (the pre layer, whatever A's alignment) with W 16-byte
    aligned: the pre route over one 64-deep K-tile (``"pre_wgmma"``, K <= 64:
    axis-angle's 63) or two (``"pre_wgmma2"``: rot6d's 126). Raises
    ``ValueError`` for any other fp32 A: the library has no route for it,
    and the caller passes the bf16 copy ``a_b`` instead."""
    if a_b is not None:
        return "wgmma_bf16"
    K, N = w.shape
    if K <= 2 * PRE_KTILE and N % 8 == 0 and w.data_ptr() % 16 == 0:
        return "pre_wgmma" if K <= PRE_KTILE else "pre_wgmma2"
    raise ValueError(f"dense_gn_silu takes fp32 a only at K <= {2 * PRE_KTILE} with w "
                     f"16-byte aligned (got K={K}); pass its bf16 copy a_b")


def dense_gn_silu(a, w, tp_row, gamma, beta, residual=None, out=None, *, a_b=None, out_b=None,
                  write_out: bool = True):
    """K1 on ``a`` [B, K] fp32 and ``w`` [K, N] bf16; writes ``out`` [B, N]
    fp32 (may be ``residual`` itself) and returns it.

    ``a_b`` bf16 [B, K], ``bf16(a)`` written by the previous layer, routes
    the layer through the bf16 Hopper loop (TMA and ``wgmma`` with both
    operands from shared memory; ``a`` may then be None); without it, at
    K <= 128 (the pre layer's 63 or 126), the pre route (``a``'s rows
    bulk-loaded and rounded once into shared memory, one ``wgmma`` stage a
    64-deep K-tile). On CUDA tensors fp32 ``a`` at K > 128 raises
    ``ValueError``: pass its copy ``a_b``. With
    ``out_b`` bf16 [B, N] the epilogue also writes the bf16 copy of out, the
    next layer's ``a_b``; ``write_out=False`` writes that copy alone (``out`` is
    then None) and returns it. Each launch adds one to ``launches`` and to
    its route's count in ``routes``."""
    B, K = (a if a_b is None else a_b).shape
    N = w.shape[1]
    dev = w.device
    if not write_out:
        if out is not None or out_b is None:
            raise ValueError("write_out=False takes out_b and no out")
    elif out is None:
        out = torch.empty((B, N), dtype=torch.float32, device=dev)
    if a_b is None or a is not None:
        _check("a", a, dev, torch.float32, (B, K))
    _check("w", w, dev, torch.bfloat16, (K, N))
    for nm, t in (("tp_row", tp_row), ("gamma", gamma), ("beta", beta)):
        _check(nm, t, dev, torch.float32, (N,))
    if residual is not None:
        _check("residual", residual, dev, torch.float32, (B, N))
    if out is not None:
        _check("out", out, dev, torch.float32, (B, N))
    if a_b is not None:
        check_bf16_copy(a_b, w, B, K)
    if out_b is not None:
        _check("out_b", out_b, dev, torch.bfloat16, (B, N))
    if dev.type == "cpu":
        return dense_gn_silu_plain_into(a, w, tp_row, gamma, beta, residual, out, a_b=a_b,
                                        out_b=out_b, write_out=write_out)
    if dev.type != "cuda":
        raise ValueError(f"dense_gn_silu runs on cpu or cuda, not {dev}")
    gs = N // NUM_GROUPS
    if N % 64 or gs not in (2, 4, 8, 16, 32):
        raise ValueError(f"dense_gn_silu kernel needs N % 64 == 0 and a group "
                         f"size N/32 in {{2,4,8,16,32}}; got N={N}")
    route = _k1_route(a, a_b, w)
    err = _dense_gn_silu_fn()(None if a_b is not None else a.data_ptr(), _ptr(a_b),
                              w.data_ptr(), tp_row.data_ptr(), gamma.data_ptr(),
                              beta.data_ptr(), _ptr(residual), _ptr(out), _ptr(out_b), B, K, N,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"dense_gn_silu launch failed: CUDA error {err}")
    dense_gn_silu.launches += 1
    dense_gn_silu.programmatic += 1
    dense_gn_silu.routes[route] += 1
    return out if write_out else out_b


dense_gn_silu.launches = 0
dense_gn_silu.programmatic = 0
dense_gn_silu.routes = {"wgmma_bf16": 0, "pre_wgmma": 0, "pre_wgmma2": 0}


def dense_gn_silu_pre_launch_info(rows: int, n: int, k: int = PRE_KTILE) -> dict:
    """K1's pre route at ``rows`` x ``n`` (depth ``k``: one K-tile at
    ``k`` <= 64, two beyond) as it launches on this card: threads, static
    shared memory a CTA and the dynamic shared memory it reserves (with two
    tiles, its own), registers and local memory (spills) a thread, and the
    CTAs an SM holds at once."""
    entry = "pre" if k <= PRE_KTILE else "pre2"
    fn = getattr(build.load("dense_gn_silu"), f"dposer_dense_gn_silu_{entry}_launch_info")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(rows, n, out)
    if err:
        raise RuntimeError(f"dense_gn_silu_pre_launch_info failed: CUDA error {err}")
    return dict(zip(("threads", "static_smem", "dynamic_smem", "registers", "local_bytes",
                     "ctas_per_sm"), list(out)))


def layer_weights(net: dict, j: int) -> tuple:
    """The weight operands of hidden layer ``j``: ``(W[j],)`` for bf16
    operands, ``(Wq[j], qinv row, qs row)`` for int8 ones."""
    if "Wq" not in net:
        return (net["W"][j],)
    return net["Wq"][j], net["qinv_rows"][j], net["qs_rows"][j]


def hidden_layer(net: dict, plain: bool = False):
    """The layer ``network_hidden`` runs on ``net``: K1 (bf16 operands) or
    K13 (int8), or its plain version."""
    if "Wq" in net:
        return dense_gn_silu_int8_plain_into if plain else dense_gn_silu_int8
    return dense_gn_silu_plain_into if plain else dense_gn_silu


def network_hidden(net: dict, x: torch.Tensor, i: int, h: torch.Tensor,
                   h1: torch.Tensor, layer=None, q=None) -> torch.Tensor:
    """The network's last hidden activation at row ``i`` of the time grid into ``h``
    (``h1`` is scratch): ``layer`` once for the pre layer and twice per block.
    ``layer`` (default ``hidden_layer(net)``) takes ``layer_weights(net, j)``:
    K1 or its plain version for bf16 operands, K13 or its plain version for
    int8 ones.

    The activations are handed on through ``q = (hq, h1q)``, two [B, H]
    buffers beside ``h`` and ``h1`` (``handoff_buffers``; made here when not
    given): each layer's epilogue also writes its output as the next layer
    reads it, and the next layer reads that copy instead of the fp32 one.
    For int8 operands the copy is the output quantized by the next layer's
    ``qinv`` row (K13's Hopper route reads it); for bf16 operands it is the
    output rounded to bf16 (K1's bf16 route reads it), and a block's first
    layer writes its copy alone, no fp32 ``h1``. The sums are the same
    either way. The pre layer reads the fp32 state (K13's and K1's pre
    routes); the last block writes no copy, since the head reads ``h``."""
    layer = hidden_layer(net) if layer is None else layer
    tp = net["tp_all"][i]
    gs, gb = net["gn_scale"], net["gn_bias"]
    n_layers = 1 + 2 * net["n_blocks"]
    if q is None:
        q = handoff_buffers(net, h.shape[0], h.device)
    int8 = "Wq" in net

    def handoff(j, a_copy, out_copy):  # layer j's copy in and copy out
        kw = {} if a_copy is None else {"a_q" if int8 else "a_b": a_copy}
        if j + 1 < n_layers:
            kw.update(dict(qinv_next=net["qinv_rows"][j + 1], out_q=out_copy) if int8
                      else dict(out_b=out_copy))
        return kw

    hq, h1q = q
    layer(x, *layer_weights(net, 0), tp[0], gs[0], gb[0], out=h, **handoff(0, None, hq))
    for blk in range(net["n_blocks"]):
        j = 1 + 2 * blk
        first = dict(out=h1) if int8 else dict(write_out=False)
        layer(None, *layer_weights(net, j), tp[j], gs[j], gb[j], **first,
              **handoff(j, hq, h1q))
        layer(None, *layer_weights(net, j + 1), tp[j + 1], gs[j + 1], gb[j + 1],
              residual=h, out=h, **handoff(j + 1, h1q, hq))
    return h


def handoff_buffers(net: dict, batch: int, device) -> tuple:
    """``network_hidden``'s ``q``: two [batch, H] buffers for the copies the
    layers hand on, int8 for int8 operands and bf16 for bf16 ones."""
    dtype = torch.int8 if "Wq" in net else torch.bfloat16
    return tuple(torch.empty((batch, net["hidden"]), dtype=dtype, device=device)
                 for _ in range(2))


# ---------------------------------------------------------------------------
# K13 dense_gn_silu_int8
# ---------------------------------------------------------------------------

def dense_gn_silu_int8_plain(a, wq, qinv, qs, tp_row, gamma, beta, residual=None, a_q=None):
    """``SiLU(GN32(float(q(a) @ wq^T)*qs + tp_row)*gamma + beta) [+ residual]``
    with ``q(a) = clamp(rint(a*qinv), -127, 127)``; the int32 sums exact.
    ``a_q`` (int8), when given, is ``q(a)`` already and ``a`` is not read."""
    aq = quantize_act(a, qinv) if a_q is None else a_q.float()
    h = int8_matmul(aq, wq.t()) * qs + tp_row
    y = F.silu(_group_norm(h, gamma, beta, num_groups=NUM_GROUPS))
    return y if residual is None else y + residual


def dense_gn_silu_int8_plain_into(a, wq, qinv, qs, tp_row, gamma, beta, residual=None,
                                  out=None, *, a_q=None, qinv_next=None, out_q=None):
    """The plain version with the wrapper's signature, on any device: with
    ``out_q`` it also writes ``quantize_act(out, qinv_next)`` as int8."""
    y = dense_gn_silu_int8_plain(a, wq, qinv, qs, tp_row, gamma, beta, residual, a_q)
    if out_q is not None:
        out_q.copy_(quantize_act(y, qinv_next).to(torch.int8))
    return y if out is None else out.copy_(y)


def _dense_gn_silu_int8_fn():
    fn = build.load("dense_gn_silu_int8").dposer_dense_gn_silu_int8
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 12 + [I, I, I, P]
        fn.restype = I
    return fn


def check_int8_input(a_q, wq, B: int, K: int) -> None:
    """Raise unless TMA can address ``a_q`` and ``wq`` (the Hopper int8
    route of K13 and K14): int8 [B, K] contiguous, K a multiple of 16 and at
    most 1024, both 16-byte aligned. Checked on every device, so the CPU's
    plain path takes the operands the card takes."""
    _check("a_q", a_q, wq.device, torch.int8, (B, K))
    if K % 16 or K > 1024:
        raise ValueError(f"a_q needs K % 16 == 0 and K <= 1024 (TMA rows); got K={K}")
    for nm, t in (("a_q", a_q), ("wq", wq)):
        if t.data_ptr() % 16:
            raise ValueError(f"{nm} must be 16-byte aligned for TMA")


def _k13_route(a, a_q) -> str:
    """The route K13's library takes (``dense_gn_silu_int8.cu``): the int8
    copy ``a_q`` (the Hopper int8 loop), or fp32 ``a`` at K <= 64 (the pre
    layer, whatever ``a``'s and Wq's alignment: the pre route) or beyond (the
    register-staged loop)."""
    if a_q is not None:
        return "wgmma_int8"
    return "pre_wgmma8" if a.shape[1] <= 64 else "register"


def dense_gn_silu_int8(a, wq, qinv, qs, tp_row, gamma, beta, residual=None, out=None, *,
                       a_q=None, qinv_next=None, out_q=None):
    """K13 on ``a`` [B, K] fp32, ``wq`` [N, K] int8, ``qinv`` [K] and ``qs``
    [N] fp32; writes ``out`` [B, N] fp32 (may be ``residual`` itself) and
    returns it.

    ``a_q`` int8 [B, K], ``q(a)`` written by the previous layer, routes the
    layer through the Hopper int8 loop (TMA and ``wgmma`` s8; ``a`` may then
    be None); without it, at K <= 64 (the pre layer's 63), the pre route
    (``a``'s rows bulk-loaded and quantized once into shared memory, one
    ``wgmma`` s8 stage), beyond it the register-staged loop quantizes ``a``.
    With ``qinv_next`` [N] fp32 and ``out_q`` int8 [B, N] the epilogue also
    writes ``q(out, qinv_next)``, the next layer's ``a_q``. Each launch adds
    one to ``launches`` and to its route's count in ``routes``."""
    B, K = (a if a_q is None else a_q).shape
    N = wq.shape[0]
    dev = wq.device
    if out is None:
        out = torch.empty((B, N), dtype=torch.float32, device=dev)
    if a_q is None or a is not None:
        _check("a", a, dev, torch.float32, (B, K))
    _check("wq", wq, dev, torch.int8, (N, K))
    _check("qinv", qinv, dev, torch.float32, (K,))
    for nm, t in (("qs", qs), ("tp_row", tp_row), ("gamma", gamma), ("beta", beta)):
        _check(nm, t, dev, torch.float32, (N,))
    if residual is not None:
        _check("residual", residual, dev, torch.float32, (B, N))
    _check("out", out, dev, torch.float32, (B, N))
    if a_q is not None:
        check_int8_input(a_q, wq, B, K)
    if (out_q is None) != (qinv_next is None):
        raise ValueError("out_q and qinv_next come together")
    if out_q is not None:
        _check("out_q", out_q, dev, torch.int8, (B, N))
        _check("qinv_next", qinv_next, dev, torch.float32, (N,))
    if dev.type == "cpu":
        return dense_gn_silu_int8_plain_into(a, wq, qinv, qs, tp_row, gamma, beta, residual,
                                             out, a_q=a_q, qinv_next=qinv_next, out_q=out_q)
    if dev.type != "cuda":
        raise ValueError(f"dense_gn_silu_int8 runs on cpu or cuda, not {dev}")
    gs = N // NUM_GROUPS
    if N % 64 or gs not in (2, 4, 8, 16, 32) or K > 1024:
        raise ValueError(f"dense_gn_silu_int8 kernel needs N % 64 == 0, a group size N/32 "
                         f"in {{2,4,8,16,32}} and K <= 1024; got N={N}, K={K}")
    err = _dense_gn_silu_int8_fn()(_ptr(a) if a_q is None else None, _ptr(a_q),
                                   wq.data_ptr(), qinv.data_ptr(), qs.data_ptr(),
                                   tp_row.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                   _ptr(residual), out.data_ptr(), _ptr(qinv_next),
                                   _ptr(out_q), B, K, N,
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"dense_gn_silu_int8 launch failed: CUDA error {err}")
    dense_gn_silu_int8.launches += 1
    dense_gn_silu_int8.programmatic += 1
    dense_gn_silu_int8.routes[_k13_route(a, a_q)] += 1
    return out


dense_gn_silu_int8.launches = 0
dense_gn_silu_int8.programmatic = 0
dense_gn_silu_int8.routes = {"wgmma_int8": 0, "pre_wgmma8": 0, "register": 0}


def dense_gn_silu_int8_pre_launch_info(rows: int, n: int) -> dict:
    """K13's pre route at ``rows`` x ``n`` as it launches on this card:
    threads, static shared memory a CTA and the dynamic shared memory it
    reserves, registers and local memory (spills) a thread, and the CTAs an
    SM holds at once."""
    fn = build.load("dense_gn_silu_int8").dposer_dense_gn_silu_int8_pre_launch_info
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(rows, n, out)
    if err:
        raise RuntimeError(f"dense_gn_silu_int8_pre_launch_info failed: CUDA error {err}")
    return dict(zip(("threads", "static_smem", "dynamic_smem", "registers", "local_bytes",
                     "ctas_per_sm"), list(out)))


def int8_loop_product(a_q, wq, qs):
    """``float(a_q @ wq^T) * qs`` [B, N] fp32 from K13's Hopper int8 loop
    alone (``dposer_dense_gn_silu_int8_product``), on CUDA tensors: the loop's
    exact check, held bit for bit to ``int8_matmul(a_q, wq.t()) * qs``. No
    path runs it, so it counts no launch."""
    B, K = a_q.shape
    N = wq.shape[0]
    dev = wq.device
    _check("wq", wq, dev, torch.int8, (N, K))
    _check("qs", qs, dev, torch.float32, (N,))
    check_int8_input(a_q, wq, B, K)
    if dev.type != "cuda" or N % 64:
        raise ValueError(f"int8_loop_product runs on CUDA tensors with N % 64 == 0; got "
                         f"{dev}, N={N}")
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    fn = build.load("dense_gn_silu_int8").dposer_dense_gn_silu_int8_product
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [P] * 4 + [I, I, I, P], I
    err = fn(a_q.data_ptr(), wq.data_ptr(), qs.data_ptr(), out.data_ptr(), B, K, N,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"int8_loop_product launch failed: CUDA error {err}")
    return out


# ---------------------------------------------------------------------------
# K7 dense_gn_silu_jvp
# ---------------------------------------------------------------------------

def dense_gn_silu_jvp_plain(a, da, w, tp_row, gamma, beta, residual=None, dresidual=None,
                            a_b=None, da_b=None):
    """Plain K7: ``(out, dout)``, K1's layer and its tangent along ``da``, the
    rules of the kernel written out in fp32 (matmul inputs rounded to bf16).
    ``a_b`` and ``da_b`` (bf16), when given, are those roundings already and
    ``a``, ``da`` are not read."""
    wf = w.float()
    h = (a.to(torch.bfloat16) if a_b is None else a_b).float() @ wf + tp_row
    dh = (da.to(torch.bfloat16) if da_b is None else da_b).float() @ wf
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
                                 dresidual=None, out=None, dout=None, *, a_b=None, da_b=None,
                                 out_b=None, dout_b=None):
    """The plain version with the wrapper's signature, on any device: with
    ``out_b`` and ``dout_b`` it also writes the bf16 copies of out and dout."""
    y, dy = dense_gn_silu_jvp_plain(a, da, w, tp_row, gamma, beta, residual, dresidual,
                                    a_b, da_b)
    if out_b is not None:
        out_b.copy_(y)
        dout_b.copy_(dy)
    if out is None:
        return y, dy
    return out.copy_(y), dout.copy_(dy)


def _dense_gn_silu_jvp_fn():
    fn = build.load("dense_gn_silu_jvp").dposer_dense_gn_silu_jvp
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 14 + [I, I, I, P]
        fn.restype = I
    return fn


JVP_MAX_SLICE = 256  # the deepest K slice a CTA of the Hopper route takes


def jvp_cluster(K: int):
    """The cluster size K7's Hopper route takes at depth ``K``, as the kernel
    picks it: the fewest CTAs of 1, 2, 4, 8 whose slices are whole 64-deep
    boxes at most 256 deep (K = 1024: 4 CTAs of 256; on the H100 8 CTAs of
    128 were slower, PERF.md); None where no size cuts K so."""
    for c in (1, 2, 4, 8):
        if K % (64 * c) == 0 and K // c <= JVP_MAX_SLICE:
            return c
    return None


def check_bf16_inputs(a_b, da_b, w, B: int, K: int) -> None:
    """Raise unless K7's Hopper route can take ``a_b`` and ``da_b``: bf16
    [B, K] contiguous and, with ``w``, 16-byte aligned (TMA rows), and a depth
    ``jvp_cluster`` cuts. Checked on every device, so the CPU's plain path
    takes the operands the card takes."""
    for name, t in (("a_b", a_b), ("da_b", da_b), ("w", w)):
        if name != "w":
            _check(name, t, w.device, torch.bfloat16, (B, K))
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for TMA")
    if jvp_cluster(K) is None:
        raise ValueError(f"the Hopper route needs K a multiple of 64 that 1, 2, 4 or 8 CTAs "
                         f"cut into slices of at most {JVP_MAX_SLICE}; got K={K}")


def dense_gn_silu_jvp(a, da, w, tp_row, gamma, beta, residual=None, dresidual=None,
                      out=None, dout=None, *, a_b=None, da_b=None, out_b=None, dout_b=None):
    """K7 on ``a``, ``da`` [B, K] fp32 and ``w`` [K, N] bf16; writes ``out``
    and ``dout`` [B, N] fp32 (which may be ``residual`` and ``dresidual``
    themselves) and returns them.

    ``a_b`` and ``da_b`` bf16 [B, K], the bf16 copies of ``a`` and ``da``
    written by the previous layer, route the layer through the Hopper loop
    (TMA and ``wgmma``, split-K over clusters of ``jvp_cluster(K)`` CTAs;
    ``a`` and ``da`` may then be None); without them the
    register-staged loop rounds ``a`` and ``da``. With ``out_b`` and
    ``dout_b`` bf16 [B, N] the epilogue also writes the bf16 copies of out and
    dout, the next layer's ``a_b`` and ``da_b``. Each launch adds one to
    ``launches`` and to its route's count in ``routes``."""
    B, K = (a if a_b is None else a_b).shape
    N = w.shape[1]
    dev = w.device
    if (out is None) != (dout is None) or (residual is None) != (dresidual is None):
        raise ValueError("out/dout and residual/dresidual come in pairs")
    if (a_b is None) != (da_b is None) or (out_b is None) != (dout_b is None):
        raise ValueError("a_b/da_b and out_b/dout_b come in pairs")
    if out is None:
        out = torch.empty((B, N), dtype=torch.float32, device=dev)
        dout = torch.empty_like(out)
    if a_b is None or a is not None:
        _check("a", a, dev, torch.float32, (B, K))
        _check("da", da, dev, torch.float32, (B, K))
    _check("w", w, dev, torch.bfloat16, (K, N))
    for nm, t in (("tp_row", tp_row), ("gamma", gamma), ("beta", beta)):
        _check(nm, t, dev, torch.float32, (N,))
    for nm, t in (("residual", residual), ("dresidual", dresidual), ("out", out),
                  ("dout", dout)):
        if t is not None:
            _check(nm, t, dev, torch.float32, (B, N))
    for nm, t in (("out_b", out_b), ("dout_b", dout_b)):
        if t is not None:
            _check(nm, t, dev, torch.bfloat16, (B, N))
    if a_b is not None:
        check_bf16_inputs(a_b, da_b, w, B, K)
    if dev.type == "cpu":
        return dense_gn_silu_jvp_plain_into(a, da, w, tp_row, gamma, beta, residual,
                                            dresidual, out, dout, a_b=a_b, da_b=da_b,
                                            out_b=out_b, dout_b=dout_b)
    if dev.type != "cuda":
        raise ValueError(f"dense_gn_silu_jvp runs on cpu or cuda, not {dev}")
    gs = N // NUM_GROUPS
    if N % 64 or gs not in (2, 4, 8, 16, 32):
        raise ValueError(f"dense_gn_silu_jvp kernel needs N % 64 == 0 and a group "
                         f"size N/32 in {{2,4,8,16,32}}; got N={N}")
    hopper = a_b is not None
    err = _dense_gn_silu_jvp_fn()(None if hopper else a.data_ptr(),
                                  None if hopper else da.data_ptr(), _ptr(a_b), _ptr(da_b),
                                  w.data_ptr(), tp_row.data_ptr(), gamma.data_ptr(),
                                  beta.data_ptr(), _ptr(residual), _ptr(dresidual),
                                  out.data_ptr(), dout.data_ptr(), _ptr(out_b), _ptr(dout_b),
                                  B, K, N,
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"dense_gn_silu_jvp launch failed: CUDA error {err}")
    dense_gn_silu_jvp.launches += 1
    dense_gn_silu_jvp.routes["wgmma" if hopper else "register"] += 1
    return out, dout


dense_gn_silu_jvp.launches = 0
dense_gn_silu_jvp.routes = {"wgmma": 0, "register": 0}


def network_hidden_jvp(net: dict, x, dx, i: int, bufs, layer=dense_gn_silu_jvp):
    """The network's last hidden activation at row ``i`` of the time grid and
    its tangent along ``dx``, into ``bufs`` (``hidden_jvp_buffers``: h, dh
    and the scratch h1, dh1, then their bf16 copies hb, dhb, h1b, dh1b):
    ``layer`` (K7, or its plain version) once for the pre layer and twice per
    block. Returns ``(h, dh)``.

    The activations are handed on in bf16: each layer's epilogue also writes
    its out and dout rounded to bf16, and the next layer reads those copies
    (K7's Hopper route) instead of rounding the fp32 ones; the products are
    the same. The pre layer reads the fp32 state (K7's register route); the
    last block writes no copy, since K9 reads ``h`` and ``dh``."""
    h, dh, h1, dh1, hb, dhb, h1b, dh1b = bufs
    tp = net["tp_all"][i]
    W, gs, gb = net["W"], net["gn_scale"], net["gn_bias"]
    layer(x, dx, W[0], tp[0], gs[0], gb[0], out=h, dout=dh, out_b=hb, dout_b=dhb)
    for blk in range(net["n_blocks"]):
        j = 1 + 2 * blk
        last = blk + 1 == net["n_blocks"]
        layer(None, None, W[j], tp[j], gs[j], gb[j], out=h1, dout=dh1, a_b=hb, da_b=dhb,
              out_b=h1b, dout_b=dh1b)
        layer(None, None, W[j + 1], tp[j + 1], gs[j + 1], gb[j + 1], residual=h,
              dresidual=dh, out=h, dout=dh, a_b=h1b, da_b=dh1b,
              out_b=None if last else hb, dout_b=None if last else dhb)
    return h, dh


def hidden_jvp_buffers(net: dict, batch: int, device) -> tuple:
    """``network_hidden_jvp``'s ``bufs``: four fp32 [batch, H] buffers (h, dh,
    h1, dh1), then four bf16 ones (their copies)."""
    return tuple(torch.empty((batch, net["hidden"]), dtype=dt, device=device)
                 for dt in (torch.float32,) * 4 + (torch.bfloat16,) * 4)
