"""Kernel K14 ``chain_link`` (``csrc/chain_link.cu``): one matmul of the
microbenchmarks' dependent chains, with its plain PyTorch version and the
chain the benchmarks run (``dposer_tpu_torch/benchmarks``).

Port of the two TPU microbenchmark kernels, ``benchmarks/mxu_micro.py`` (a
chain of 6 dependent [512,1024]x[1024,1024] matmuls, 1000 times, in bf16 with
fp32 or bf16 accumulation, or int8 with the per-pass requantization) and
``benchmarks/ilp_probe.py`` (the same chain with GroupNorm and SiLU after
each matmul). The TPU runs the whole loop in one program with the state in
VMEM; here a link is a launch, the state ``x`` stays fp32 in device memory
between links, and the chain's last link fuses ``x = 0.5*x + 1e-3*h``.

Modes: ``"bf16"`` (K1's main loop, fp32 output), ``"bf16-out"`` (the same,
the output rounded to bf16: Hopper's MMA has no bf16 accumulator),
``"int8"`` (K13's main loops, ``W`` int8 [N, K], a quantization row ``qinv``
and a rescale row ``qs``; the benchmark's are 21 and 1/(21*127)) and
``"gn-silu"`` (K1's epilogue with gamma 1, beta 0 and no time row). In the
int8 chain the links hand the activation on as int8, as the TPU benchmark's
per-pass requantization defines it: a link reads ``a_q = q(h)`` written by
the link before it (the Hopper int8 loop) and writes the next one's; only a
call's first link reads the fp32 state (the register-staged loop).

The plain version sums each product exactly in float64 and rounds once to
fp32, so a row's result does not depend on how many rows are computed with
it; the kernel accumulates in fp32 (bf16 modes) or exactly in int32 (int8).
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ...diffusion.fast_sampler import _group_norm
from . import build
from .quant import int8_matmul, quantize_act
from .score_net import NUM_GROUPS, _check, _ptr, check_int8_input

MODES = {"bf16": 0, "bf16-out": 1, "int8": 2, "gn-silu": 3}
INT8_QINV = 21.0  # the TPU microbenchmark's requantization: rint(h * 21)
INT8_SCALE = float(np.float32(1.0 / (21.0 * 127.0)))  # and its rescale


def chain_link_plain(a, w, mode: str, qinv=None, qs=None, a_q=None):
    """One link's output ``h`` (``w`` [K, N] bf16, or [N, K] int8 in mode
    "int8", where ``a_q``, when given, is ``q(a)`` already)."""
    if mode == "int8":
        aq = quantize_act(a, qinv) if a_q is None else a_q.float()
        return int8_matmul(aq, w.t()) * qs
    h = (a.to(torch.bfloat16).double() @ w.double()).float()
    if mode == "bf16-out":
        return h.to(torch.bfloat16).float()
    if mode == "gn-silu":
        return F.silu(_group_norm(h, 1.0, 0.0, num_groups=NUM_GROUPS))
    return h


def chain_link_plain_into(a, w, mode: str, *, out=None, update: bool = False, qinv=None,
                          qs=None, a_q=None, qinv_next=None, out_q=None):
    """The plain version with the wrapper's signature, on any device."""
    h = chain_link_plain(a, w, mode, qinv, qs, a_q)
    y = out * 0.5 + h * 1e-3 if update else h
    if out_q is not None:
        out_q.copy_(quantize_act(y, qinv_next).to(torch.int8))
    if out is None:
        return out_q
    return out.copy_(y)


def _chain_link_fn():
    fn = build.load("chain_link").dposer_chain_link
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I, I, I, I, I, P]
        fn.restype = I
    return fn


def chain_link(a, w, mode: str, *, out=None, update: bool = False, qinv=None, qs=None,
               a_q=None, qinv_next=None, out_q=None):
    """K14 on ``a`` [B, K] fp32: writes ``out`` [B, N] fp32 with the link's
    output, or with ``update=True`` rewrites the chain's state ``out`` (which
    must not be ``a``) as ``0.5*out + 1e-3*h``; returns ``out``.

    Mode "int8" only: ``a_q`` int8 [B, K] (``q(a)``, written by the link
    before) routes the link through the Hopper int8 loop, ``a`` may then be
    None; ``qinv_next`` [N] fp32 and ``out_q`` int8 [B, N] make it write
    ``q(out, qinv_next)`` as well, the next link's ``a_q``; given ``out_q``
    and no ``out`` (and no update), the link writes only ``out_q`` and
    returns it. Each launch adds one to ``launches`` and to its route's
    count in ``routes``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if mode != "int8" and not (a_q is None and qinv_next is None and out_q is None):
        raise ValueError("a_q, qinv_next and out_q belong to mode 'int8'")
    B, K = (a if a_q is None else a_q).shape
    dev = w.device
    if a_q is None or a is not None:
        _check("a", a, dev, torch.float32, (B, K))
    if mode == "int8":
        N = w.shape[0]
        _check("w", w, dev, torch.int8, (N, K))
        if a_q is None:
            _check("qinv", qinv, dev, torch.float32, (K,))
        else:
            check_int8_input(a_q, w, B, K)
        _check("qs", qs, dev, torch.float32, (N,))
        if (out_q is None) != (qinv_next is None):
            raise ValueError("out_q and qinv_next come together")
        if out_q is not None:
            _check("out_q", out_q, dev, torch.int8, (B, N))
            _check("qinv_next", qinv_next, dev, torch.float32, (N,))
    else:
        N = w.shape[1]
        _check("w", w, dev, torch.bfloat16, (K, N))
    if out is None:
        if update:
            raise ValueError("update=True rewrites the state passed as out=")
        if out_q is None:
            out = torch.empty((B, N), dtype=torch.float32, device=dev)
    if out is not None:
        _check("out", out, dev, torch.float32, (B, N))
        if update and a is not None and out.data_ptr() == a.data_ptr():
            raise ValueError("the state out= must not be the link's input a")
    if dev.type == "cpu":
        return chain_link_plain_into(a, w, mode, out=out, update=update, qinv=qinv, qs=qs,
                                     a_q=a_q, qinv_next=qinv_next, out_q=out_q)
    if dev.type != "cuda":
        raise ValueError(f"chain_link runs on cpu or cuda, not {dev}")
    if K % 16 or N % 64 or (mode == "int8" and K > 1024) or (
            mode == "gn-silu" and N // NUM_GROUPS not in (2, 4, 8, 16, 32)):
        raise ValueError(f"chain_link kernel needs K % 16 == 0, N % 64 == 0 (int8: K <= "
                         f"1024; gn-silu: N/32 in {{2,4,8,16,32}}); got K={K}, N={N}")
    err = _chain_link_fn()(_ptr(a) if a_q is None else None, _ptr(a_q), w.data_ptr(),
                           _ptr(qinv), _ptr(qs), _ptr(qinv_next), _ptr(out), _ptr(out_q),
                           MODES[mode], int(update), B, K, N,
                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"chain_link launch failed: CUDA error {err}")
    chain_link.launches += 1
    chain_link.routes["wgmma" if mode != "int8" else
                      "register" if a_q is None else "wgmma_int8"] += 1
    return out if out is not None else out_q


chain_link.launches = 0
chain_link.routes = {"wgmma": 0, "wgmma_int8": 0, "register": 0}


def int8_rows(K: int, N: int, device) -> dict:
    """The int8 mode's rows for the microbenchmark: ``qinv`` [K] of 21 and
    ``qs`` [N] of fp32 1/(21*127)."""
    return dict(qinv=torch.full((K,), INT8_QINV, device=device),
                qs=torch.full((N,), INT8_SCALE, device=device))


def run_chain(x, ws, mode: str, n_steps: int, bufs=None, link=chain_link, **rows):
    """``n_steps`` iterations of the chain on the state ``x`` [B, H] in place:
    ``h = x``, then ``h = link(h, w)`` for each ``w`` of ``ws``, the last
    link updating ``x = 0.5*x + 1e-3*h``. ``bufs`` are two [B, H] scratch
    buffers (int8 in mode "int8"); ``link`` is K14 or its plain version;
    ``rows`` are the int8 mode's ``qinv`` and ``qs``. In mode "int8" the
    links hand ``q(h)`` on (``qinv`` quantizes every link's input, the chain
    being square) and only the call's first link reads the fp32 ``x``.
    Returns ``x``."""
    int8 = mode == "int8"
    if bufs is None:
        bufs = tuple(torch.empty(x.shape, dtype=torch.int8 if int8 else x.dtype,
                                 device=x.device) for _ in range(2))
    a_q = None  # the int8 copy of the next link's input, once a link has written one
    for _ in range(n_steps):
        a = x
        for k, w in enumerate(ws):
            last = k == len(ws) - 1
            if int8:
                dst = bufs[1] if a_q is bufs[0] else bufs[0]
                link(a if a_q is None else None, w, mode, out=x if last else None,
                     update=last, a_q=a_q, qinv_next=rows["qinv"], out_q=dst, **rows)
                a_q = dst
            else:
                link(a, w, mode, out=x if last else bufs[k % 2], update=last, **rows)
                a = bufs[k % 2]
    return x
