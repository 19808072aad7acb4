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
``"int8"`` (K13's main loop, ``W`` int8 [N, K], a quantization row ``qinv``
and a rescale row ``qs``; the benchmark's are 21 and 1/(21*127)) and
``"gn-silu"`` (K1's epilogue with gamma 1, beta 0 and no time row).

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
from .score_net import NUM_GROUPS, _check, _ptr

MODES = {"bf16": 0, "bf16-out": 1, "int8": 2, "gn-silu": 3}
INT8_QINV = 21.0  # the TPU microbenchmark's requantization: rint(h * 21)
INT8_SCALE = float(np.float32(1.0 / (21.0 * 127.0)))  # and its rescale


def chain_link_plain(a, w, mode: str, qinv=None, qs=None):
    """One link's output ``h`` (``w`` [K, N] bf16, or [N, K] int8 in mode
    "int8")."""
    if mode == "int8":
        return int8_matmul(quantize_act(a, qinv), w.t()) * qs
    h = (a.to(torch.bfloat16).double() @ w.double()).float()
    if mode == "bf16-out":
        return h.to(torch.bfloat16).float()
    if mode == "gn-silu":
        return F.silu(_group_norm(h, 1.0, 0.0, num_groups=NUM_GROUPS))
    return h


def chain_link_plain_into(a, w, mode: str, *, out, update: bool = False, qinv=None,
                          qs=None):
    """The plain version with the wrapper's signature, on any device."""
    h = chain_link_plain(a, w, mode, qinv, qs)
    return out.copy_(out * 0.5 + h * 1e-3 if update else h)


def _chain_link_fn():
    fn = build.load("chain_link").dposer_chain_link
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
        fn.restype = I
    return fn


def chain_link(a, w, mode: str, *, out=None, update: bool = False, qinv=None, qs=None):
    """K14 on ``a`` [B, K] fp32: writes ``out`` [B, N] fp32 with the link's
    output, or with ``update=True`` rewrites the chain's state ``out`` (which
    must not be ``a``) as ``0.5*out + 1e-3*h``; returns ``out``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    B, K = a.shape
    dev = a.device
    _check("a", a, dev, torch.float32, (B, K))
    if mode == "int8":
        N = w.shape[0]
        _check("w", w, dev, torch.int8, (N, K))
        _check("qinv", qinv, dev, torch.float32, (K,))
        _check("qs", qs, dev, torch.float32, (N,))
    else:
        N = w.shape[1]
        _check("w", w, dev, torch.bfloat16, (K, N))
    if out is None:
        if update:
            raise ValueError("update=True rewrites the state passed as out=")
        out = torch.empty((B, N), dtype=torch.float32, device=dev)
    _check("out", out, dev, torch.float32, (B, N))
    if update and out.data_ptr() == a.data_ptr():
        raise ValueError("the state out= must not be the link's input a")
    if dev.type == "cpu":
        return chain_link_plain_into(a, w, mode, out=out, update=update, qinv=qinv, qs=qs)
    if dev.type != "cuda":
        raise ValueError(f"chain_link runs on cpu or cuda, not {dev}")
    if K % 16 or N % 64 or (mode == "int8" and K > 1024) or (
            mode == "gn-silu" and N // NUM_GROUPS not in (2, 4, 8, 16, 32)):
        raise ValueError(f"chain_link kernel needs K % 16 == 0, N % 64 == 0 (int8: K <= "
                         f"1024; gn-silu: N/32 in {{2,4,8,16,32}}); got K={K}, N={N}")
    err = _chain_link_fn()(a.data_ptr(), w.data_ptr(), _ptr(qinv), _ptr(qs), out.data_ptr(),
                           MODES[mode], int(update), B, K, N,
                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"chain_link launch failed: CUDA error {err}")
    chain_link.launches += 1
    return out


chain_link.launches = 0


def int8_rows(K: int, N: int, device) -> dict:
    """The int8 mode's rows for the microbenchmark: ``qinv`` [K] of 21 and
    ``qs`` [N] of fp32 1/(21*127)."""
    return dict(qinv=torch.full((K,), INT8_QINV, device=device),
                qs=torch.full((N,), INT8_SCALE, device=device))


def run_chain(x, ws, mode: str, n_steps: int, bufs=None, link=chain_link, **rows):
    """``n_steps`` iterations of the chain on the state ``x`` [B, H] in place:
    ``h = x``, then ``h = link(h, w)`` for each ``w`` of ``ws``, the last
    link updating ``x = 0.5*x + 1e-3*h``. ``bufs`` are two [B, H] scratch
    buffers; ``link`` is K14 or its plain version; ``rows`` are the int8
    mode's ``qinv`` and ``qs``. Returns ``x``."""
    if bufs is None:
        bufs = (torch.empty_like(x), torch.empty_like(x))
    for _ in range(n_steps):
        a = x
        for k, w in enumerate(ws):
            last = k == len(ws) - 1
            link(a, w, mode, out=x if last else bufs[k % 2], update=last, **rows)
            a = bufs[k % 2]
    return x
