"""The matmul-chain microbenchmark on the card: 6 dependent
[512,1024]x[1024,1024] matmuls, then ``x = 0.5*x + 1e-3*h``, 1000 times,
in three forms (port of the TPU package's ``benchmarks/mxu_micro.py``):

- bf16 x bf16 with fp32 accumulation;
- "bf16 accumulator": Hopper's MMA has none, so the chain accumulates in
  fp32 and rounds each matmul's output to bf16;
- int8 x int8 -> int32 with the requantization every pass would pay,
  ``rint(h*21)`` clamped to +-127, and the rescale ``1/(21*127)``; each link
  writes the next link's int8 input in its epilogue, so the chain moves int8
  activations between links and the fp32 state only on a step's last link.

Each matmul is a launch of kernel K14 ``chain_link``; the state stays fp32
between links. Timing is steady state (``utils/benchtime.py``): ``m_pipe``
whole chains enqueued, one synchronisation, best of ``rounds``. Each row
prints ms per chain, us per matmul, T(FL)OP/s, a checksum, and the least time
the card could take for the chain (bytes at 3.35 TB/s against operations at
989 bf16 TFLOP/s or 1,979 int8 TOP/s, published H100 SXM peaks).

    python -m dposer_tpu_torch.benchmarks.mxu_micro [--device cpu] [--steps N]
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..ops.cuda.chain_link import chain_link, int8_rows, run_chain
from ..utils.benchtime import steady_state

B, H, N_STEPS, CHAIN = 512, 1024, 1000, 6
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
ROWS = (("bf16", "acc=float32"), ("bf16-out", "acc=bfloat16 (fp32 acc, bf16 out)"),
        ("int8", "acc=int32"))


def make_inputs(device, batch: int, hidden: int, seed: int = 0):
    """``x0`` [batch, hidden] fp32, six bf16 weights [hidden, hidden] (normal *
    0.03) and their int8 forms ``clip(rint(w*127/0.12))`` in K14's [N, K]
    layout."""
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randn(batch, hidden, generator=g)
    ws = [(torch.randn(hidden, hidden, generator=g) * 0.03).to(torch.bfloat16)
          for _ in range(CHAIN)]
    ws_i8 = [torch.clamp(torch.round(w.float() * (127.0 / 0.12)), -127, 127)
             .to(torch.int8).t().contiguous() for w in ws]
    return x0.to(device), [w.to(device) for w in ws], [w.to(device) for w in ws_i8]


def link_bound_s(mode: str, batch: int, k: int, n: int, update: bool,
                 first: bool = False) -> float:
    """Least seconds for one link: A read, W read, the output written (and the
    state read too on an updating link) at the memory rate, against the
    matmul's operations at the peak rate of its type. An int8 link reads its
    input as the int8 copy the link before it wrote (fp32 state only on a
    call's ``first`` link) and writes the next link's int8 copy, the fp32
    state only on an updating link."""
    if mode == "int8":
        n_bytes = (4 if first else 1) * batch * k + k * n + batch * n
        if update:
            n_bytes += 2 * 4 * batch * n
    else:
        n_bytes = 4 * batch * k + 2 * k * n + 4 * batch * n * (2 if update else 1)
    ops = 2 * batch * k * n
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS["int8" if mode == "int8" else "bf16"])


def chain_bound_s(mode: str, n_steps: int, batch: int = None) -> float:
    batch = B if batch is None else batch
    per_step = sum(link_bound_s(mode, batch, H, H, k == CHAIN - 1) for k in range(CHAIN))
    first_extra = link_bound_s(mode, batch, H, H, False, first=True) - link_bound_s(
        mode, batch, H, H, False)
    return n_steps * per_step + first_extra


def run_row(mode, x0, ws, ws_i8, n_steps, link=chain_link):
    """One chain of ``n_steps`` iterations from ``x0``; returns the state."""
    x = x0.clone()
    if mode == "int8":
        n = x.shape[1]
        return run_chain(x, ws_i8, mode, n_steps, link=link, **int8_rows(n, n, x.device))
    return run_chain(x, ws, mode, n_steps, link=link)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--steps", type=int, default=N_STEPS)
    p.add_argument("--m-pipe", type=int, default=8)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    x0, ws, ws_i8 = make_inputs(device, B, H)
    flops = 2 * B * H * H * CHAIN * args.steps
    results = []
    with torch.no_grad():
        for mode, acc in ROWS:
            x = run_row(mode, x0, ws, ws_i8, args.steps)  # warm-up: builds the kernel
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t = steady_state(lambda i: run_row(mode, x0, ws, ws_i8, args.steps),
                             m_pipe=args.m_pipe, rounds=args.rounds)
            bound = chain_bound_s(mode, args.steps)
            r = dict(mode=mode, acc=acc, ms=t * 1e3, us_per_matmul=t / args.steps / CHAIN * 1e6,
                     tops=flops / t / 1e12, checksum=float(x.abs().sum()),
                     bound_ms=bound * 1e3, steps=args.steps)
            results.append(r)
            print(f"op={mode:8s} {acc:35s} {r['ms']:9.2f} ms  {r['us_per_matmul']:6.2f} "
                  f"us/matmul  {r['tops']:7.1f} T(FL)OP/s  checksum={r['checksum']:.3e}  "
                  f"bound {r['bound_ms']:.2f} ms ({100 * bound / t:.0f}%)", flush=True)
    return results


if __name__ == "__main__":
    main()
