"""Probe: do independent row chains overlap on the card? (port of the TPU
package's ``benchmarks/ilp_probe.py``).

A step of the sampler is a dependent chain per batch: matmul -> GroupNorm ->
SiLU, six deep, then an elementwise state update. Every operation is
row-independent, so the 512 rows can run as 1, 2 or 4 row chains without
changing one computed value. The TPU probe interleaves the chains op by op
inside one program, to overlap vector work with the matrix unit; here each
chain runs on its own CUDA stream, the host issuing their launches op by op,
so the card may run independent chains' kernels at once. Each link is a launch
of kernel K14 ``chain_link`` in its GN+SiLU mode (no affine; GroupNorm over
32 groups of consecutive features). A 64-row tile never straddles a 128- or
256-row chain, so every split must be bit-identical to the whole run.

    python -m dposer_tpu_torch.benchmarks.ilp_probe [--device cpu] [--steps N]
"""
from __future__ import annotations

import argparse
import contextlib
import sys

import torch

from ..ops.cuda.chain_link import chain_link
from ..utils.benchtime import steady_state
from . import mxu_micro

B, H, N_STEPS, CHAIN = 512, 1024, 1000, 6
SPLITS = (1, 2, 4)


def run_split(x, ws, n_split: int, n_steps: int, link=chain_link):
    """``n_steps`` steps of the GN+SiLU chain on ``x`` [B, H] in place, its
    rows cut into ``n_split`` chains, each on its own CUDA stream on the card;
    returns ``x``."""
    if x.shape[0] % n_split:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_split} chains")
    rows = x.shape[0] // n_split
    views = [x[s * rows:(s + 1) * rows] for s in range(n_split)]
    bufs = [(torch.empty_like(v), torch.empty_like(v)) for v in views]
    streams = None
    if x.device.type == "cuda" and n_split > 1:
        main_stream = torch.cuda.current_stream(x.device)
        streams = [torch.cuda.Stream(x.device) for _ in views]
        for st in streams:
            st.wait_stream(main_stream)
    for _ in range(n_steps):
        a = list(views)
        for k, w in enumerate(ws):
            last = k == len(ws) - 1
            for s in range(n_split):  # the chains' launches interleaved op by op
                ctx = torch.cuda.stream(streams[s]) if streams else contextlib.nullcontext()
                with ctx:
                    link(a[s], w, "gn-silu", out=views[s] if last else bufs[s][k % 2],
                         update=last)
                a[s] = bufs[s][k % 2]
    if streams:
        for st in streams:
            main_stream.wait_stream(st)
    return x


def step_bound_s(batch: int = None) -> float:
    """Least seconds for one step (six links, the last updating the state)."""
    batch = B if batch is None else batch
    return sum(mxu_micro.link_bound_s("gn-silu", batch, H, H, k == CHAIN - 1)
               for k in range(CHAIN))


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
    x0, ws, _ = mxu_micro.make_inputs(device, B, H)
    results, ref = [], None
    with torch.no_grad():
        for n_split in SPLITS:
            x = run_split(x0.clone(), ws, n_split, args.steps)  # warm-up: builds the kernel
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            same = None if ref is None else bool(torch.equal(ref, x))
            ref = x if ref is None else ref
            t = steady_state(lambda i: run_split(x0.clone(), ws, n_split, args.steps),
                             m_pipe=args.m_pipe, rounds=args.rounds)
            r = dict(n_split=n_split, ms=t * 1e3, us_per_step=t / args.steps * 1e6,
                     bitwise_equal_whole=same, steps=args.steps,
                     bound_us_per_step=step_bound_s() * 1e6)
            results.append(r)
            if same is not None:
                print(f"  split{n_split} bitwise == whole: {same}")
            print(f"n_split={n_split}  {r['ms']:9.2f} ms  {r['us_per_step']:8.2f} us/step  "
                  f"(bound {r['bound_us_per_step']:.2f})", flush=True)
    return results


if __name__ == "__main__":
    main()
