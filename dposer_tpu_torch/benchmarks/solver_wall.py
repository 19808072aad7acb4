"""Wall time of one completion solve: the kernel Adam solver of the
completion task alone, on the card.

The flagship config and the pinned checkpoint, 100 poses x 10 hypotheses
(1,000 rows) x 2x100 Adam steps, time strategy '3', in-kernel normals, the
left leg masked, through ``DPoserComp.optimize_hypos`` as ``python -m
dposer_tpu_torch.demo --task completion`` and ``chip_smoke.py`` (5c) run it,
without loading, body model or evaluation. Each call is timed on the host
clock between two synchronisations, with the kernels' launch counters read
after it; a warm-up call comes first.

    python -m dposer_tpu_torch.benchmarks.solver_wall [--calls 5] [--ckpt-path P]

It imports only what every version of the port since the completion solver
has, so the same file can time another tree: ``PYTHONPATH=<tree> python
<this file>`` from that tree's root. Prints a line per call and one JSON
line with the walls, the launches and the card's name and power limit.
``--device cpu`` with small ``--poses``, ``--hypo`` and step counts runs the
kernels' plain versions on host normals, to check the script.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from dposer_tpu_torch import demo
from dposer_tpu_torch.config import get_config
from dposer_tpu_torch.diffusion.sde import build_sde
from dposer_tpu_torch.ops.cuda import fused_em
from dposer_tpu_torch.tasks.completion import DPoserComp
from dposer_tpu_torch.utils.masks import create_mask

CKPT = os.path.join("artifacts", "trained_r5", "axis-zscore-400k-synth.pth")
PART = "left_leg"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--ckpt-path", default=CKPT)
    ap.add_argument("--poses", type=int, default=100)
    ap.add_argument("--hypo", type=int, default=10)
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--steps-per-iter", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "not available"


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("solver_wall: no CUDA device; this benchmark runs on the card "
                         "(--device cpu checks the script)")
    dev = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
           else torch.device("cpu"))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    config = get_config()
    sde = build_sde(config)
    model, _ = demo.load_model(config, args.ckpt_path, dev)
    gen = torch.Generator(device=dev).manual_seed(42)
    poses = 0.5 * torch.randn(args.poses, model.n_poses * model.pose_dim, generator=gen,
                              device=dev)
    mask, obs = create_mask(poses, part=PART, generator=gen)
    comp = DPoserComp(sde, model=model, time_strategy="3", backend="cuda",
                      iterations=args.iterations, steps_per_iter=args.steps_per_iter,
                      device=dev)
    walls, launches = [], None
    with torch.no_grad():
        for c in range(1 + args.calls):
            fused_em.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            out = comp.optimize_hypos(obs, mask, args.hypo, gen)
            sync()
            wall = time.perf_counter() - t0
            if not torch.isfinite(out).all():
                raise RuntimeError("non-finite hypotheses")
            if c:  # the first call is the warm-up
                walls.append(wall)
                launches = fused_em.launch_counts()
            print(f"[solver_wall] call {c}{' (warm-up)' if not c else ''}: "
                  f"{wall * 1e3:.2f} ms")
    launches = {k: v for k, v in launches.items() if v}
    res = dict(device=torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
               smi=card_line(), rows=args.poses * args.hypo,
               steps=args.iterations * args.steps_per_iter, walls_ms=[w * 1e3 for w in walls],
               best_ms=min(walls) * 1e3, median_ms=sorted(walls)[len(walls) // 2] * 1e3,
               launches=launches)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
