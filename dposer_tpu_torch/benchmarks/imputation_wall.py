"""Wall time of one completion2 pc call: the demo's multi-hypothesis
imputation sampler alone, on the card.

The flagship config and the pinned checkpoint, 50 poses x 10 hypotheses
(500 rows) x 1000 reverse steps, in-kernel normals, the left leg masked, as
``python -m dposer_tpu_torch.demo --task completion2 --sampler pc`` runs
it, without loading, body model or evaluation. Each call is timed on the
host clock between two synchronisations, with the kernels' launch counters
read after it; a warm-up call comes first.

    python -m dposer_tpu_torch.benchmarks.imputation_wall [--calls 5] [--ckpt-path P]

It imports only what every version of the port since the imputation
sampler has, so the same file can time another tree: ``PYTHONPATH=<tree>
python <this file>`` from that tree's root. Prints a line per call and one
JSON line with the walls, the launches and the card's name and power limit.
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
from dposer_tpu_torch.diffusion.sde import build_sde, sampling_eps_for
from dposer_tpu_torch.ops.cuda import fused_em
from dposer_tpu_torch.utils.masks import create_mask

CKPT = os.path.join("artifacts", "trained_r5", "axis-zscore-400k-synth.pth")
POSES, HYPO, PART = 50, 10, "left_leg"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--ckpt-path", default=CKPT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("imputation_wall: no CUDA device; this benchmark runs on the card")
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    config = get_config()
    sde = build_sde(config)
    model, _ = demo.load_model(config, args.ckpt_path, dev)
    gen = torch.Generator(device=dev).manual_seed(42)
    poses = 0.5 * torch.randn(POSES, model.n_poses * model.pose_dim, generator=gen, device=dev)
    mask, obs = create_mask(poses, part=PART, generator=gen)
    s = config.sampling
    sampler = fused_em.get_cuda_em_hypo_sampler(
        sde, model, tuple(obs.shape), HYPO, eps=sampling_eps_for(sde), denoise=s.noise_removal,
        corrector=s.corrector, snr=s.snr, n_corrector_steps=s.n_steps_each,
        predictor=s.predictor, rng_mode="kernel", device=dev)
    walls, launches = [], None
    with torch.no_grad():
        for c in range(1 + args.calls):
            fused_em.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sampler(gen, obs, mask)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not torch.isfinite(out).all():
                raise RuntimeError("non-finite hypotheses")
            if c:  # the first call is the warm-up
                walls.append(wall)
                launches = fused_em.launch_counts()
            print(f"[imputation_wall] call {c}{' (warm-up)' if not c else ''}: "
                  f"{wall * 1e3:.2f} ms")
    launches = {k: v for k, v in launches.items() if v}
    res = dict(device=torch.cuda.get_device_name(0), smi=smi, rows=POSES * HYPO,
               steps=int(sde.N), walls_ms=[w * 1e3 for w in walls],
               best_ms=min(walls) * 1e3, median_ms=sorted(walls)[len(walls) // 2] * 1e3,
               launches=launches)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
