"""Headline benchmark of the port: 500-sample x 1000-step sub-VP pose generation.

The port's counterpart of the repository's ``bench.py``:

    python -m dposer_tpu_torch.bench                  # on the card
    python -m dposer_tpu_torch.bench --device cpu --samples 4 --steps 3

Prints ONE JSON line with ``bench.py``'s keys and metric name, and the
device it ran on: {"metric", "value", "unit", "vs_baseline",
"baseline_source", "device"}.

- value: poses/s of the flagship sampler (ScoreModelFC, 1024 hidden, 512
  embed, 2 blocks, axis rep: 63 dims; batch 500; sub-VP, N = 1000, eps
  1e-3, Euler-Maruyama, no corrector, the final denoise) through the CUDA
  kernels with in-kernel normals, the whole loop replayed as one CUDA graph
  (``get_cuda_em_sampler``'s default on the card). The weights are a seeded
  random init (``torch.manual_seed(0)``, as ``bench.py`` inits with
  ``PRNGKey(0)``); the rate does not depend on their values. Timed with
  ``utils.benchtime.steady_state`` (8 calls enqueued back to back, one
  synchronisation, best of 3 rounds) after one warm-up call, which also
  captures the graph.
- vs_baseline: value over the rate of the port's own ScoreModelFC and a
  per-step Python Euler-Maruyama loop in plain PyTorch on this machine's CPU
  (``bench.py``'s reference compute pattern, without the reference tree),
  extrapolated from 20 steps. Measured afresh at every run: no cache, no
  recorded constant; ``baseline_source`` says "fresh".

On the card the script refuses to start without CUDA. ``--device cpu`` runs
the kernels' plain versions on host normals (the eager loop) at a size
given by ``--samples`` and ``--steps``: a check of the script, not a
measurement of the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from .diffusion.sde import SubVPSDE
from .models.score_mlp import ScoreModelFC
from .ops.cuda.fused_em import get_cuda_em_sampler
from .utils.benchtime import steady_state

METRIC = "subvp_generation_poses_per_sec"
POSE_DIM = 63
PROBE_STEPS = 20


def flagship_model(device) -> ScoreModelFC:
    """The flagship ScoreModelFC, seeded random weights, in eval mode."""
    torch.manual_seed(0)
    return ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=1024, embed_dim=512,
                        n_blocks=2, dropout=0.1).to(device).eval()


def measure_sampler(model, samples: int, steps: int, device) -> float:
    """Steady-state poses/s of the kernel sampler: in-kernel normals and the
    graph loop on the card, host normals and the eager loop on the CPU."""
    sde = SubVPSDE(N=steps)
    cuda = device.type == "cuda"
    sampler = get_cuda_em_sampler(sde, model, (samples, POSE_DIM), eps=1e-3, denoise=True,
                                  rng_mode="kernel" if cuda else "host", device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    out = sampler(gen)  # warm-up: builds the kernels and captures the graph
    if cuda:
        torch.cuda.synchronize(device)
    if out.shape != (samples, POSE_DIM) or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"the sampler gave {tuple(out.shape)} or non-finite poses")
    t = steady_state(lambda i: sampler(gen), m_pipe=8 if cuda else 1)
    return samples / t


@torch.no_grad()
def measure_cpu_baseline(model: ScoreModelFC, samples: int, steps: int,
                         probe_steps: int = PROBE_STEPS) -> float:
    """The reference compute pattern on this machine's CPU: the port's
    ScoreModelFC and a per-step Python Euler-Maruyama loop in plain PyTorch,
    all threads, ``probe_steps`` steps timed after one warm-up step and
    extrapolated to ``steps``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        sde = SubVPSDE(N=steps)
        timesteps = torch.linspace(1.0, 1e-3, steps)
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(samples, POSE_DIM, generator=gen)
        dt = -1.0 / steps

        def em_step(x, t):
            vec_t = torch.ones(samples) * t
            drift, diffusion = sde.sde(x, vec_t)
            _, std = sde.marginal_prob(torch.zeros_like(x), vec_t)
            score = -model(x, vec_t * 999) / std[:, None]
            drift = drift - diffusion[:, None] ** 2 * score
            x_mean = x + drift * dt
            return x_mean + diffusion[:, None] * (-dt) ** 0.5 * torch.randn(
                x.shape, generator=gen)

        n = min(probe_steps, steps - 1)
        x = em_step(x, timesteps[0])  # warm-up
        t0 = time.perf_counter()
        for i in range(1, 1 + n):
            x = em_step(x, timesteps[i])
        per_step = (time.perf_counter() - t0) / n
    finally:
        torch.set_num_threads(threads)
    return samples / (per_step * steps)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0].strip()
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--steps", type=int, default=1000)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.steps < 2:
        raise SystemExit("bench: --steps must be at least 2")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: no CUDA device; this benchmark runs on the card "
                             "(--device cpu checks the script)")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    model = flagship_model("cpu")
    baseline = measure_cpu_baseline(model, args.samples, args.steps)
    value = measure_sampler(model.to(device), args.samples, args.steps, device)
    res = {
        "metric": METRIC,
        "value": round(value, 2),
        "unit": f"poses/s ({args.samples} samples x {args.steps} steps)",
        "vs_baseline": round(value / baseline, 2),
        "baseline_source": "fresh",
        "device": card_line() if device.type == "cuda" else "cpu",
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
