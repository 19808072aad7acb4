"""Generation demo on the card (port of ``run/demo.py --task generation``).

    python -m dposer_tpu_torch.demo --task generation \\
        --ckpt-path artifacts/trained_r5/axis-zscore-400k-synth.pth \\
        --stats-dir artifacts/trained_r5/stats --output-path output/torch \\
        [--metrics --smpl-path SMPL_NEUTRAL.npz] [--device cpu]

Generation samples 50 poses with the config's sampler (sub-VP EM, no
corrector, through the CUDA kernels) and writes them, denormalized to
axis-angle, to ``<output-path>/generation/samples.npz`` (``pose_samples``).
``--metrics`` runs the 500-sample protocol (EM + langevin corrector, eps
5e-3) through the SMPL body and prints the APD (ref run/demo.py:338-405).
Rendering, the self-intersection metric and the other tasks are not ported
yet. On ``--device cpu`` the kernels' plain versions run, with host-drawn
normals.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import N_POSES
from .body_model import BodyModel
from .config import load_config
from .data import PoseNormalizer
from .diffusion.sde import build_sde, sampling_eps_for
from .models import create_score_model
from .ops.cuda.fused_em import get_cuda_em_sampler
from .ops.metrics import average_pairwise_distance
from .utils.checkpoint import load_params_for_inference

SAMPLE_NUM = 50
METRICS_SAMPLE_NUM = 500
METRICS_EPS = 5e-3


def parse_args(argv):
    p = argparse.ArgumentParser(description="DPoser generation on the GPU")
    p.add_argument("--task", default="generation", choices=["generation"])
    p.add_argument("--config-path", default=None,
                   help="Python file with get_config() (default: the flagship "
                        "sub-VP ScoreModelFC config)")
    p.add_argument("--ckpt-path", default="./pretrained_models/axis-zscore-400k.pth")
    p.add_argument("--dataset-folder", default="./data/AMASS/amass_processed")
    p.add_argument("--version", default="version1")
    p.add_argument("--stats-dir", default=None,
                   help="normalizer stats directory (default: "
                        "<dataset-folder>/<version>/train)")
    p.add_argument("--smpl-path", default="../body_models/smpl/SMPL_NEUTRAL.npz",
                   help="SMPL model file (for --metrics)")
    p.add_argument("--metrics", action="store_true")
    p.add_argument("--output-path", default="./output/test_results")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def load_model(config, ckpt_path: str, device):
    """The config's ScoreModelFC with the checkpoint's EMA weights, in eval
    mode on ``device``; returns ``(model, training step)``."""
    model = create_score_model(config, n_poses=N_POSES)
    state_dict, step = load_params_for_inference(ckpt_path)
    model.load_state_dict(state_dict, strict=True)
    return model.eval().to(device), step


def build_sampler(config, sde, model, batch: int, eps: float, corrector: str, device):
    """The config's PC sampler through the CUDA kernels: Philox normals drawn
    in the kernels on the card, host normals with the plain versions on the
    CPU."""
    if config.sampling.method != "pc":
        raise NotImplementedError(f"sampling method {config.sampling.method!r} "
                                  f"is not ported yet")
    device = torch.device(device)
    return get_cuda_em_sampler(
        sde, model, (batch, model.n_poses * model.pose_dim), eps=eps,
        denoise=config.sampling.noise_removal,
        rng_mode="kernel" if device.type == "cuda" else "host",
        corrector=corrector, snr=config.sampling.snr,
        n_corrector_steps=config.sampling.n_steps_each,
        predictor=config.sampling.predictor, device=device)


def run(args) -> dict:
    """The generation task. Returns ``samples_file``, ``step`` and, with
    ``--metrics``, ``apd`` and ``metrics_wall_s``."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    config = load_config(args.config_path)
    model, step = load_model(config, args.ckpt_path, device)
    print(f"=> loaded checkpoint '{args.ckpt_path}' (step {step})")
    sde = build_sde(config)
    stats_dir = args.stats_dir or os.path.join(args.dataset_folder, args.version, "train")
    normalizer = PoseNormalizer(stats_dir, normalize=config.data.normalize,
                                min_max=config.data.min_max,
                                rot_rep=config.data.rot_rep, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    sampler = build_sampler(config, sde, model, SAMPLE_NUM, sampling_eps_for(sde),
                            config.sampling.corrector, device)
    samples = normalizer.offline_denormalize(sampler(generator), to_axis=True)
    target = os.path.join(args.output_path, "generation")
    os.makedirs(target, exist_ok=True)
    out = dict(samples_file=os.path.join(target, "samples.npz"), step=step)
    np.savez(out["samples_file"], pose_samples=samples.cpu().numpy())
    print(f"samples saved to {out['samples_file']}")

    if args.metrics:
        t0 = time.perf_counter()
        sampler = build_sampler(config, sde, model, METRICS_SAMPLE_NUM, METRICS_EPS,
                                "langevin", device)
        samples = normalizer.offline_denormalize(sampler(generator), to_axis=True)
        # Pose-NDF protocol: SMPL body, zero-padded hand joints
        body = BodyModel(args.smpl_path, num_betas=10, model_type="smpl", device=device)
        pose = torch.cat([samples, torch.zeros(METRICS_SAMPLE_NUM, 6, device=device)], 1)
        out["apd"] = float(average_pairwise_distance(body(pose_body=pose).Jtr[:, :22]))
        out["metrics_wall_s"] = time.perf_counter() - t0
        print(f"[metrics] protocol wall (build+sample+APD): {out['metrics_wall_s']:.2f}s")
        print("average_pairwise_distance for 500 generated samples", out["apd"])
    return out


def main(argv=None) -> int:
    run(parse_args(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
