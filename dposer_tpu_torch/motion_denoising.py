"""Motion denoising on the card (port of ``run/motion_denoising.py``): noisy
3D joints -> clean pose sequences, for one file or a whole directory, with a
CSV log.

    python -m dposer_tpu_torch.motion_denoising \\
        --ckpt-path artifacts/trained_r5/axis-zscore-400k-synth.pth \\
        --stats-dir artifacts/trained_r5/stats --bodymodel-path SMPLX_NEUTRAL.npz \\
        --file-path Gestures_3_poses_batch005.npz --noise-std 0.04 [--device cpu]

A file (``pose_body`` [T, 63]) gets Gaussian noise of ``--noise-std`` m on
its SMPL-X joints and is denoised by ``MotionDenoise`` with the noise
level's schedule (3 x 40, 60 or 80 Adam steps) on an SDE of N = 500; the
per-frame init MPJPE, MPJPE and MPVPE (cm) are averaged and printed, and the
poses written to ``<outpath-folder>/denoised_poses.npz``. Without
``--file-path`` every ``.npz`` under ``--data-dir`` is denoised,
``--batch-fragments`` fragments of one length at a time as one batched
loss; each sequence draws its noise, its init and its prior's times and
normals from a generator of its own, keyed by (seed, index), so its result
does not depend on the batching. Each sequence's means go to
``<outpath-folder>/<dataset>_results_logging.csv``. In directory mode the
fragments of a batch split over this process's cards (``parallel.make_mesh``;
``run(args, mesh=)`` names other devices), which it prints when there are
several: each shard fits its fragments with their own generators, so the
results are those of one device. The prior's network runs
in fp32 under autograd through the body model (the JAX package runs it
under XLA, with no Pallas kernel); the prior's weight is 0.1 under time
strategy '1' and 1 otherwise (ref :317-322).
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch

from .body_model import BodyModel
from .config import load_config
from .parallel import make_mesh, mesh_route
from .smplify import (build_normalizer, cli_device, load_model_for_inference,
                      sequence_generator)
from .tasks.motion_denoising import MotionDenoise, noise_schedule_kwargs

SDE_N = 500  # ref run/motion_denoising.py:94, :119


def parse_args(argv):
    p = argparse.ArgumentParser(description="motion denoising (3D noisy joints -> clean "
                                            "poses) on the GPU")
    p.add_argument("--config", default=None,
                   help="Python file with get_config() (default: the flagship config)")
    p.add_argument("--dataset-folder", default="../data/AMASS/amass_processed")
    p.add_argument("--version", default="version1")
    p.add_argument("--stats-dir", default=None,
                   help="normalizer stats directory (default: "
                        "<dataset-folder>/<version>/train)")
    p.add_argument("--ckpt-path", default="./pretrained_models/axis-zscore-400k.pth")
    p.add_argument("--bodymodel-path", default="../body_models/smplx/SMPLX_NEUTRAL.npz")
    p.add_argument("--outpath-folder", default="./output/test_results/motion_denoise")
    p.add_argument("--noise-std", type=float, default=0.04)
    p.add_argument("--time-strategy", default="3", choices=["1", "2", "3"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--file-path", default=None, help="one sequence file to denoise")
    p.add_argument("--data-dir", default="../humor/out/amass_joints_noisy_fitting/results_out")
    p.add_argument("--dataset", default="AMASS")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch-fragments", type=int, default=8,
                   help="fragments denoised as one batched loss in directory mode")
    p.add_argument("--lr", type=float, default=None, help="Adam learning rate (default 0.03)")
    p.add_argument("--iterations", type=int, default=None,
                   help="override the schedule's iterations")
    p.add_argument("--steps-per-iter", type=int, default=None,
                   help="override the schedule's steps per iteration")
    return p.parse_args(argv)


def schedule_for(args) -> dict:
    """The noise level's schedule with the CLI's overrides."""
    sched = noise_schedule_kwargs(args.noise_std)
    if args.iterations is not None:
        sched["iterations"] = args.iterations
    if args.steps_per_iter is not None:
        sched["steps_per_iter"] = args.steps_per_iter
    return sched


def noisy_joints(body_model, gt_poses, std, generator):
    with torch.no_grad():
        joints = body_model(pose_body=gt_poses).Jtr[:, :22]
    return joints + std * torch.randn(joints.shape, generator=generator,
                                      device=joints.device)


def run(args, mesh=None) -> dict:
    """Denoise; returns the averages over every frame (``init_MPJPE``,
    ``MPJPE``, ``MPVPE`` in cm). ``mesh`` is the devices directory mode
    shards the fragments over, by default the process's visible CUDA devices
    on ``--device cuda`` and the CPU on ``--device cpu``."""
    device = cli_device(args.device)
    config = load_config(args.config)
    _, sde, score_fn = load_model_for_inference(config, args.ckpt_path, SDE_N, device)
    normalizer = build_normalizer(config, args.dataset_folder, args.version, args.stats_dir,
                                  device)
    dposer_weight = 1e-1 if args.time_strategy == "1" else 1.0
    lr = args.lr if args.lr is not None else 0.03
    sched = schedule_for(args)
    body_model = BodyModel(args.bodymodel_path, num_betas=10, model_type="smplx",
                           device=device)

    def load(path):
        with np.load(path) as f:
            return torch.as_tensor(f["pose_body"].astype(np.float32), device=device)

    if args.file_path is not None:
        os.makedirs(args.outpath_folder, exist_ok=True)
        gt = load(args.file_path)
        generator = torch.Generator(device=device).manual_seed(args.seed)
        md = MotionDenoise(sde, score_fn, body_model, normalizer, dposer_weight=dposer_weight,
                           batch_size=len(gt), lr=lr)
        results = md.optimize(noisy_joints(body_model, gt, args.noise_std, generator), gt,
                              time_strategy=args.time_strategy, verbose=True,
                              generator=generator, **sched)
        np.savez(os.path.join(args.outpath_folder, "denoised_poses.npz"),
                 pose_body=md.last_poses.cpu().numpy())
        averages = {k: float(np.mean(v)) for k, v in results.items()}
        for k, v in averages.items():
            print(f"The average of {k} is {v}")
        return averages

    if mesh is None:
        mesh = make_mesh() if device.type == "cuda" else make_mesh(devices=[device])
    mesh, _ = mesh_route(mesh, device)
    if mesh is not None:
        print(f"batched fragments data-parallel over {mesh.size} devices")

    def replica(dev):
        """The prior, the body model and the normalizer on another device."""
        return (load_model_for_inference(config, args.ckpt_path, SDE_N, dev)[2],
                BodyModel(args.bodymodel_path, num_betas=10, model_type="smplx", device=dev),
                build_normalizer(config, args.dataset_folder, args.version, args.stats_dir, dev))

    seqs = sorted(os.path.relpath(os.path.join(root, f), args.data_dir)
                  for root, _, files in os.walk(args.data_dir) for f in files
                  if f.endswith(".npz"))
    print(f"Test dataset consists of {len(seqs)} sequences")
    os.makedirs(args.outpath_folder, exist_ok=True)
    csv_path = os.path.join(args.outpath_folder, f"{args.dataset}_results_logging.csv")
    gts = {seq: load(os.path.join(args.data_dir, seq)) for seq in seqs}
    by_len = {}
    for i, seq in enumerate(seqs):
        by_len.setdefault(gts[seq].shape[0], []).append((i, seq))
    results_by_seq = {}
    for T, group in sorted(by_len.items()):
        md = MotionDenoise(sde, score_fn, body_model, normalizer, dposer_weight=dposer_weight,
                           batch_size=T, lr=lr, mesh=mesh, replica=replica)
        for c0 in range(0, len(group), args.batch_fragments):
            chunk = group[c0:c0 + args.batch_fragments]
            gens = [sequence_generator(args.seed, i, device) for i, _ in chunk]
            noisy = torch.stack([noisy_joints(body_model, gts[seq], args.noise_std, g)
                                 for (_, seq), g in zip(chunk, gens)])
            poses = md.optimize_batch(noisy, time_strategy=args.time_strategy,
                                      generators=gens, **sched)
            for j, (_, seq) in enumerate(chunk):
                res = md.metrics(poses[j], noisy[j], gts[seq])
                results_by_seq[seq] = res
                print(f"{seq}: init {res['init_MPJPE'].mean():.4f} cm -> "
                      f"MPJPE {res['MPJPE'].mean():.4f} cm")
    all_results = {}
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["Sequence", "init_MPJPE", "MPJPE", "MPVPE"])
        for seq in seqs:
            res = results_by_seq[seq]
            writer.writerow([seq] + [np.mean(res[k]) for k in ["init_MPJPE", "MPJPE", "MPVPE"]])
            for k, v in res.items():
                all_results.setdefault(k, []).extend(np.asarray(v).tolist())
    averages = {k: float(np.mean(v)) for k, v in all_results.items()}
    for k, v in averages.items():
        print(f"The average of {k} is {v}")
    return averages


def main(argv=None) -> int:
    run(parse_args(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
