"""Completion over the whole AMASS test split on the card (port of
``run/completion.py``).

    python -m dposer_tpu_torch.completion \\
        --ckpt-path artifacts/trained_r5/axis-zscore-400k-synth.pth \\
        --dataset-folder data/AMASS/amass_processed --version version1 \\
        --bodymodel-path SMPLX_NEUTRAL.npz --part left_leg --hypo 10 \\
        [--sample 10] [--batch_size 100] [--device cpu]

The test split (``<dataset-folder>/<version>/test/pose_body``, every
``--sample``-th pose) is completed batch by batch, the last partial batch
dropped: the ``--part`` joints are masked and filled with noise, completed
``--hypo`` times by DPoserComp (time strategy '3', 2 x 100 Adam steps, on an
SDE of ``--steps`` steps), and scored through the SMPL-X body as the minimum
over the hypotheses of the part-wise MPVPE and MPJPE (mm). Each batch's means
are printed, then the split's. Batch ``bi`` draws its mask and its
perturbations from a generator keyed by (``--seed``, ``bi``), so a batch's
result does not depend on which batches run beside it.

On ``--device cuda`` (the default) the solver is the kernel one (K5, K1 and
K6), whose whole loop is captured into one CUDA graph at the first batch and
replayed at every later one; a build or launch error propagates. On
``--device cpu`` the autograd solver runs. The split is normalized with the
normalizer's statistics (``--stats-dir``, by default the train split's).
``--gpus`` and ``--port`` are accepted and unused, as in the JAX CLI.

Within a process the solver shards each batch's rows over the process's
CUDA devices when there are several (``parallel.make_mesh``: on ``--device
cuda`` the visible ones, or under ``--multihost`` this process's share of
its host's), the batch padded to a multiple of their count and trimmed
after. Across processes, ``--multihost`` joins a gloo process group
(``parallel.init_distributed``: ``--coordinator host:port`` or a URL with
``--num-processes`` and ``--process-id``, or torchrun's environment), each
process completes its contiguous range of batches, the per-sample errors
are gathered and only process 0 prints the averages:

    python -m dposer_tpu_torch.completion ... --multihost \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0 &
    python -m dposer_tpu_torch.completion ... --multihost \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 1
    torchrun --nproc-per-node 2 -m dposer_tpu_torch.completion ... --multihost
"""
from __future__ import annotations

import argparse
import datetime
import sys
import time

import numpy as np
import torch

from .body_model import BodyModel
from .body_model.part_indices import BodyPartIndices
from .config import load_config
from .data import AMASSDataset
from .ops.cuda.fused_em import narrow_head_scope
from .ops.metrics import Evaler
from .parallel import (allgather_ragged_1d, init_distributed, make_mesh, mesh_route,
                       pad_batch_to_multiple, process_count, process_index,
                       shard_eval_batches)
from .smplify import (build_normalizer, cli_device, load_model_for_inference,
                      sequence_generator)
from .tasks import DPoserComp
from .utils.masks import create_mask

# how long the rendezvous and the gather wait for the other processes
DIST_TIMEOUT = datetime.timedelta(minutes=10)


def parse_args(argv):
    p = argparse.ArgumentParser(description="test diffusion model for completion on whole "
                                            "AMASS, on the GPU")
    p.add_argument("--config-path", default=None,
                   help="Python file with get_config() (default: the flagship config)")
    p.add_argument("--ckpt-path", default="./pretrained_models/axis-zscore-400k.pth")
    p.add_argument("--dataset-folder", default="../data/AMASS/amass_processed")
    p.add_argument("--version", default="version1")
    p.add_argument("--stats-dir", default=None,
                   help="normalizer stats directory (default: "
                        "<dataset-folder>/<version>/train)")
    p.add_argument("--bodymodel-path", default="../body_models/smplx/SMPLX_NEUTRAL.npz")
    p.add_argument("--hypo", type=int, default=1)
    p.add_argument("--part", default="left_leg", choices=BodyPartIndices.PARTS)
    p.add_argument("--steps", type=int, default=1000, help="the SDE's N")
    p.add_argument("--sample", type=int, default=None,
                   help="take every this many'th pose of the test split")
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--gpus", type=int, default=1, help="accepted for the reference's CLI; "
                                                       "unused")
    p.add_argument("--port", default="14600", help="unused")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process evaluation over a gloo process group: each process "
                        "completes its range of batches; give --coordinator, "
                        "--num-processes and --process-id, or run under torchrun")
    p.add_argument("--coordinator", default=None,
                   help="--multihost: the rendezvous, host:port or a tcp:// or file:// URL")
    p.add_argument("--num-processes", type=int, default=None, help="--multihost: world size")
    p.add_argument("--process-id", type=int, default=None, help="--multihost: this rank")
    return p.parse_args(argv)


def join_process_group(args) -> None:
    """``--multihost``: join the process group, or exit non-zero saying what
    is missing or what failed. The multi-process flags need it."""
    given = [flag for flag, v in (("--coordinator", args.coordinator),
                                  ("--num-processes", args.num_processes),
                                  ("--process-id", args.process_id)) if v is not None]
    if not args.multihost:
        if given:
            raise SystemExit(f"{', '.join(given)} given without --multihost")
        return
    try:
        init_distributed(args.coordinator, args.num_processes, args.process_id,
                         timeout=DIST_TIMEOUT)
    except (ValueError, RuntimeError) as e:  # a missing piece, or the rendezvous failed
        raise SystemExit(f"--multihost: {e}") from e


def complete_batch(comp: DPoserComp, normalizer, evaler: Evaler, batch, part: str,
                   hypo: int, generator: torch.Generator, fill=None, noise=None):
    """One batch of axis-angle poses [B, 63]: normalize, mask ``part``,
    complete it ``hypo`` times, denormalize and score -> (the hypotheses
    [B, hypo, 63] in axis-angle, ``Evaler.multi_eval_bodys``'s per-sample
    errors). ``fill`` [B, n] injects the mask's fill and ``noise`` [hypo,
    steps, B, 63] each hypothesis's perturbation normals."""
    normed = normalizer.offline_normalize(torch.as_tensor(batch, device=comp.device),
                                          from_axis=True)
    mask, observation = create_mask(normed, part=part, generator=generator, fill=fill)
    if noise is None:
        multihypo = comp.optimize_hypos(observation, mask, hypo, generator)
    else:
        multihypo = torch.stack([comp.optimize(observation, mask, noise=n) for n in noise], 1)
    preds = normalizer.offline_denormalize(multihypo, to_axis=True)
    return preds, evaler.multi_eval_bodys(preds, normalizer.offline_denormalize(
        normed, to_axis=True))


def run(args) -> dict:
    """Evaluate the split. Returns the per-sample ``mpvpe_all`` and
    ``mpjpe_body`` (mm, numpy; under ``--multihost`` every process's,
    gathered in batch order), ``n_batches`` (this process's),
    ``batch_indices``, ``route``, ``wall_s`` (the batches' seconds),
    ``batch_walls_s`` (each batch's) and ``loops`` (the kernel solvers'
    ``GraphLoop``s; none on the CPU)."""
    join_process_group(args)
    device = cli_device(args.device)
    # this process's devices: on "cuda" the visible ones, or under a process
    # group its share of its host's (processes that outnumber the cards
    # share them); a named device alone
    mesh = make_mesh() if device == torch.device("cuda") else make_mesh(devices=[device])
    device = mesh.devices[0]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    config = load_config(args.config_path)
    model, sde, score_fn = load_model_for_inference(config, args.ckpt_path, args.steps,
                                                    device)
    normalizer = build_normalizer(config, args.dataset_folder, args.version, args.stats_dir,
                                  device)
    dataset = AMASSDataset(args.dataset_folder, version=args.version, subset="test",
                           sample_interval=args.sample, rot_rep="axis", normalize=False)
    print(f"total samples with reduction: {len(dataset)}")
    body = BodyModel(args.bodymodel_path, num_betas=10, model_type="smplx", device=device)
    evaler = Evaler(body_model=body, part=args.part)
    n_dev = mesh.size
    print(f"data-parallel over {n_dev} device(s) of this process "
          f"({[str(d) for d in mesh.devices]}), {process_count()} process(es)")
    if device.type == "cuda" and narrow_head_scope(model, "solver"):
        comp = DPoserComp(sde, score_fn, config.training.continuous, backend="cuda",
                          model=model, device=device, mesh=mesh_route(mesh, device)[0])
        route = "kernel Adam-loop solver (K5, K1, K6; one CUDA graph a batch shape" + (
            ")" if n_dev == 1 else f" and shard, {n_dev} shards)")
    else:
        comp = DPoserComp(sde, score_fn, config.training.continuous, backend="torch",
                          device=device)
        route = "autograd Adam-loop solver" + (
            "" if device.type != "cuda" else
            f" (a pose of {model.n_poses * model.pose_dim} dims is outside the kernel solver's "
            f"scope)")
    print(f"[completion] {route}")

    batch_range = shard_eval_batches(len(dataset), args.batch_size)
    batches = list(dataset.eval_batches(args.batch_size))
    collected = {"mpvpe_all": [], "mpjpe_body": []}
    batch_walls = []
    for bi in batch_range:
        t0 = time.perf_counter()
        # pad to the mesh's size, trim after; the generator is keyed by the
        # batch's index, so a batch's result does not depend on the split
        padded, n_real = pad_batch_to_multiple(batches[bi], n_dev)
        _, res = complete_batch(comp, normalizer, evaler, padded, args.part, args.hypo,
                                sequence_generator(args.seed, bi, device))
        for k in collected:
            collected[k].append(np.asarray(res[k])[:n_real])
        batch_walls.append(time.perf_counter() - t0)
        print(f"batch {bi}: mpvpe {np.mean(collected['mpvpe_all'][-1]):.2f} "
              f"mpjpe {np.mean(collected['mpjpe_body'][-1]):.2f}")
    out = {k: np.concatenate(v) if v else np.zeros(0, np.float32)
           for k, v in collected.items()}
    if process_count() > 1:  # ragged when the batches do not divide the processes
        out = {k: allgather_ragged_1d(v) for k, v in out.items()}
    if process_index() == 0:
        for k, v in out.items():
            print(f"The average of {k} is {np.mean(v)}")
    return dict(out, n_batches=len(batch_walls), batch_indices=list(batch_range), route=route,
                wall_s=float(sum(batch_walls)), batch_walls_s=batch_walls,
                loops=[loop for s in comp.cuda_solvers() for loop in s.loops])


def main(argv=None) -> int:
    run(parse_args(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
