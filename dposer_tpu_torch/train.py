"""Training CLI on the card (port of ``run/train.py``): score-matching
training with periodic evaluation (bits/dim, left-leg completion MPVPE and
MPJPE, generation APD), checkpoints, and best-by-APD model selection.

    python -m dposer_tpu_torch.train [--config CONFIG.py] \\
        --dataset-folder data/AMASS/amass_processed --version version1 \\
        [--bodymodel-path SMPLX_NEUTRAL.npz] [--restore-dir DIR_OR_PTH] \\
        [--train-kernel auto|on|off] [--device cuda|cpu]

``--config`` is a Python file with ``get_config()`` (default: the flagship
sub-VP ScoreModelFC, ``dposer_tpu_torch/config.py``). The run directory is
``<OUTPUT_DIR>/<train>_<test>/<time>[-name]``: ``train.log``,
``tb/metrics.jsonl``, ``checkpoint-step<N>.pth`` (the reference schema,
resumable), ``best_model.pth`` and ``last_samples.npz``.

Routes. ``--train-kernel auto`` (the default) takes the kernel step
(``ops/cuda/fused_train.py``: the network's forward and backward through
K10, K11 and K12) on the card whenever the config is inside the kernels'
scope, and the autograd step (``diffusion/losses.py``) otherwise and off the
card; ``on`` takes the kernel step or raises (on the CPU it runs the
kernels' plain versions); ``off`` takes the autograd step. The JAX trainer
defaults to ``off``, because its TPU kernel only tied XLA there; this
default rests on the card's own measurements (PERF.md). A kernel that fails
to build or launch raises; nothing falls back. The log names the route.

Data. The normalized train tensor is uploaded once and each batch is
gathered on the device by the index stream (``AMASSDataset.
train_index_batches``), a window's indices in one pinned, asynchronous upload;
``--host-data`` gathers on the host and uploads every batch instead.

Step noise. Step ``s`` draws its ``t``, ``z`` and (the autograd route) its
dropout masks from a generator seeded by ``(seed, s)``, and the kernel
route's dropout hash is keyed by another pure function of ``(seed, s)``;
with the index stream's ``skip=`` this makes a resumed run repeat an
uninterrupted one. That is this package's contract; the JAX trainer's
``fold_in`` keys are its own.

``--steps-per-dispatch K`` runs K steps between reads of the losses (one
host synchronisation per window); log, eval and save fire when a window
crosses a multiple of their frequency. SIGTERM and SIGINT end the run at the
next window and write a resumable checkpoint.

Evaluation builds its kernel samplers once, at the first firing, and loads
the EMA weights into them in place at every firing
(``parallel.data_parallel_sampler_params``): on the card the first firing
captures their graphs and every later one replays them. The samples draw
from a generator of their own, seeded by ``(seed, step)``.

Data parallelism (``--multihost``): one process a device, over a process
group (``parallel.init_distributed``: ``--coordinator host:port`` or a URL
with ``--num-processes`` and ``--process-id``, else torchrun's environment,
``torchrun --nproc-per-node N -m dposer_tpu_torch.train ... --multihost``).
The global batch (the config's ``batch_size``) must divide the process
count; each process takes its contiguous columns of the one index stream's
batches and trains on them (``parallel.data_parallel_multi_step``), its
draws made at the global batch's shape and sliced and the kernels' dropout
hash keyed by global row, so the run is the one-process run up to the order
of the gradients' sums. One all-reduce a step averages the gradients and the
losses (NCCL where every process of a host has a card of its own, else
gloo); clipping, Adam and the EMA then run alike on every rank. Each process
takes the card ``parallel.process_devices`` gives it, keeps its own run
directory (``-rank<r>`` after the name), its checkpoints and its
evaluation; the processes agree on a SIGTERM in the last step's all-reduce
of a window, so all of them checkpoint the same step. A process that sees
several cards without ``--multihost`` trains on the first.

``--profile-dir DIR`` traces local steps 10-20 of the run (the windows from
the first that starts at or after local step 10 to the first that ends at or
after step 20) with ``torch.profiler`` into one Chrome trace file in
``DIR``, the program's spans on (``utils.profiling``): each window is a
span ``dp.train_step_<s>`` (``dp.train_steps_<a>-<b>`` for a window of
several steps) around ``dp.train.window`` and its steps. The evaluation
writes ``last_samples.npz`` with ``pose_samples`` [1, 50, 63] and
``pose_trajs`` [10, 5, 63], the generation sampler's states at steps 0,
N/10, ... of the last call's first five rows, as axis-angle.
"""
from __future__ import annotations

import argparse
import glob
import os
import pprint
import re
import signal
import sys
import time

import numpy as np
import torch

from . import N_POSES
from .body_model import BodyModel
from .config import load_config
from .data import AMASSDataset
from .diffusion import losses as losses_lib
from .diffusion.likelihood import get_likelihood_fn
from .diffusion.sampling import get_pc_sampler
from .diffusion.score_fn import get_score_fn
from .diffusion.sde import build_sde, sampling_eps_for
from .models import create_score_model
from .ops.cuda import build
from .ops.cuda.fused_em import (get_cuda_em_hypo_sampler, get_cuda_em_sampler,
                                in_kernel_scope)
from .ops.cuda.fused_train import get_cuda_step_fn, scope_error
from .ops.cuda.graph_loop import GraphLoop
from .ops.metrics import Evaler, average_pairwise_distance
from .ops.rotations import rot6d_to_axis_angle
from .parallel import sharding as par
from .utils import checkpoint as ckpt_lib
from .utils.generic import MetricWriter, close_logger, create_logger
from .utils.masks import create_mask
from .utils.profiling import StepTimer, Trace, span

HYPO_NUM = 5
LOSS_EPS = 1e-5
TRAJ_ROWS = 5  # the rows of the eval trajectory kept in last_samples.npz
PROFILE_STEPS = (10, 20)  # --profile-dir: the local steps traced


def trajectory_steps(n: int) -> range:
    """The grid steps the eval's generation sampler records: every tenth of
    the N steps from step 0 (JAX keeps ``trajs[::N // 10]``)."""
    return range(0, n, max(1, n // 10))


def parse_args(argv):
    p = argparse.ArgumentParser(description="train the diffusion pose prior on the GPU")
    p.add_argument("--config", default=None,
                   help="Python file with get_config() (default: the flagship config)")
    p.add_argument("--dataset-folder", default="./data/AMASS/amass_processed")
    p.add_argument("--version", default="version1")
    p.add_argument("--bodymodel-path", default="../body_models/smplx/SMPLX_NEUTRAL.npz",
                   help="SMPL-X model file (completion and APD eval; skipped when absent)")
    p.add_argument("--restore-dir", default=None,
                   help="resume: a directory (its newest checkpoint-step*.pth) or a .pth")
    p.add_argument("--shape", type=bool, default=False)
    p.add_argument("--sample", type=int, help="sample the train set to reduce data")
    p.add_argument("--name", default="")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--host-data", action="store_true",
                   help="gather each batch on the host and upload it, instead of the "
                        "device-resident train tensor")
    p.add_argument("--train-kernel", choices=("auto", "on", "off"), default="auto",
                   help="auto: the kernel step on the card when the config is in its "
                        "scope, else the autograd step; on: the kernel step or raise; "
                        "off: the autograd step")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="steps between reads of the losses (one host sync per window)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel over a process group, one process a device "
                        "(torchrun's environment, or --coordinator, --num-processes and "
                        "--process-id)")
    p.add_argument("--coordinator", default=None,
                   help="the group's rendezvous: host:port, tcp://... or file://...")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="trace local steps 10-20 (host and card, torch.profiler) into one "
                        "Chrome trace file in this directory")
    return p.parse_args(argv)


def _seed_words(*words: int) -> np.ndarray:
    return np.random.SeedSequence([int(w) for w in words]).generate_state(2, np.uint32)


def noise_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator (t, z, autograd dropout)."""
    w = _seed_words(seed, step, 0)
    return (int(w[0]) << 31) | (int(w[1]) >> 1)


def dropout_seed(seed: int, step: int) -> int:
    """The kernel route's dropout hash seed at step ``step``."""
    return int(_seed_words(seed, step, 1)[0])


def eval_seed(seed: int, step: int) -> int:
    """The seed of the eval at step ``step`` (its own stream)."""
    return int(_seed_words(seed, step, 2)[0])


def sample_seed(seed: int, step: int) -> int:
    """The seed of the eval's generation samples at step ``step``."""
    return int(_seed_words(seed, step, 3)[0])


def eval_sampler_kwargs(config, sde, device) -> dict:
    """The keywords of the eval's kernel samplers (``get_cuda_em_sampler``):
    the config's sampling settings, in-kernel normals on the card."""
    sc = config.sampling
    return dict(eps=sampling_eps_for(sde), denoise=sc.noise_removal, corrector=sc.corrector,
                snr=sc.snr, n_corrector_steps=sc.n_steps_each, predictor=sc.predictor,
                device=device, rng_mode="kernel" if device.type == "cuda" else "host")


def plain_eval_samplers(config, sde, score_fn, shape, device) -> dict:
    """The eval's samplers on the plain PC loop (``get_pc_sampler``) for a
    config outside the kernels' scope, as the JAX trainer samples every
    config (ref run/train.py:308-317), in the forms of the kernel ones:
    ``sample(model, generator) -> (trajs, x)``, ``trajs`` the states after
    ``trajectory_steps``, and ``hypo(model, generator, observation, mask)
    -> [B, HYPO_NUM, D]``. ``score_fn`` reads the weights the eval loads, so
    ``model`` is not read."""
    sc = config.sampling
    kw = dict(predictor=sc.predictor, corrector=sc.corrector, snr=sc.snr,
              n_steps=sc.n_steps_each, probability_flow=sc.probability_flow,
              denoise=sc.noise_removal, eps=sampling_eps_for(sde), device=device)
    sample = get_pc_sampler(sde, shape, score_fn, return_trajectory=True, **kw)
    impute = get_pc_sampler(sde, shape, score_fn, imputation=True, **kw)
    steps = list(trajectory_steps(sde.N))

    def run_sample(model, generator):
        trajs, x = sample(generator)
        return trajs[steps], x

    def run_hypo(model, generator, observation, mask):
        return torch.stack([impute(generator, observation=observation, mask=mask)
                            for _ in range(HYPO_NUM)], dim=1)

    return dict(sample=run_sample, hypo=run_hypo)


def newest_checkpoint(path: str):
    if os.path.isfile(path):
        return path
    found = glob.glob(os.path.join(path, "checkpoint-step*.pth"))
    if not found:
        return None
    return max(found, key=lambda p: int(re.search(r"step(\d+)", os.path.basename(p)).group(1)))


def select_route(args, config, sde, model, device):
    """``(step_fn, route name, takes_dropout_seed)`` for ``--train-kernel``."""
    t = config.training
    why = scope_error(sde, model, t.continuous, t.auxiliary_loss)
    use_kernel = (args.train_kernel == "on"
                  or (args.train_kernel == "auto" and device.type == "cuda" and why is None))
    if use_kernel:
        if why is not None:
            raise NotImplementedError(f"--train-kernel on: {why}")
        step_fn = get_cuda_step_fn(sde, model, reduce_mean=t.reduce_mean,
                                   likelihood_weighting=t.likelihood_weighting, eps=LOSS_EPS)
        where = "CUDA kernels" if device.type == "cuda" else "their plain versions"
        return step_fn, f"kernel step: K10/K11/K12 on {where}", True
    return None, "autograd step" + (f" ({why})" if why and args.train_kernel == "auto"
                                    and device.type == "cuda" else ""), False


def main(argv=None) -> dict:
    """Train; returns ``output_dir``, ``route``, ``step``, ``losses`` (each
    step's loss), ``windows`` ((steps, seconds) per window), ``best_apd``,
    ``checkpoints``, ``state``, ``last_eval`` (the last firing's ``step``,
    its generation ``samples`` and the last sampler call's ``trajs`` [10, B,
    D], normalized), and this process's
    ``device``, ``rank`` and the process count ``world``."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to train on the CPU)")
    if args.multihost:
        par.init_distributed(args.coordinator, args.num_processes, args.process_id,
                             backend="auto" if device.type == "cuda" else "gloo")
    rank, world = par.process_index(), par.process_count()
    if device.type == "cuda":
        device = (par.process_devices(torch.cuda.device_count(), *par.host_share())[0]
                  if world > 1 else torch.device("cuda", torch.cuda.current_device()))
        torch.cuda.set_device(device)
    config = load_config(args.config)
    tcfg = config.training
    if tcfg.batch_size % world:
        raise ValueError(f"batch {tcfg.batch_size} must be divisible by the {world} "
                         f"processes")

    name = args.name if world == 1 else f"{args.name}-rank{rank}".lstrip("-")
    logger, out_dir = create_logger(config.OUTPUT_DIR, config.DATASET.TRAIN_DATASET,
                                    config.DATASET.TEST_DATASET, "train", name=name)
    logger.info(pprint.pformat(config))
    logger.info(pprint.pformat(vars(args)))
    if world > 1:
        logger.info(f"data-parallel: process {rank} of {world} on {device}, gradient "
                    f"all-reduce over {par.grad_backend()}, {tcfg.batch_size // world} of "
                    f"{tcfg.batch_size} rows a step")
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        logger.info(f"{torch.cuda.device_count()} CUDA devices visible: training on {device} "
                    f"alone; one process a card (torchrun --nproc-per-node "
                    f"{torch.cuda.device_count()} ... --multihost) is the multi-card route, "
                    f"though on four H100s it is slower than one card at a global batch of "
                    f"1,280 or 5,120, where the step is host-bound, and 1.16x faster at "
                    f"20,480 (python -m dposer_tpu_torch.benchmarks.data_parallel)")
    writer = MetricWriter(os.path.join(out_dir, "tb"))

    body_model_vis = None
    if args.bodymodel_path and os.path.exists(args.bodymodel_path):
        body_model_vis = BodyModel(args.bodymodel_path, num_betas=10, model_type="smplx",
                                   device=device)
    else:
        logger.info("body model unavailable -> completion/APD eval disabled")

    data_kw = dict(rot_rep=config.data.rot_rep, return_shape=args.shape,
                   normalize=config.data.normalize, min_max=config.data.min_max)
    train_dataset = AMASSDataset(args.dataset_folder, version=args.version, subset="train",
                                 sample_interval=args.sample, **data_kw)
    test_dataset = AMASSDataset(args.dataset_folder, version=args.version, subset="test",
                                sample_interval=100, **data_kw)
    denormalize = (train_dataset.Denormalize if config.data.normalize else (lambda x: x))
    logger.info(f"total train samples: {len(train_dataset)}")
    logger.info(f"total test samples: {len(test_dataset)}")

    pose_dim = 3 if config.data.rot_rep == "axis" else 6
    dim = N_POSES * pose_dim
    torch.manual_seed(args.seed)
    model = create_score_model(config, n_poses=N_POSES).to(device).train()
    logger.info(f"model params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    state = losses_lib.init_train_state(config, model)

    if args.restore_dir and os.path.exists(args.restore_dir):
        path = newest_checkpoint(args.restore_dir)
        if path is not None:
            logger.info(f"=> loading checkpoint: {path}")
            info = ckpt_lib.restore_train_state(path, state)
            logger.info(f"=> loaded checkpoint (step {state.step}; optimizer state "
                        f"{'restored' if info['optimizer_restored'] else 'fresh'})")

    sde = build_sde(config)
    train_step, route, kernel_route = select_route(args, config, sde, model, device)
    if train_step is None:
        aux = {}
        if tcfg.auxiliary_loss:
            body_train = BodyModel(args.bodymodel_path, num_betas=10, model_type="smplx",
                                   device=device)

            def body_fn(pose_axis):
                out = body_train(pose_body=pose_axis)
                return out.v, out.Jtr

            aux = dict(auxiliary_loss=True, denormalize=denormalize, body_model_fn=body_fn,
                       rot_rep=config.data.rot_rep, denoise_steps=tcfg.denoise_steps,
                       rot6d_to_axis=rot6d_to_axis_angle)
        train_step = losses_lib.get_step_fn(
            sde, True, losses_lib.make_model_apply(model), reduce_mean=tcfg.reduce_mean,
            continuous=tcfg.continuous, likelihood_weighting=tcfg.likelihood_weighting, **aux)
    logger.info(f"train step: {route}" + (f"; data-parallel over {world} processes "
                                          f"({par.grad_backend()}), this one on {device}"
                                          if world > 1 else ""))

    K = max(1, args.steps_per_dispatch)
    batch_size = tcfg.batch_size

    def upload(array):
        """Host to device without a host synchronisation: a pageable copy
        would wait for every step already queued on the stream."""
        t = torch.from_numpy(array)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    # this process's columns of each [K, B] index window of the one stream
    if args.host_data:
        multi_step = par.data_parallel_multi_step(train_step)

        def run_window(idx, noise, extra):
            return multi_step(state, [upload(train_dataset.poses[r]) for r in idx], noise, extra)
        logger.info("train data: host gather, one upload per batch")
    else:
        data_dev = torch.as_tensor(train_dataset.poses, device=device)
        multi_step = par.data_parallel_multi_step_indexed(train_step)

        def run_window(idx, noise, extra):
            # one [K, B / n] int32 upload a window
            return multi_step(state, upload(np.ascontiguousarray(idx)), data_dev, noise, extra)
        logger.info(f"train data device-resident ({train_dataset.poses.nbytes / 2**20:.0f} "
                    f"MiB); batches gathered by index")

    eval_model = create_score_model(config, n_poses=N_POSES).to(device).eval()

    def load_ema():
        sd = state.model.state_dict()
        names = [n for n, p in state.model.named_parameters() if p.requires_grad]
        sd.update(zip(names, state.ema.shadow_params))
        eval_model.load_state_dict(sd)
        return eval_model

    stop = {"flag": False}

    def request_stop(signum, frame):
        logger.info(f"signal {signum} received -> checkpoint and exit")
        stop["flag"] = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, request_stop)
        except ValueError:
            pass  # not the main thread

    checkpoints = []

    def save_checkpoint(name=None):
        path = os.path.join(out_dir, name or f"checkpoint-step{state.step}.pth")
        ckpt_lib.save_checkpoint(path, state)
        checkpoints.append(path)
        return path

    eb = config.eval.batch_size
    score_e = get_score_fn(sde, eval_model, continuous=tcfg.continuous)
    likelihood = get_likelihood_fn(sde, score_e, rtol=1e-4, atol=1e-4, eps=1e-4)
    eval_samplers = {}

    def samplers():
        """The eval's samplers, built once on ``eval_model``: in the kernels'
        scope the kernel samplers, run on the weights each firing loads
        (``_params`` forms); else the plain PC loop on ``eval_model``
        itself, which ``load_ema`` updates in place."""
        if not eval_samplers:
            if in_kernel_scope(config.sampling, eval_model):
                kw = eval_sampler_kwargs(config, sde, device)
                eval_samplers["sample"] = par.data_parallel_sampler_params(
                    get_cuda_em_sampler(sde, eval_model, (eb, dim), **kw,
                                        trajectory_steps=trajectory_steps(sde.N)))
                eval_samplers["hypo"] = par.multi_hypothesis_imputation_sampler_params(
                    get_cuda_em_hypo_sampler(sde, eval_model, (eb, dim), HYPO_NUM, **kw))
            else:
                eval_samplers.update(plain_eval_samplers(config, sde, score_e, (eb, dim),
                                                         device))
                logger.info(f"eval sampler: plain PC loop (predictor="
                            f"{config.sampling.predictor}, corrector="
                            f"{config.sampling.corrector}): outside the kernels' scope")
        return eval_samplers["sample"], eval_samplers["hypo"]

    last_eval = {}

    def evaluate(step, best_apd):
        model_e = load_ema()
        gen = torch.Generator(device=device).manual_seed(eval_seed(args.seed, step))
        gen_s = torch.Generator(device=device).manual_seed(sample_seed(args.seed, step))
        captures = GraphLoop.captures
        encodes = build.tma_encodes("dense_gn_silu") if device.type == "cuda" else 0
        sampler, hypo_sampler = samplers()
        metrics_e = {"bpd": [], "mpvpe_all": [], "mpjpe_body": []}
        samples = []
        with torch.no_grad():
            for poses in test_dataset.eval_batches(eb):
                poses = torch.as_tensor(poses, device=device)
                bpd, _, nfe = likelihood(gen, poses)
                logger.info(f"Sample bpd: {float(bpd.mean())} with nfe: {nfe}")
                metrics_e["bpd"].append(float(bpd.mean()))
                if body_model_vis is not None:
                    mask, observation = create_mask(poses, part="left_leg", generator=gen)
                    hypo = hypo_sampler(model_e, gen, observation, mask)
                    preds, gts = denormalize(hypo), denormalize(poses)
                    if config.data.rot_rep == "rot6d":
                        preds = rot6d_to_axis_angle(preds.reshape(-1, 6)).reshape(eb, HYPO_NUM, -1)
                        gts = rot6d_to_axis_angle(gts.reshape(-1, 6)).reshape(eb, -1)
                    res = Evaler(body_model_vis, part="left_leg").multi_eval_bodys(preds, gts)
                    metrics_e["mpvpe_all"].append(float(np.mean(res["mpvpe_all"])))
                    metrics_e["mpjpe_body"].append(float(np.mean(res["mpjpe_body"])))
                trajs, x = sampler(model_e, gen_s)
                samples.append(x)
            if not samples:  # a test split smaller than one eval batch
                trajs, x = sampler(model_e, gen_s)
                samples.append(x)
            for k, v in metrics_e.items():
                if v:
                    writer.add_scalar(f"eval_{k}", float(np.mean(v)), step)
            samples_dn = denormalize(torch.cat(samples)[:50])
            trajs_s = trajs[:, :TRAJ_ROWS]  # the last call's trajectory
            trajs_dn = denormalize(trajs_s)
            if config.data.rot_rep == "rot6d":
                samples_dn = rot6d_to_axis_angle(samples_dn.reshape(-1, 6)).reshape(-1, N_POSES * 3)
                trajs_dn = rot6d_to_axis_angle(trajs_dn.reshape(-1, 6))
            trajs_dn = trajs_dn.reshape(trajs_s.shape[0], trajs_s.shape[1], -1)
            apd = 0.0
            if body_model_vis is not None:
                apd = float(average_pairwise_distance(body_model_vis(pose_body=samples_dn).Jtr[:, :22]))
                logger.info(f"APD: {apd}")
                writer.add_scalar("APD", apd, step)
        np.savez(os.path.join(out_dir, "last_samples.npz"),
                 pose_trajs=trajs_dn.cpu().numpy(), pose_samples=samples_dn.cpu().numpy()[None])
        last_eval.update(step=step, samples=torch.cat(samples), trajs=trajs)
        new_encodes = build.tma_encodes("dense_gn_silu") - encodes if device.type == "cuda" else 0
        logger.info(f"validating completed: {GraphLoop.captures - captures} graph(s) captured, "
                    f"{new_encodes} tensor map(s) encoded")
        if apd > best_apd:
            best_apd = apd
            logger.info(f"saving best checkpoint, APD: {best_apd}")
            save_checkpoint("best_model.pth")
        return best_apd

    n_iters = tcfg.n_iters
    step = state.step
    idx_stream = train_dataset.train_index_batches(batch_size, seed=args.seed, skip=step)
    gen = torch.Generator(device=device)
    timer = StepTimer()
    metrics, metrics_n, best_apd = {}, 0, 0.0
    all_losses, windows = [], []

    def noise(j):
        gen.manual_seed(noise_seed(args.seed, step + j))
        kw = dict(generator=gen)
        if kernel_route:
            kw["dropout_seed"] = dropout_seed(args.seed, step + j)
        return kw

    # with several processes a SIGTERM must stop all of them at one step: the
    # flag rides in the window's last all-reduce, and the processes halt on
    # the agreed value
    agree = (lambda: {"stop": float(stop["flag"])}) if world > 1 else None
    halt = stop["flag"]
    local_step, trace, traced = 0, None, False
    while step < n_iters and not halt:
        k_this = min(K, n_iters - step)
        if args.profile_dir and trace is None and not traced and local_step >= PROFILE_STEPS[0]:
            trace = Trace(args.profile_dir, device)
        t0 = time.perf_counter()
        name = (f"train_step_{step + 1}" if k_this == 1
                else f"train_steps_{step + 1}-{step + k_this}")
        with span(name):
            idx = par.shard_global_multi_batch(
                np.stack([next(idx_stream) for _ in range(k_this)]))
            values = run_window(idx, noise, agree)
        halt = values[-1].pop("stop") > 0 if agree is not None else stop["flag"]
        windows.append((k_this, time.perf_counter() - t0))
        local_step += k_this
        if trace is not None and local_step >= PROFILE_STEPS[1]:
            logger.info(f"trace of local steps {PROFILE_STEPS[0]}-{PROFILE_STEPS[1]} saved "
                        f"to {trace.stop()}")
            trace, traced = None, True
        timer.tick()
        prev_step, step = step, state.step
        for j, row in enumerate(values):
            s_j = prev_step + j + 1
            all_losses.append(row["step_loss"])
            for k, v in row.items():
                metrics[k] = metrics.get(k, 0.0) + v
            metrics_n += 1
            if s_j % tcfg.log_freq == 0:
                msg = f"Iter: [{s_j}/{n_iters}, {s_j / n_iters * 100:.2f}%],\t"
                for k in list(metrics):
                    writer.add_scalar(k, metrics[k] / metrics_n, s_j)
                    msg += f"{k}: {metrics[k] / metrics_n:.6f},\t"
                    metrics[k] = 0.0
                metrics_n = 0
                if timer.steps_per_sec:
                    msg += f"steps/s: {timer.steps_per_sec * K:.1f},\t"
                    writer.add_scalar("steps_per_sec", timer.steps_per_sec * K, s_j)
                logger.info(msg)
        if halt:
            break
        if step % tcfg.eval_freq < k_this:
            logger.info("start validating")
            best_apd = evaluate(step, best_apd)
        if step % tcfg.save_freq < k_this:
            logger.info(f"Save checkpoint to {out_dir}")
            save_checkpoint()

    if trace is not None:  # the run ended inside the traced steps
        logger.info(f"trace of local steps {PROFILE_STEPS[0]}-{local_step} saved to "
                    f"{trace.stop()}")
    if halt:
        logger.info(f"preemption checkpoint saved: {save_checkpoint()}")
    for sig, handler in prev_handlers.items():
        signal.signal(sig, handler)
    writer.close()
    logger.info(f"End. Final output dir: {out_dir}")
    close_logger(logger)
    return dict(output_dir=out_dir, route=route, step=state.step, losses=all_losses,
                windows=windows, best_apd=best_apd, checkpoints=checkpoints, state=state,
                last_eval=last_eval, device=device, rank=rank, world=world)


if __name__ == "__main__":
    main()
    sys.exit(0)
