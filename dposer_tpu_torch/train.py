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

Not ported: ``--multihost``, ``--coordinator``, ``--num-processes``,
``--process-id`` and ``--profile-dir`` (see ROADMAP.md).
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
from .diffusion.score_fn import get_score_fn
from .diffusion.sde import build_sde, sampling_eps_for
from .models import create_score_model
from .ops.cuda.fused_em import get_cuda_em_hypo_sampler, get_cuda_em_sampler
from .ops.cuda.fused_train import get_cuda_step_fn, scope_error
from .ops.metrics import Evaler, average_pairwise_distance
from .ops.rotations import rot6d_to_axis_angle
from .utils import checkpoint as ckpt_lib
from .utils.generic import MetricWriter, close_logger, create_logger
from .utils.masks import create_mask
from .utils.profiling import StepTimer

HYPO_NUM = 5
LOSS_EPS = 1e-5


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
    step's loss), ``windows`` ((steps, seconds) per window), ``best_apd``
    and ``checkpoints``."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available "
                             "(pass --device cpu to train on the CPU)")
        device = torch.device("cuda", torch.cuda.current_device())
    config = load_config(args.config)
    tcfg = config.training

    logger, out_dir = create_logger(config.OUTPUT_DIR, config.DATASET.TRAIN_DATASET,
                                    config.DATASET.TEST_DATASET, "train", name=args.name)
    logger.info(pprint.pformat(config))
    logger.info(pprint.pformat(vars(args)))
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
    sampling_eps = sampling_eps_for(sde)
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
    logger.info(f"train step: {route}")

    K = max(1, args.steps_per_dispatch)
    batch_size = tcfg.batch_size

    def upload(array):
        """Host to device without a host synchronisation: a pageable copy
        would wait for every step already queued on the stream."""
        t = torch.from_numpy(array)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    if args.host_data:
        def window_batches(rows):
            return [upload(train_dataset.poses[r]) for r in rows]
        logger.info("train data: host gather, one upload per batch")
    else:
        data_dev = torch.as_tensor(train_dataset.poses, device=device)

        def window_batches(rows):
            idx = upload(np.stack(rows))  # one [K, B] int32 upload a window
            return [data_dev.index_select(0, idx[j]) for j in range(len(rows))]
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

    def evaluate(step, best_apd):
        model_e = load_ema()
        gen = torch.Generator(device=device).manual_seed(eval_seed(args.seed, step))
        score_fn = get_score_fn(sde, model_e, continuous=tcfg.continuous)
        likelihood = get_likelihood_fn(sde, score_fn, rtol=1e-4, atol=1e-4, eps=1e-4)
        eb = config.eval.batch_size
        sc = config.sampling
        sample_kw = dict(eps=sampling_eps, denoise=sc.noise_removal, corrector=sc.corrector,
                         snr=sc.snr, n_corrector_steps=sc.n_steps_each,
                         predictor=sc.predictor, device=device,
                         rng_mode="kernel" if device.type == "cuda" else "host")
        sampler = get_cuda_em_sampler(sde, model_e, (eb, dim), **sample_kw)
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
                    hypo = get_cuda_em_hypo_sampler(sde, model_e, (eb, dim), HYPO_NUM,
                                                    **sample_kw)(gen, observation, mask)
                    preds, gts = denormalize(hypo), denormalize(poses)
                    if config.data.rot_rep == "rot6d":
                        preds = rot6d_to_axis_angle(preds.reshape(-1, 6)).reshape(eb, HYPO_NUM, -1)
                        gts = rot6d_to_axis_angle(gts.reshape(-1, 6)).reshape(eb, -1)
                    res = Evaler(body_model_vis, part="left_leg").multi_eval_bodys(preds, gts)
                    metrics_e["mpvpe_all"].append(float(np.mean(res["mpvpe_all"])))
                    metrics_e["mpjpe_body"].append(float(np.mean(res["mpjpe_body"])))
                samples.append(sampler(gen))
            if not samples:  # a test split smaller than one eval batch
                samples.append(sampler(gen))
            for k, v in metrics_e.items():
                if v:
                    writer.add_scalar(f"eval_{k}", float(np.mean(v)), step)
            samples_dn = denormalize(torch.cat(samples)[:50])
            if config.data.rot_rep == "rot6d":
                samples_dn = rot6d_to_axis_angle(samples_dn.reshape(-1, 6)).reshape(-1, N_POSES * 3)
            apd = 0.0
            if body_model_vis is not None:
                apd = float(average_pairwise_distance(body_model_vis(pose_body=samples_dn).Jtr[:, :22]))
                logger.info(f"APD: {apd}")
                writer.add_scalar("APD", apd, step)
        np.savez(os.path.join(out_dir, "last_samples.npz"),
                 pose_samples=samples_dn.cpu().numpy()[None])
        logger.info("validating completed")
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
    while step < n_iters and not stop["flag"]:
        k_this = min(K, n_iters - step)
        t0 = time.perf_counter()
        pending = []
        for j, batch in enumerate(window_batches([next(idx_stream) for _ in range(k_this)])):
            gen.manual_seed(noise_seed(args.seed, step + j))
            noise = dict(generator=gen)
            if kernel_route:
                noise["dropout_seed"] = dropout_seed(args.seed, step + j)
            pending.append(train_step(state, batch, **noise))
        keys = list(pending[0])
        values = torch.stack([torch.stack([ld[k] for k in keys]) for ld in pending]).tolist()
        windows.append((k_this, time.perf_counter() - t0))
        timer.tick()
        prev_step, step = step, state.step
        for j, row in enumerate(values):
            s_j = prev_step + j + 1
            all_losses.append(row[0])
            for k, v in zip(keys, row):
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
        if stop["flag"]:
            break
        if step % tcfg.eval_freq < k_this:
            logger.info("start validating")
            best_apd = evaluate(step, best_apd)
        if step % tcfg.save_freq < k_this:
            logger.info(f"Save checkpoint to {out_dir}")
            save_checkpoint()

    if stop["flag"]:
        logger.info(f"preemption checkpoint saved: {save_checkpoint()}")
    for sig, handler in prev_handlers.items():
        signal.signal(sig, handler)
    writer.close()
    logger.info(f"End. Final output dir: {out_dir}")
    close_logger(logger)
    return dict(output_dir=out_dir, route=route, step=state.step, losses=all_losses,
                windows=windows, best_apd=best_apd, checkpoints=checkpoints, state=state)


if __name__ == "__main__":
    main()
    sys.exit(0)
