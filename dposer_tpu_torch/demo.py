"""Generation, pose-completion and interpolation demo on the card (port of
``run/demo.py``).

    python -m dposer_tpu_torch.demo --task generation \\
        --ckpt-path artifacts/trained_r5/axis-zscore-400k-synth.pth \\
        --stats-dir artifacts/trained_r5/stats --output-path output/torch \\
        [--metrics --smpl-path SMPL_NEUTRAL.npz] [--device cpu]
    python -m dposer_tpu_torch.demo --task completion2 --sampler hybrid \\
        --file-path poses.npz --bodymodel-path SMPLX_NEUTRAL.npz --part left_leg ...
    python -m dposer_tpu_torch.demo --task interpolation --file-path poses.npz ...

Generation samples 50 poses with the config's sampler (sub-VP EM, no
corrector, through the CUDA kernels; with ``sampling.method = "ode"`` the
125-step RK4 probability-flow-ODE kernel sampler; with ``--sampler
ddim|dpm|hybrid`` under a corrector-free config the few-step one) and writes them,
denormalized to axis-angle, to ``<output-path>/generation/samples.npz``
(``pose_samples``).
``--metrics`` runs the 500-sample protocol (EM + langevin corrector, eps
5e-3) through the SMPL body and prints the APD (ref run/demo.py:338-405).

The completion tasks read up to 50 axis-angle poses (``pose_samples``) from
``--file-path``, mask ``--part`` and complete it ``--hypo`` times:
``completion`` by test-time optimisation (DPoserComp, time strategy '2'
at ``min(900, N-1)``, the whole Adam loop on the CUDA kernels);
``completion2`` by masked imputation inside the reverse sampler, with
``--sampler pc`` (the N-step sampler), ``ddim`` / ``dpm`` (few-step) or
``hybrid`` (a DDIM head and the pc sampler's last ``--hybrid-tail`` rows).
Both print the min-over-hypotheses MPVPE and MPJPE through the SMPL-X body
(ref run/demo.py:453-611) and write the hypotheses to
``<output-path>/completion/hypotheses.npz`` (``pose_hypotheses`` [B, H, 63],
axis-angle, with ``mask`` and ``gts``).

Interpolation (ref run/demo.py:624-732) takes poses 1, 10, 11, 12, 17 and 14
of ``--file-path`` as anchors, encodes them to latents with the fp32 tabled
RK4 likelihood (250 steps, eps 1e-4: the encode's output is z itself, so it
stays in fp32 rather than on the bf16 likelihood kernels), decodes with the
deterministic PF-Euler sampler on the CUDA kernels at eps 1e-5, prints the
anchors' reconstruction error, and decodes 60 slerp frames between each pair
of neighbours into ``<output-path>/interpolation/frames.npz`` (``pose_frames``
[5, 60, 63], axis-angle, with ``anchors`` and ``recon``). ``--adaptive-ode``
encodes with the adaptive RK45 likelihood and decodes with the generic PC loop
instead.

``--quant int8`` serves the pc sampler (generation, ``--metrics``, completion2
with ``--sampler pc``, ``ddim`` or ``hybrid``) in the W8A8 mode: int8 hidden
matmuls through kernel K13, the activation ranges calibrated once per (eps,
corrector, scheme) on a 256-pose fp32 trajectory drawn with seed + 999, per
tensor or, with ``--quant-scheme channel``, per channel (SmoothQuant-style
fold). ``--quant int8-mixed`` runs the last ``--quant-bf16-tail`` steps on the
bf16 kernels (a tenth of the rows, at least one, for DDIM; none for the
hybrid, as in the JAX demo). The ODE paths and the completion solver stay
unquantized.

Rendering, ``--video``, the self-intersection metric and the other tasks are
not ported yet. On ``--device cuda`` every route goes through the kernels,
DPM-Solver++ excepted (it has no kernel in either package); on ``--device
cpu`` the kernels' plain versions run, with host-drawn normals.
"""
from __future__ import annotations

import argparse
import copy
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import N_POSES
from .body_model import BodyModel
from .config import load_config
from .data import PoseNormalizer
from .body_model.part_indices import BodyPartIndices
from .diffusion import few_step
from .diffusion.likelihood import get_fast_likelihood_fn, get_likelihood_fn
from .diffusion.sampling import get_sampling_fn
from .diffusion.score_fn import get_score_fn
from .diffusion.sde import build_sde, sampling_eps_for
from .models import create_score_model
from .ops.cuda.fused_em import get_cuda_em_hypo_sampler, get_cuda_em_sampler
from .ops.cuda.fused_ode import get_cuda_ode_sampler
from .ops.cuda.quant import calibrate_act_amax, calibrate_act_amax_per_channel
from .ops.metrics import Evaler, average_pairwise_distance
from .ops.smoothing import slerp_interpolation
from .tasks import DPoserComp
from .utils.checkpoint import load_params_for_inference
from .utils.masks import create_mask

SAMPLE_NUM = 50
METRICS_SAMPLE_NUM = 500
METRICS_EPS = 5e-3
ODE_STEPS = 125
ANCHOR_IDX = (1, 10, 11, 12, 17, 14)
INTER_FRAMES = 60
ENCODE_STEPS, ENCODE_EPS, DECODE_EPS = 250, 1e-4, 1e-5
CALIB_BATCH, CALIB_SEED_OFFSET = 256, 999


def parse_args(argv):
    p = argparse.ArgumentParser(description="DPoser generation and completion "
                                            "on the GPU")
    p.add_argument("--task", default="generation",
                   choices=["generation", "completion", "completion2", "interpolation"])
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
    p.add_argument("--bodymodel-path", default="../body_models/smplx/SMPLX_NEUTRAL.npz",
                   help="SMPL-X model file (for the completion tasks)")
    p.add_argument("--file-path", default="./examples/toy_data.npz",
                   help="npz with pose_samples [n, 63] axis-angle (completion and "
                        "interpolation tasks)")
    p.add_argument("--adaptive-ode", action="store_true",
                   help="interpolation: the adaptive RK45 encode and the generic PF "
                        "decode instead of the fixed-grid fast paths")
    p.add_argument("--metrics", action="store_true")
    p.add_argument("--hypo", type=int, default=10)
    p.add_argument("--part", default="left_leg", choices=BodyPartIndices.PARTS)
    p.add_argument("--sampler", default="pc", choices=["pc", "ddim", "dpm", "hybrid"],
                   help="completion2, and generation under a corrector-free config: the "
                        "N-step pc sampler, few-step DDIM or DPM-Solver++(2M), or the "
                        "hybrid of a DDIM head and the pc sampler's exact last "
                        "--hybrid-tail rows")
    p.add_argument("--sampler-steps", type=int, default=None,
                   help="steps for --sampler ddim/dpm/hybrid (default: 50 ddim, "
                        "20 dpm, 25 hybrid head)")
    p.add_argument("--hybrid-tail", type=int, default=100,
                   help="how many last rows of the N-step schedule run as the "
                        "hybrid's stochastic pc tail")
    p.add_argument("--hybrid-tail-corrector", default="langevin",
                   choices=["langevin", "none"], help="corrector on the hybrid's tail")
    p.add_argument("--quant", default="none", choices=["none", "int8", "int8-mixed"],
                   help="opt-in W8A8 serving mode of the pc sampler paths (generation, "
                        "--metrics, completion2): int8 hidden matmuls with activation "
                        "ranges calibrated on a sampling trajectory; 'int8-mixed' runs the "
                        "last --quant-bf16-tail steps on the bf16 kernels")
    p.add_argument("--quant-bf16-tail", type=int, default=100,
                   help="K for --quant int8-mixed: the final steps run in bf16")
    p.add_argument("--quant-scheme", default="tensor", choices=["tensor", "channel"],
                   help="activation quantization of the int8 modes: static per-tensor "
                        "ranges, or per-channel ranges folded into the int8 weights "
                        "(SmoothQuant-style); per-tensor degrades completion")
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


def make_quant_kwargs(args, config, sde, model, device):
    """``quant_kwargs(eps, corrector) -> dict``: the sampler kwargs of the
    ``--quant`` mode (empty under ``none``). The activation ranges are
    calibrated once per (eps, corrector, scheme) on a ``CALIB_BATCH``-pose
    trajectory drawn with seed + 999 (ref run/demo.py:177-212), and cached."""
    cache = {}

    def quant_kwargs(eps: float, corrector: str) -> dict:
        if args.quant == "none":
            return {}
        corr = corrector if corrector == "langevin" else "none"
        key = (float(eps), corr, args.quant_scheme)
        if key not in cache:
            calibrate = (calibrate_act_amax_per_channel if args.quant_scheme == "channel"
                         else calibrate_act_amax)
            amax = calibrate(sde, model, (CALIB_BATCH, model.n_poses * model.pose_dim),
                             torch.Generator(device=device).manual_seed(
                                 args.seed + CALIB_SEED_OFFSET),
                             eps=float(eps), corrector=corr, snr=config.sampling.snr,
                             n_corrector_steps=config.sampling.n_steps_each, device=device)
            summary = np.round([float(np.max(a)) for a in amax]
                               if args.quant_scheme == "channel" else amax, 3)
            print(f"[quant] int8 ranges calibrated (eps={eps}, corrector={corr}, "
                  f"scheme={args.quant_scheme}): {summary}")
            cache[key] = amax
        kw = dict(quant="int8", act_amax=cache[key])
        if args.quant == "int8-mixed":
            kw["bf16_tail_steps"] = args.quant_bf16_tail
        return kw

    return quant_kwargs


def build_sampler(config, sde, model, batch: int, eps: float, corrector: str, device,
                  probability_flow: bool = False, quant_kw=None, loop=None):
    """The config's PC sampler through the CUDA kernels: Philox normals drawn
    in the kernels on the card (the whole loop replayed as one CUDA graph
    unless ``loop="eager"``), host normals with the plain versions on the
    CPU. ``quant_kw`` (from ``make_quant_kwargs``) selects the int8 mode."""
    device = torch.device(device)
    return get_cuda_em_sampler(
        sde, model, (batch, model.n_poses * model.pose_dim), eps=eps,
        denoise=config.sampling.noise_removal,
        rng_mode="kernel" if device.type == "cuda" else "host",
        corrector=corrector, snr=config.sampling.snr,
        n_corrector_steps=config.sampling.n_steps_each,
        predictor=config.sampling.predictor, probability_flow=probability_flow,
        device=device, loop=loop, **(quant_kw or {}))


def build_generation_sampler(config, sde, model, batch: int, eps: float, device,
                             quant_kw=None, args=None):
    """``sampler(generator) -> x`` for the generation task: with ``args.sampler``
    other than pc under a corrector-free config the few-step sampler (ref
    run/demo.py:225-281); else the config's PC sampler, or under
    ``sampling.method = "ode"`` the RK4 PF-ODE kernel sampler (ref
    run/demo.py:284-299), which stays unquantized. ``quant_kw`` (from
    ``make_quant_kwargs``) selects the int8 mode of the kernel routes."""
    quant_kw = quant_kw or {}
    if args is not None and args.sampler != "pc" and config.sampling.corrector == "none":
        return few_step_generation_sampler(args, config, sde, model, batch, eps, device,
                                           quant_kw)
    method = config.sampling.method.lower()
    if method == "ode":
        s = get_cuda_ode_sampler(sde, model, (batch, model.n_poses * model.pose_dim),
                                 n_steps=ODE_STEPS, eps=eps,
                                 denoise=config.sampling.noise_removal, device=device)
        print("[sampler] kernel RK4 PF-ODE path")
        return lambda generator: s(generator)[1]
    if method != "pc":
        raise ValueError(f"Sampler name {config.sampling.method} unknown.")
    return build_sampler(config, sde, model, batch, eps, config.sampling.corrector, device,
                         quant_kw=quant_kw)


def few_step_quant_kw(quant_kw: dict, sampler: str, n_fs: int) -> dict:
    """The ``--quant`` kwargs of a few-step kernel route: the N-step bf16 tail
    does not fit a few-step table, so DDIM keeps a tenth of its rows (at least
    one) and the hybrid drops it, as the JAX demo does (run/demo.py:244,
    :260-264)."""
    kw = dict(quant_kw)
    if "bf16_tail_steps" in kw:
        if sampler == "ddim":
            kw["bf16_tail_steps"] = max(1, min(kw["bf16_tail_steps"], n_fs // 10))
        else:
            del kw["bf16_tail_steps"]
    return kw


def few_step_generation_sampler(args, config, sde, model, batch: int, eps: float, device,
                                quant_kw):
    """Generation with ``--sampler ddim|dpm|hybrid``: DDIM and the hybrid on
    the kernels (int8 under ``quant_kw``), DPM-Solver++(2M) in fp32."""
    device = torch.device(device)
    shape = (batch, model.n_poses * model.pose_dim)
    n_fs = args.sampler_steps or {"ddim": 50, "dpm": 20, "hybrid": 25}[args.sampler]
    dn = config.sampling.noise_removal
    kernel_kw = dict(rng_mode="kernel" if device.type == "cuda" else "host", device=device)
    qtag = "" if not quant_kw else ", " + args.quant
    kwq = few_step_quant_kw(quant_kw, args.sampler, n_fs)
    if args.sampler == "hybrid":
        lgv = "-lgv" if args.hybrid_tail_corrector == "langevin" else ""
        s = few_step.get_cuda_hybrid_sampler(
            sde, model, shape, n_head=n_fs, m_tail=args.hybrid_tail, eps=eps,
            tail_corrector=args.hybrid_tail_corrector, snr=config.sampling.snr,
            n_corrector_steps=config.sampling.n_steps_each, **kernel_kw, **kwq)
        print(f"[sampler] kernel hybrid DDIM-{n_fs} + pc-tail-{args.hybrid_tail}{lgv}{qtag}")
    elif args.sampler == "ddim":
        s = few_step.get_cuda_ddim_sampler(sde, model, shape, n_steps=n_fs, eps=eps,
                                           denoise=dn, **kernel_kw, **kwq)
        print(f"[sampler] kernel DDIM, {n_fs} steps{qtag}")
    else:
        s = few_step.get_dpm_sampler(sde, model, shape, n_steps=n_fs, eps=eps, denoise=dn,
                                     device=device)
        print(f"[sampler] tabled DPM-Solver++(2M), {n_fs} steps")
    return lambda generator: s(generator)[1]


def complete_by_optimisation(sde, model, observation, mask, hypo_num, generator, device):
    """``--task completion``: DPoserComp with the demo's time strategy '2'
    (ref run/demo.py:306), the whole Adam loop on the kernels. The reference's
    fixed time 900 assumes N = 1000; a reduced N takes its last grid index."""
    comp = DPoserComp(sde, model=model, time_strategy="2",
                      sample_time=min(900, sde.N - 1), backend="cuda", device=device)
    print("[completion] kernel Adam-loop solver")
    return comp.optimize_hypos(observation, mask, hypo_num, generator)


def complete_by_imputation(args, config, sde, model, observation, mask, generator, device,
                           quant_kwargs):
    """``--task completion2``: masked imputation in the reverse sampler, the
    hypotheses tiled into rows -> [B, H, D] (ref run/demo.py:492-606). Under
    ``--quant`` the pc, DDIM and hybrid routes run int8, calibrated on the
    config's corrector (the hybrid's tail corrector is not consulted, as in
    the JAX demo)."""
    device = torch.device(device)
    hypo_num, shape, eps = args.hypo, tuple(observation.shape), sampling_eps_for(sde)
    dn = config.sampling.noise_removal
    kernel_kw = dict(rng_mode="kernel" if device.type == "cuda" else "host", device=device)
    qtag = "" if args.quant == "none" else ", " + args.quant
    if args.sampler == "pc":
        if config.sampling.method != "pc":
            raise NotImplementedError(f"masked imputation runs in the pc sampler; the "
                                      f"config's sampling method is "
                                      f"{config.sampling.method!r}")
        s = get_cuda_em_hypo_sampler(sde, model, shape, hypo_num, eps=eps, denoise=dn,
                                     corrector=config.sampling.corrector,
                                     snr=config.sampling.snr,
                                     n_corrector_steps=config.sampling.n_steps_each,
                                     predictor=config.sampling.predictor, **kernel_kw,
                                     **quant_kwargs(eps, config.sampling.corrector))
        print(f"[sampler] kernel multi-hypothesis imputation{qtag}")
        return s(generator, observation, mask)
    n_fs = args.sampler_steps or {"ddim": 50, "dpm": 20, "hybrid": 25}[args.sampler]
    if args.sampler in ("ddim", "hybrid"):
        kwq = few_step_quant_kw(quant_kwargs(eps, config.sampling.corrector), args.sampler,
                                n_fs)
    if args.sampler == "hybrid":
        lgv = "-lgv" if args.hybrid_tail_corrector == "langevin" else ""
        s = few_step.get_cuda_hybrid_hypo_sampler(
            sde, model, shape, hypo_num, n_head=n_fs, m_tail=args.hybrid_tail, eps=eps,
            tail_corrector=args.hybrid_tail_corrector, snr=config.sampling.snr,
            n_corrector_steps=config.sampling.n_steps_each, **kernel_kw, **kwq)
        label = (f"kernel hybrid DDIM-{n_fs} + pc-tail-{args.hybrid_tail}{lgv} imputation"
                 f"{qtag}")
    elif args.sampler == "ddim":
        s = few_step.get_cuda_ddim_hypo_sampler(sde, model, shape, hypo_num, n_steps=n_fs,
                                                eps=eps, denoise=dn, **kernel_kw, **kwq)
        label = f"kernel DDIM imputation, {n_fs} steps{qtag}"
    else:
        s = few_step.get_dpm_hypo_sampler(sde, model, shape, hypo_num, n_steps=n_fs,
                                          eps=eps, denoise=dn, device=device)
        label = f"tabled DPM-Solver++(2M) imputation, {n_fs} steps"
    nfe, multihypo = s(generator, observation, mask)
    print(f"[sampler] {label} x {hypo_num} hypos (NFE {nfe})")
    return multihypo


def run_completion(args, config, sde, model, normalizer, generator, device,
                   quant_kwargs) -> dict:
    """The completion tasks. Returns ``hypotheses_file``, ``mpvpe`` and ``mpjpe``."""
    with np.load(args.file_path, allow_pickle=False) as f:
        gts = torch.as_tensor(f["pose_samples"][:SAMPLE_NUM], dtype=torch.float32,
                              device=device)
    print(f"loaded axis pose data {tuple(gts.shape)} from {args.file_path}")
    normed = normalizer.offline_normalize(gts, from_axis=True)
    mask, observation = create_mask(normed, part=args.part, generator=generator)
    if args.task == "completion":
        multihypo = complete_by_optimisation(sde, model, observation, mask, args.hypo,
                                             generator, device)
    else:
        multihypo = complete_by_imputation(args, config, sde, model, observation, mask,
                                           generator, device, quant_kwargs)
    preds = normalizer.offline_denormalize(multihypo, to_axis=True)
    body = BodyModel(args.bodymodel_path, num_betas=10, model_type="smplx", device=device)
    evaler = Evaler(body_model=body, part=args.part)
    res = evaler.multi_eval_bodys(preds, gts)
    evaler.print_multi_eval_result(res, args.hypo)
    target = os.path.join(args.output_path, "completion")
    os.makedirs(target, exist_ok=True)
    out = dict(hypotheses_file=os.path.join(target, "hypotheses.npz"),
               mpvpe=float(np.mean(res["mpvpe_all"])),
               mpjpe=float(np.mean(res["mpjpe_body"])))
    np.savez(out["hypotheses_file"], pose_hypotheses=preds.cpu().numpy(),
             mask=mask.cpu().numpy(), gts=gts.cpu().numpy())
    print(f"hypotheses saved to {out['hypotheses_file']}")
    return out


def run_interpolation(args, config, sde, model, normalizer, generator, device) -> dict:
    """The interpolation task. Returns ``frames_file`` and ``recon_err``."""
    with np.load(args.file_path, allow_pickle=False) as f:
        poses = f["pose_samples"]
    if poses.shape[0] <= max(ANCHOR_IDX):
        raise SystemExit(f"--file-path holds {poses.shape[0]} poses; the interpolation "
                         f"anchors are poses {list(ANCHOR_IDX)}")
    anchors = torch.as_tensor(poses[list(ANCHOR_IDX)], dtype=torch.float32, device=device)
    anchor_normed = normalizer.offline_normalize(anchors, from_axis=True)
    dim = anchor_normed.shape[1]
    if args.adaptive_ode:
        score_fn = get_score_fn(sde, model, continuous=config.training.continuous)
        likelihood_fn = get_likelihood_fn(sde, score_fn, rtol=1e-4, atol=1e-4,
                                          eps=ENCODE_EPS)
        print("[ode] adaptive RK45 encode")
    else:
        likelihood_fn = get_fast_likelihood_fn(sde, model, n_steps=ENCODE_STEPS,
                                               eps=ENCODE_EPS)
        print("[ode] tabled fixed-grid RK4 encode")
    _, anchor_z, _ = likelihood_fn(generator, anchor_normed)

    def build_decoder(batch):
        """The deterministic PF-Euler decode (pc + probability_flow, ref
        demo.py:439-447): the kernel sampler, or the generic loop."""
        if not args.adaptive_ode:
            return build_sampler(config, sde, model, batch, DECODE_EPS, "none", device,
                                 probability_flow=True)
        sampling = copy.copy(config.sampling)
        sampling.method, sampling.predictor = "pc", "euler_maruyama"
        sampling.corrector, sampling.probability_flow = "none", True
        return get_sampling_fn(SimpleNamespace(sampling=sampling), sde, (batch, dim),
                               score_fn, DECODE_EPS, device=device)

    print("[ode] generic PF-Euler decode" if args.adaptive_ode else
          "[ode] kernel PF-Euler decode")
    recon = build_decoder(len(ANCHOR_IDX))(generator, z=anchor_z)
    recon_err = float((recon - anchor_normed).abs().mean())
    print(f"reconstruction mean abs err (normalized space): {recon_err:.4f}")

    decoder = build_decoder(INTER_FRAMES)
    frames = []
    for idx in range(len(ANCHOR_IDX) - 1):
        latents = slerp_interpolation(anchor_z[idx], anchor_z[idx + 1], INTER_FRAMES)
        frames.append(normalizer.offline_denormalize(decoder(generator, z=latents),
                                                     to_axis=True))
    target = os.path.join(args.output_path, "interpolation")
    os.makedirs(target, exist_ok=True)
    out = dict(frames_file=os.path.join(target, "frames.npz"), recon_err=recon_err)
    np.savez(out["frames_file"], pose_frames=torch.stack(frames).cpu().numpy(),
             anchors=anchors.cpu().numpy(),
             recon=normalizer.offline_denormalize(recon, to_axis=True).cpu().numpy())
    print(f"Interpolation outputs under {target}")
    return out


def run(args) -> dict:
    """The task. Generation returns ``samples_file``, ``step`` and, with
    ``--metrics``, ``apd`` and ``metrics_wall_s``; the completion tasks
    ``hypotheses_file``, ``mpvpe``, ``mpjpe`` and ``step``; interpolation
    ``frames_file``, ``recon_err`` and ``step``."""
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
    quant_kwargs = make_quant_kwargs(args, config, sde, model, device)
    if args.task in ("completion", "completion2"):
        return dict(run_completion(args, config, sde, model, normalizer, generator, device,
                                   quant_kwargs), step=step)
    if args.task == "interpolation":
        return dict(run_interpolation(args, config, sde, model, normalizer, generator,
                                      device), step=step)

    eps = sampling_eps_for(sde)
    few = args.sampler != "pc" and config.sampling.corrector == "none"
    sampler = build_generation_sampler(
        config, sde, model, SAMPLE_NUM, eps, device,
        quant_kw=(quant_kwargs(eps, config.sampling.corrector)
                  if few or config.sampling.method.lower() == "pc" else None), args=args)
    samples = normalizer.offline_denormalize(sampler(generator), to_axis=True)
    target = os.path.join(args.output_path, "generation")
    os.makedirs(target, exist_ok=True)
    out = dict(samples_file=os.path.join(target, "samples.npz"), step=step)
    np.savez(out["samples_file"], pose_samples=samples.cpu().numpy())
    print(f"samples saved to {out['samples_file']}")

    if args.metrics:
        t0 = time.perf_counter()
        sampler = build_sampler(config, sde, model, METRICS_SAMPLE_NUM, METRICS_EPS,
                                "langevin", device,
                                quant_kw=quant_kwargs(METRICS_EPS, "langevin"))
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
