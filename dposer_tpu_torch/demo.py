"""Generation, pose-completion, interpolation and render demo on the card
(port of ``run/demo.py``).

    python -m dposer_tpu_torch.demo --task generation \\
        --ckpt-path artifacts/trained_r5/axis-zscore-400k-synth.pth \\
        --stats-dir artifacts/trained_r5/stats --output-path output/torch \\
        [--metrics --smpl-path SMPL_NEUTRAL.npz] [--device cpu]
    python -m dposer_tpu_torch.demo --task completion2 --sampler hybrid \\
        --file-path poses.npz --bodymodel-path SMPLX_NEUTRAL.npz --part left_leg ...
    python -m dposer_tpu_torch.demo --task interpolation --file-path poses.npz ...
    python -m dposer_tpu_torch.demo --task view --file-path poses.npz \\
        --bodymodel-path SMPLX_NEUTRAL.npz [--view front|back|left|right|top|bottom]
    python -m dposer_tpu_torch.demo --task generation_process --bodymodel-path ...

Generation samples 50 poses with the config's sampler (sub-VP EM, no
corrector, through the CUDA kernels; with ``sampling.method = "ode"`` the
125-step RK4 probability-flow-ODE kernel sampler; with ``--sampler
ddim|dpm|hybrid`` under a corrector-free config the few-step one) and writes them,
denormalized to axis-angle, to ``<output-path>/generation/samples.npz``
(``pose_samples``), and renders each through the SMPL-X body
(``--bodymodel-path``) to ``generated_sample{i}.png``.
``--metrics`` runs the 500-sample protocol (EM + langevin corrector, eps
5e-3) through the SMPL body and prints the APD and the self-intersection
percentage (SI, host C++ built with ``g++``; ref run/demo.py:338-406).
``--metrics-chunks C`` (C divides 500) samples the protocol in C chunks of
one graph each, enqueued back to back, and runs each chunk's SI on a worker
thread while the later chunks are still on the device; 1, the default, is
the reference's single batch.

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

``view`` renders the first 50 poses of ``--file-path`` as they are
(``view/GT_sample{i}.png``). ``generation_process`` samples 3 poses with the
config's pc sampler, records the state after steps 9, 19, ... of the N-step
grid (100 frames at N = 1000) and renders each pose's frames to a 30 fps
video ``generation_process/generation_process{i}.mp4`` (ref
run/demo.py:408-437). Completion renders the masked poses and each
hypothesis (``sample{i}_masked.png``, ``sample{i}_completion{h}.png``), and
interpolation each pair's 60 frames (``inter_{pair}_{i}.png``, or with
``--video`` one 60 fps ``interpolation_video.mp4``). Renders run the native
rasterizer (``body_model/visual.py``, host C++ built with ``g++``) in the
``--view`` preset and write with ``cv2``. As in the JAX demo, generation,
completion and interpolation print ``[skip renders]`` and go on when the
body model file is missing; ``view`` and ``generation_process`` raise
instead. Each task's result holds ``render_s``, the seconds it spent
rendering. ``--faster``
is accepted and not read, as in the JAX demo.

On ``--device cuda`` every route goes through the kernels, DPM-Solver++
excepted (it has no kernel in either package); on ``--device cpu`` the
kernels' plain versions run, with host-drawn normals. A config outside the
kernels' scope (a predictor other than Euler-Maruyama or reverse diffusion,
a corrector other than none or langevin, a Fourier time embedding, or the
TimeMLPs model) samples generation, the metrics protocol,
``generation_process`` and completion2's pc route on the plain PC loop
(``diffusion/sampling.py``) on the same device, as the JAX demo takes its
XLA sampler there; the demo prints the route it takes.

The demo builds one device mesh (``parallel.make_mesh``: the process's
visible CUDA devices, or the CPU), as ``run/demo.py`` does. With more than
one device it shards where the JAX demo does: the generation and metrics
sampler (its rows padded to a multiple of the mesh's size with extra draws,
and trimmed), and the completion solver and completion2's pc, DDIM and
hybrid hypothesis samplers when their hypothesis rows divide the mesh (on
one device otherwise). The few-step generation samplers, the ODE sampler
and DPM-Solver++ run on one device, as in the JAX demo. With one device
every route is the single-device one.
"""
from __future__ import annotations

import argparse
import copy
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from . import N_POSES
from .body_model import BodyModel
from .body_model.visual import body_meshes, multiple_render, render_mesh, write_video
from .config import load_config
from .data import PoseNormalizer
from .body_model.part_indices import BodyPartIndices
from .diffusion import few_step
from .diffusion.fast_sampler import get_fast_ode_sampler
from .diffusion.likelihood import get_fast_likelihood_fn, get_likelihood_fn
from .diffusion.sampling import get_sampling_fn
from .diffusion.score_fn import get_score_fn
from .diffusion.sde import build_sde, sampling_eps_for
from .models import create_score_model
from .ops.cuda.fused_em import (get_cuda_em_hypo_sampler, get_cuda_em_sampler,
                                   in_kernel_scope, narrow_head_scope)
from .ops.cuda.fused_ode import get_cuda_ode_sampler
from .ops.cuda.quant import calibrate_act_amax, calibrate_act_amax_per_channel
from .ops.metrics import Evaler, average_pairwise_distance, self_intersections_percentage
from .ops.smoothing import slerp_interpolation
from .parallel import make_mesh, mesh_route
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
BG_IMG_SHAPE = (512, 384, 3)
FOCAL, PRINCPT = (1500, 1500), (200, 192)
VIDEO_NUM, VIDEO_FPS, INTER_VIDEO_FPS = 3, 30, 60


def parse_args(argv):
    p = argparse.ArgumentParser(description="DPoser generation and completion "
                                            "on the GPU")
    p.add_argument("--task", default="view",
                   choices=["view", "generation", "generation_process", "interpolation",
                            "completion", "completion2"])
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
    p.add_argument("--metrics-chunks", type=int, default=1,
                   help="--metrics: sample the 500 poses in this many chunks (it must "
                        "divide 500) and run each chunk's self-intersection test on a "
                        "worker thread while the later chunks sample; 1 is the "
                        "reference's single batch")
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
    p.add_argument("--view", default="front",
                   help="the render's view preset: front, back, left, right, top or bottom")
    p.add_argument("--faster", action="store_true", help="accepted and not read, as in JAX")
    p.add_argument("--video", action="store_true",
                   help="interpolation: one video of all frames instead of a PNG a frame")
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


def mesh_rows(mesh, rows: int) -> int:
    """``rows`` padded up to a multiple of the mesh's size (no mesh: as is)."""
    return rows if mesh is None else -(-rows // mesh.size) * mesh.size


def mesh_if_divides(mesh, rows: int):
    """``mesh`` when ``rows`` divide into its shards, else None (one device),
    as the JAX demo chooses for its solver and hypothesis samplers."""
    return mesh if mesh is not None and rows % mesh.size == 0 else None


def kernel_scope(config, model, corrector=None) -> bool:
    """Whether the kernel sampler runs the config's sampler (the JAX demo's
    ``pallas_eligible``): the pc method, in ``in_kernel_scope``."""
    return (config.sampling.method.lower() == "pc"
            and in_kernel_scope(config.sampling, model, corrector))


def plain_pc_sampler(config, sde, model, batch: int, eps: float, device, corrector=None,
                     **overrides):
    """The config's pc sampler on the plain loop (``diffusion/sampling.py``)
    on ``device``, ``corrector`` in place of the config's; ``overrides`` go
    to ``get_pc_sampler`` (``return_trajectory``, ``imputation``)."""
    sampling = copy.copy(config.sampling)
    sampling.method = "pc"
    if corrector is not None:
        sampling.corrector = corrector
    score_fn = get_score_fn(sde, model, continuous=config.training.continuous)
    print(f"[sampler] plain PC loop (predictor={sampling.predictor}, "
          f"corrector={sampling.corrector}): outside the kernels' scope")
    return get_sampling_fn(SimpleNamespace(sampling=sampling), sde,
                           (batch, model.n_poses * model.pose_dim), score_fn, eps,
                           device=device, **overrides)


def build_sampler(config, sde, model, batch: int, eps: float, corrector: str, device,
                  probability_flow: bool = False, quant_kw=None, loop=None, mesh=None,
                  trajectory_steps=None):
    """The config's PC sampler through the CUDA kernels: Philox normals drawn
    in the kernels on the card (the whole loop replayed as one CUDA graph
    unless ``loop="eager"``), host normals with the plain versions on the
    CPU. ``quant_kw`` (from ``make_quant_kwargs``) selects the int8 mode;
    ``mesh`` (more than one device; ``batch`` must divide it) shards it;
    ``trajectory_steps`` makes it return ``(trajs, x)``."""
    device = torch.device(device)
    return get_cuda_em_sampler(
        sde, model, (batch, model.n_poses * model.pose_dim), eps=eps,
        denoise=config.sampling.noise_removal,
        rng_mode="kernel" if device.type == "cuda" else "host",
        corrector=corrector, snr=config.sampling.snr,
        n_corrector_steps=config.sampling.n_steps_each,
        predictor=config.sampling.predictor, probability_flow=probability_flow,
        device=device, loop=loop, mesh=mesh, trajectory_steps=trajectory_steps,
        **(quant_kw or {}))


def build_generation_sampler(config, sde, model, batch: int, eps: float, device,
                             quant_kw=None, args=None, mesh=None):
    """``sampler(generator) -> x`` for the generation task: with ``args.sampler``
    other than pc under a corrector-free config the few-step sampler (ref
    run/demo.py:225-281); else the config's PC sampler, or under
    ``sampling.method = "ode"`` the RK4 PF-ODE kernel sampler (ref
    run/demo.py:284-299), which stays unquantized. ``quant_kw`` (from
    ``make_quant_kwargs``) selects the int8 mode of the kernel routes.
    ``mesh`` (more than one device) shards the PC sampler, as the JAX demo
    shards its kernel sampler; the few-step and ODE samplers run on one
    device."""
    quant_kw = quant_kw or {}
    if args is not None and args.sampler != "pc" and config.sampling.corrector == "none":
        return few_step_generation_sampler(args, config, sde, model, batch, eps, device,
                                           quant_kw)
    method = config.sampling.method.lower()
    if method == "ode":
        shape = (batch, model.n_poses * model.pose_dim)
        kw = dict(n_steps=ODE_STEPS, eps=eps, denoise=config.sampling.noise_removal,
                  device=device)
        if narrow_head_scope(model, "ode"):
            s = get_cuda_ode_sampler(sde, model, shape, **kw)
            print("[sampler] kernel RK4 PF-ODE path")
        else:
            s = get_fast_ode_sampler(sde, model, shape, **kw)
            print(f"[sampler] fp32 tabled RK4 PF-ODE loop: a pose of {shape[1]} dims is "
                  f"outside the kernels' scope")
        return lambda generator: s(generator)[1]
    if method != "pc":
        raise ValueError(f"Sampler name {config.sampling.method} unknown.")
    if not kernel_scope(config, model):
        return plain_pc_sampler(config, sde, model, batch, eps, device)
    if mesh is None:
        print(f"[sampler] kernel sampler (corrector={config.sampling.corrector})")
        return build_sampler(config, sde, model, batch, eps, config.sampling.corrector,
                             device, quant_kw=quant_kw)
    s = build_sampler(config, sde, model, mesh_rows(mesh, batch), eps,
                      config.sampling.corrector, device, quant_kw=quant_kw, mesh=mesh)
    print(f"[sampler] kernel sampler over {mesh.size} shards")
    return lambda generator: s(generator)[:batch]


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


def complete_by_optimisation(sde, model, observation, mask, hypo_num, generator, device,
                             mesh=None):
    """``--task completion``: DPoserComp with the demo's time strategy '2'
    (ref run/demo.py:306), the whole Adam loop on the kernels. The reference's
    fixed time 900 assumes N = 1000; a reduced N takes its last grid index.
    ``mesh`` (more than one device; the hypothesis rows divide it) shards
    the hypothesis rows. A pose the kernel solver does not take (rot6d's 126
    dims: ``narrow_head_scope``) asks for the autograd solver, on one
    device, and says so."""
    if narrow_head_scope(model, "solver"):
        backend = "cuda"
        print("[completion] kernel Adam-loop solver"
              + ("" if mesh is None else f" over {mesh.size} shards"))
    else:
        backend, mesh = "torch", None
        print(f"[completion] autograd solver: a pose of {model.n_poses * model.pose_dim} dims "
              f"is outside the kernel solver's scope")
    comp = DPoserComp(sde, model=model, time_strategy="2", sample_time=min(900, sde.N - 1),
                      backend=backend, device=device, mesh=mesh)
    return comp.optimize_hypos(observation, mask, hypo_num, generator)


def complete_by_imputation(args, config, sde, model, observation, mask, generator, device,
                           quant_kwargs, mesh=None):
    """``--task completion2``: masked imputation in the reverse sampler, the
    hypotheses tiled into rows -> [B, H, D] (ref run/demo.py:492-606). Under
    ``--quant`` the pc, DDIM and hybrid routes run int8, calibrated on the
    config's corrector (the hybrid's tail corrector is not consulted, as in
    the JAX demo). ``mesh`` (more than one device; the hypothesis rows
    divide it) shards the tiled rows of the kernel routes; DPM-Solver++ runs
    on one device."""
    device = torch.device(device)
    hypo_num, shape, eps = args.hypo, tuple(observation.shape), sampling_eps_for(sde)
    dn = config.sampling.noise_removal
    kernel_kw = dict(rng_mode="kernel" if device.type == "cuda" else "host", device=device,
                     mesh=mesh)
    qtag = "" if args.quant == "none" else ", " + args.quant
    qtag += "" if mesh is None else f", over {mesh.size} shards"
    if args.sampler == "pc":
        if config.sampling.method != "pc":
            raise NotImplementedError(f"masked imputation runs in the pc sampler; the "
                                      f"config's sampling method is "
                                      f"{config.sampling.method!r}")
        if not kernel_scope(config, model):
            s = plain_pc_sampler(config, sde, model, shape[0], eps, device, imputation=True)
            return torch.stack([s(generator, observation=observation, mask=mask)
                                for _ in range(hypo_num)], dim=1)
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
                   quant_kwargs, mesh=None) -> dict:
    """The completion tasks. Returns ``hypotheses_file``, ``mpvpe``, ``mpjpe``
    and ``render_s``."""
    gts = load_poses(args, device)
    normed = normalizer.offline_normalize(gts, from_axis=True)
    mask, observation = create_mask(normed, part=args.part, generator=generator)
    mesh = mesh_if_divides(mesh, args.hypo * observation.shape[0])
    if args.task == "completion":
        multihypo = complete_by_optimisation(sde, model, observation, mask, args.hypo,
                                             generator, device, mesh)
    else:
        multihypo = complete_by_imputation(args, config, sde, model, observation, mask,
                                           generator, device, quant_kwargs, mesh)
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
    t0 = time.perf_counter()
    try:
        multiple_render(observation, normalizer, body, target, "sample{}_masked.png",
                        **render_kwargs(args))
        for h in range(args.hypo):
            multiple_render(multihypo[:, h], normalizer, body, target,
                            "sample{}_completion" + str(h) + ".png", **render_kwargs(args))
        print(f"Completion samples under {target}")
    except FileNotFoundError as e:
        print(f"[skip renders] {e}")
    out["render_s"] = time.perf_counter() - t0
    return out


def run_interpolation(args, config, sde, model, normalizer, generator, device) -> dict:
    """The interpolation task. Returns ``frames_file``, ``recon_err`` and
    ``render_s``."""
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
    target = os.path.join(args.output_path, "interpolation")
    os.makedirs(target, exist_ok=True)
    frames, renders, body, render_s = [], [], None, 0.0
    render = True  # until a render is skipped; the decode goes on (frames.npz)
    for idx in range(len(ANCHOR_IDX) - 1):
        latents = slerp_interpolation(anchor_z[idx], anchor_z[idx + 1], INTER_FRAMES)
        samples = decoder(generator, z=latents)
        frames.append(normalizer.offline_denormalize(samples, to_axis=True))
        if not render:
            continue
        t0 = time.perf_counter()
        try:
            if body is None:
                body = BodyModel(args.bodymodel_path, num_betas=10, model_type="smplx",
                                 device=device)
            if args.video:  # one video of every frame (ref demo.py:474-500)
                meshes, faces = body_meshes(samples, normalizer, body)
                renders += [render_mesh(np.ones(BG_IMG_SHAPE) * 255, m, faces,
                                        dict(focal=FOCAL, princpt=PRINCPT),
                                        view="front").astype(np.uint8) for m in meshes]
            else:
                multiple_render(samples, normalizer, body, target,
                                "inter_" + str(idx) + "_{}.png", **render_kwargs(args))
        except FileNotFoundError as e:
            print(f"[skip renders] {e}")
            render = False
        render_s += time.perf_counter() - t0
    out = dict(frames_file=os.path.join(target, "frames.npz"), recon_err=recon_err)
    if args.video and renders:
        t0 = time.perf_counter()
        out["video_file"] = os.path.join(target, "interpolation_video.mp4")
        write_video(renders, out["video_file"], INTER_VIDEO_FPS)
        render_s += time.perf_counter() - t0
    out["render_s"] = render_s
    np.savez(out["frames_file"], pose_frames=torch.stack(frames).cpu().numpy(),
             anchors=anchors.cpu().numpy(),
             recon=normalizer.offline_denormalize(recon, to_axis=True).cpu().numpy())
    print(f"Interpolation outputs under {target}")
    return out


def render_kwargs(args) -> dict:
    """``multiple_render``'s canvas, camera and ``--view`` (ref run/demo.py:150)."""
    return dict(bg_img=np.ones(BG_IMG_SHAPE) * 255, focal=FOCAL, princpt=PRINCPT,
                view=args.view)


def load_poses(args, device) -> torch.Tensor:
    """The first ``SAMPLE_NUM`` axis-angle poses of ``--file-path``."""
    with np.load(args.file_path, allow_pickle=False) as f:
        poses = torch.as_tensor(f["pose_samples"][:SAMPLE_NUM], dtype=torch.float32,
                                device=device)
    print(f"loaded axis pose data {tuple(poses.shape)} from {args.file_path}")
    return poses


def run_view(args, device) -> dict:
    """The view task (ref run/demo.py:446-450): the poses of ``--file-path``
    rendered as they are. A missing body model raises."""
    poses = load_poses(args, device)
    body = BodyModel(args.bodymodel_path, num_betas=10, model_type="smplx", device=device)
    target = os.path.join(args.output_path, "view")
    multiple_render(poses, None, body, target, "GT_sample{}.png", convert=False,
                    **render_kwargs(args))
    print(f"rendered images saved under {target}")
    return dict(view_dir=target, n=len(poses))


def run_generation_process(args, config, sde, model, normalizer, generator, device) -> dict:
    """The generation_process task (ref run/demo.py:408-437): ``VIDEO_NUM``
    poses sampled with the config's pc sampler, the state recorded after
    grid steps 9, 19, ..., and each pose's frames rendered (front view) to
    a ``VIDEO_FPS`` video. In the kernels' scope the kernel sampler records
    the steps (``trajectory_steps``; on the card one CUDA graph), else the
    plain PC loop's trajectory is sliced. A missing body model or ``cv2``
    raises. Returns ``videos``, ``trajs`` [frames, VIDEO_NUM, D]
    (normalized) and ``sample_s``, ``body_s`` and ``render_s``."""
    if config.sampling.method.lower() != "pc":
        raise ValueError(f"generation_process records the pc sampler's trajectory; the "
                         f"config's sampling method is {config.sampling.method!r}")
    target = os.path.join(args.output_path, "generation_process")
    os.makedirs(target, exist_ok=True)
    eps = sampling_eps_for(sde)
    t0 = time.perf_counter()
    if kernel_scope(config, model):
        s = build_sampler(config, sde, model, VIDEO_NUM, eps, config.sampling.corrector, device,
                          trajectory_steps=range(9, sde.N, 10))
        print("[sampler] kernel sampler recording steps 9, 19, ... "
              f"(corrector={config.sampling.corrector})")
        trajs, _ = s(generator)
    else:
        trajs, _ = plain_pc_sampler(config, sde, model, VIDEO_NUM, eps, device,
                                    return_trajectory=True)(generator)
        trajs = trajs[9::10]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sample_s = time.perf_counter() - t0
    import cv2  # noqa: F401  (the videos need it: fail before the renders, as JAX does)

    body = BodyModel(args.bodymodel_path, num_betas=10, model_type="smplx", device=device)
    videos, body_s, render_s = [], 0.0, 0.0
    for idx in range(VIDEO_NUM):
        t0 = time.perf_counter()
        meshes, faces = body_meshes(trajs[:, idx], normalizer, body)
        t1 = time.perf_counter()
        frames = [render_mesh(np.ones(BG_IMG_SHAPE) * 255, m, faces,
                              dict(focal=FOCAL, princpt=PRINCPT), view="front").astype(np.uint8)
                  for m in meshes]
        render_s += time.perf_counter() - t1
        body_s += t1 - t0
        videos.append(os.path.join(target, f"generation_process{idx}.mp4"))
        write_video(frames, videos[-1], VIDEO_FPS)
    return dict(videos=videos, trajs=trajs, sample_s=sample_s, body_s=body_s,
                render_s=render_s)


def _timed_si(vertices: torch.Tensor, faces: np.ndarray, ready) -> tuple:
    """SI of one chunk's meshes once ``ready`` (its copy's event, or None)
    has completed -> (SI per mesh, seconds of the SI call)."""
    if ready is not None:
        ready.synchronize()
    t0 = time.perf_counter()
    si = self_intersections_percentage(vertices.numpy(), faces)
    return si, time.perf_counter() - t0


def run_metrics(args, config, sde, model, normalizer, generator, device,
                quant_kwargs, mesh=None) -> dict:
    """The 500-sample metrics protocol (ref run/demo.py:338-406): ``apd``,
    ``si``, ``metrics_wall_s`` (build, sample, APD, SI), ``si_wall_s`` (the
    SI calls' seconds, summed over the chunks) and ``sample_wall_s`` (from
    the start until the device has finished every chunk's meshes).

    With ``--metrics-chunks C`` > 1 one sampler of 500/C rows serves every
    chunk. Each chunk's sampling and SMPL forward are enqueued in turn, its
    vertices copied into pinned host memory without blocking and an event
    recorded after the copy; a worker thread waits on that event and runs
    the chunk's SI (the native call releases the interpreter lock) while the
    later chunks are on the device. Each chunk draws from ``generator`` in
    turn, so the samples differ from the single batch's; APD is taken over
    the joints of all 500. ``mesh`` (more than one device) shards each
    chunk's sampler, its rows padded to a multiple of the mesh's size."""
    t0 = time.perf_counter()
    n_chunks = args.metrics_chunks
    per = METRICS_SAMPLE_NUM // n_chunks
    if kernel_scope(config, model, "langevin"):
        sampler = build_sampler(config, sde, model, mesh_rows(mesh, per), METRICS_EPS,
                                "langevin", device,
                                quant_kw=quant_kwargs(METRICS_EPS, "langevin"), mesh=mesh)
    else:
        sampler = plain_pc_sampler(config, sde, model, per, METRICS_EPS, device, "langevin")
    # Pose-NDF protocol: SMPL body, zero-padded hand joints
    body = BodyModel(args.smpl_path, num_betas=10, model_type="smpl", device=device)
    faces = body.f.cpu().numpy()
    on_card = device.type == "cuda"
    jtrs, futures = [], []
    with ThreadPoolExecutor(1) as pool:
        for _ in range(n_chunks):
            samples = normalizer.offline_denormalize(sampler(generator)[:per], to_axis=True)
            pose = torch.cat([samples, torch.zeros(per, 6, device=device)], 1)
            out = body(pose_body=pose)
            jtrs.append(out.Jtr[:, :22])
            verts = torch.empty(out.v.shape, dtype=out.v.dtype, pin_memory=on_card)
            verts.copy_(out.v, non_blocking=on_card)
            ready = None
            if on_card:
                ready = torch.cuda.Event()
                ready.record()
            futures.append((pool.submit(_timed_si, verts, faces, ready), ready))
        apd = float(average_pairwise_distance(torch.cat(jtrs)))
        if on_card:
            futures[-1][1].synchronize()
        sample_wall = time.perf_counter() - t0
        chunks = [f.result() for f, _ in futures]
    si = float(np.nanmean(np.concatenate([c[0] for c in chunks])))
    return dict(apd=apd, si=si, metrics_wall_s=time.perf_counter() - t0,
                si_wall_s=float(sum(c[1] for c in chunks)), sample_wall_s=sample_wall)


def run(args, mesh=None) -> dict:
    """The task. View returns ``view_dir`` and ``n``; generation_process
    ``run_generation_process``'s keys and ``step``; generation returns
    ``samples_file``, ``step`` and, with
    ``--metrics``, ``run_metrics``'s ``apd``, ``si``, ``metrics_wall_s``,
    ``si_wall_s`` and ``sample_wall_s``; the completion tasks
    ``hypotheses_file``, ``mpvpe``, ``mpjpe`` and ``step``; interpolation
    ``frames_file``, ``recon_err`` and ``step``. ``mesh`` is the devices to
    shard over, by default the process's visible CUDA devices on ``--device
    cuda`` and the CPU on ``--device cpu``."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    if args.metrics_chunks < 1 or METRICS_SAMPLE_NUM % args.metrics_chunks:
        raise SystemExit(f"--metrics-chunks {args.metrics_chunks} must divide "
                         f"{METRICS_SAMPLE_NUM}")
    if args.task == "view":
        return run_view(args, device)
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
    if mesh is None:
        mesh = make_mesh() if device.type == "cuda" else make_mesh(devices=[device])
    mesh, _ = mesh_route(mesh, device)
    if mesh is not None:
        print(f"[mesh] sharding over {mesh.size} devices: {[str(d) for d in mesh.devices]}")
    if args.task in ("completion", "completion2"):
        return dict(run_completion(args, config, sde, model, normalizer, generator, device,
                                   quant_kwargs, mesh), step=step)
    if args.task == "interpolation":
        return dict(run_interpolation(args, config, sde, model, normalizer, generator,
                                      device), step=step)
    if args.task == "generation_process":
        return dict(run_generation_process(args, config, sde, model, normalizer, generator,
                                           device), step=step)

    eps = sampling_eps_for(sde)
    few = args.sampler != "pc" and config.sampling.corrector == "none"
    sampler = build_generation_sampler(
        config, sde, model, SAMPLE_NUM, eps, device,
        quant_kw=(quant_kwargs(eps, config.sampling.corrector)
                  if few or config.sampling.method.lower() == "pc" else None), args=args,
        mesh=mesh)
    normed = sampler(generator)
    samples = normalizer.offline_denormalize(normed, to_axis=True)
    target = os.path.join(args.output_path, "generation")
    os.makedirs(target, exist_ok=True)
    out = dict(samples_file=os.path.join(target, "samples.npz"), step=step)
    np.savez(out["samples_file"], pose_samples=samples.cpu().numpy())
    print(f"samples saved to {out['samples_file']}")
    t0 = time.perf_counter()
    try:
        body = BodyModel(args.bodymodel_path, num_betas=10, model_type="smplx", device=device)
        multiple_render(normed, normalizer, body, target, "generated_sample{}.png",
                        **render_kwargs(args))
        print(f"samples saved under {target}")
    except FileNotFoundError as e:
        print(f"[skip renders] body model unavailable: {e}")
    out["render_s"] = time.perf_counter() - t0

    if args.metrics:
        out.update(run_metrics(args, config, sde, model, normalizer, generator, device,
                               quant_kwargs, mesh))
        print(f"[metrics] protocol segment wall (build+sample+APD+SI, "
              f"chunks={args.metrics_chunks}): {out['metrics_wall_s']:.2f}s "
              f"(SI {out['si_wall_s']:.2f}s, sampling {out['sample_wall_s']:.2f}s)")
        print("average_pairwise_distance for 500 generated samples", out["apd"])
        print("self-intersections percentage for 500 generated samples", out["si"])
    return out


def main(argv=None) -> int:
    run(parse_args(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
