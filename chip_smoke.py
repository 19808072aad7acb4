#!/usr/bin/env python3
"""Drive the PyTorch port (``dposer_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --plain-loops   # (p) also times each shard's plain loop

Phases; any failure exits non-zero:

1. device: the card's name, count and power limit;
2. build: the CUDA kernels from ``dposer_tpu_torch/ops/cuda/csrc`` with nvcc
   (``-Xptxas -v`` printed, and the registers and shared memory of every
   instantiation of the Hopper main loops ``dense_wgmma.cuh`` and
   ``dense_wgmma_int8.cuh``, with any ptxas line reporting serialized wgmma;
   for the cluster kernels K2 (and its imputation instantiation), K3, K6,
   K7's Hopper route, K8, K9 and K11 (on the bf16 stash and on fp32 h) their
   grid, cluster size, shared memory, the clusters the card holds at once
   and their registers; K6 and its perturbing instantiation with their
   registers, spills (none allowed) and CTAs an SM
   by registers; a ptxas line
   reporting serialized wgmma in K7 or K9 fails the phase; K10's and K12's instantiations with their registers,
   shared memory, spills and CTAs an SM, where a serialized wgmma fails the
   phase too; K1's bf16 route (``dense_wgmma_ss.cuh``'s ring, from the copy
   the layer before wrote) with its registers, static shared memory, spills
   and CTAs an SM by registers, its launch at 500 and 1,000 rows (dynamic
   shared memory, stages, CTAs an SM), and a serialized wgmma in K1's
   library fails the phase; K1's pre route with its registers (at most
   128), static shared memory, spills (none allowed) and CTAs an SM by
   registers, and its launch at 500 and 1,000 rows (the dynamic shared
   memory it reserves, CTAs an SM: one and two); K13's pre route the same;
3. each of the fourteen kernels, K2's imputation mode and K6's perturbing
   instantiation against its plain PyTorch version at the
   main paths' shapes ([500, .] for generation, imputation and PF-ODE
   sampling, [1000, .] for the completion solver, [50, .] for the
   likelihood, [1280, .] for training, [512, .] for the microbenchmarks), on
   the pinned trained weights, with the in-kernel normals' moments (for K2
   and K3 also element by element against the plain Philox stream of
   ``ops/cuda/philox.py``, and 50 repeated calls bit-identical), and its
   device time (CUDA-graph replay, so host overhead is excluded) beside the
   plain version's, a library yardstick's and the bound from bytes and
   operations at the published H100 SXM peaks; K13 on states of a real
   trajectory with the per-tensor and per-channel ranges the demo calibrates,
   the pre layer on the pre route, each K = 1024 layer on the int8 copy the
   layer before wrote; K7 on the likelihood's routes (the pre layer on the
   register route writing the bf16
   copies, the K = 1024 layers on the Hopper route from them; the copies
   byte for byte) and beside them on the register route, and K9, both with
   50 repeated calls bit-identical and bounds at the handoff's bytes and at
   fp32 A; the Hopper
   int8 loop first alone (one [64,128]x[128,64] tile and K13's product at
   [500,1024]x[1024,1024], exact), K13's int8 copies byte for byte and K14's
   int8 inner and last links exact against their plain versions;
   K10 on the routes a train step takes (the pre layer from fp32 A on the
   register route, the K = 1024 layers from the bf16 stash on the Hopper
   route, a block's first layer and the last layer without their fp32
   output) and beside them on the register route and writing that output,
   K11 on the last layer's bf16 stash, bit-equal to K11 on fp32 h, K12's
   three hops, each with 50 repeated calls bit-identical and K10's and K11's
   bounds at the handoff's bytes and at fp32 input; K8 at every stage and
   the denoise, with 50 repeated calls bit-identical;
   K1 on the routes a forward takes (the pre layer on the pre route
   writing the bf16 copy, a block's first layer from the copy writing its
   copy alone, the second with the residual), the pre layer bit-equal to
   the pre route on x and W zero-padded to K = 64, and the copies byte for
   byte the output rounded (a block's first layer's beside the fp32 output
   the same launch writes), with bounds at the handoff's bytes;
   K1 also at completion's [1000, 63] pre layer (both routes) and
   [1000, 1024] residual block; K1's three layer
   shapes, K2's EM and score modes and K3 (its value and step size) also at
   the chunked metrics protocol's 50 rows; K2-K6's in-kernel
   normals read their seed from device memory (timed with a seed tensor
   made once); K2's imputation mode
   (the EM update, then the re-noise of its step and of the next) also bit
   for bit against K2 -> K4 -> K4 under host and in-kernel normals, with 50
   repeated calls bit-identical, and K6 with 50 repeated calls bit-identical;
   K5 bit-equal to its plain version on host normals; K6's perturbing
   instantiation (the Adam step, then the next step's perturbation) bit for
   bit against K6 -> K5 at 1, 37, 500 and 1,000 rows under host and
   in-kernel normals, with 50 repeated calls bit-identical;
4. the whole kernel sampler against the same loop on the plain versions,
   N = 20, injected noise, corrector none and langevin, without and with
   masked imputation: step by step, and row by row on the free-running
   trajectories; the whole kernel completion solver against its plain loop,
   injected noise, at 6 rows x 2x8 steps and 1000 rows x 2x100 steps,
   pointwise; the kernel RK4 PF-ODE sampler (20 and 125 steps, without and
   with the final denoise) and the kernel likelihood (50 x 100) against their
   plain loops, and the kernel PF-Euler decode against the fp32 tabled
   sampler, all pointwise, since none of them draws noise; the int8 kernel
   sampler (per tensor and per channel) against its plain loop step by step
   at N = 20, 500 rows;
5. the slices' protocols at flagship size, each with the launch counters
   set to 0 before it and read after it:
   (a) generation, 500 poses x 1000 sub-VP EM steps, in-kernel normals:
   poses/s, K1's routes a call (4,000 from the bf16 copy, 1,000 on the pre
   route), and the tensor maps K1 encodes a call (at most 8: its map cache
   holds them across launches); (b) the demo's generation task with ``--metrics`` (50 poses,
   then 500 poses x 1000 steps with the langevin corrector at eps 5e-3,
   through the SMPL body): APD must lie in [0.80, 1.00] and SI in [0, 100];
   then the self-intersection metric (SI): the native library built with
   g++ (a missing g++ fails the phase), multithreaded SI equal to
   single-threaded SI on 20 meshes of the smooth 7,056-vertex SMPL body of
   ``benchmarks/gen_synth_body.py``, and the protocol on that body at
   ``--metrics-chunks`` 1 and 10: SI in [0, 100], the chunked APD within 5%
   of the single batch's, each run's wall, SI and sampling seconds and the
   host CPU, and the device time of one protocol sampler call at 500 and at
   50 rows;
   (c) completion by optimisation, 100 synthetic poses x 10 hypotheses,
   2x100 Adam steps, time strategy '3': solves/s, MPJPE and MPVPE, and the
   launches a solve (K5 1, K1 1,000, K6's perturbing instantiation 199, K6
   with the paste 1) and K1's routes (800 from the bf16 copy, 200 on the
   pre route);
   (d) the demo's ``completion`` task and its ``completion2`` task with
   ``--sampler pc``, ``ddim`` and ``hybrid``, 50 poses x 10 hypotheses, left
   leg masked, through the synthetic SMPL-X body: MPJPE must lie in (50, 400)
   mm and MPVPE in (5, 80) mm (an untrained model exceeds 1000 mm), with K4's
   and K2's launches a completion2 call (corrector-free pc and ddim must
   launch K4 once);
   (e) PF-ODE sampling, 500 poses x 125 RK4 steps: poses/s; (f) the PF-Euler
   decode, 500 x 1000 deterministic steps at eps 1e-5: poses/s; (g) the exact
   likelihood of 50 synthetic poses, 100 RK4 steps at eps 1e-4: ms per batch,
   a stage's device time from graph replay and the device's busy share,
   K7's route counters (a stage: 1 register, 4 Hopper), and its bits/dim
   against the fp32 fixed-grid path and the adaptive RK45 oracle on the same
   Hutchinson probe (batch means within 0.1); (h) the
   demo's ``interpolation`` task on synthetic poses: the reconstruction error
   and finite frames of shape [5, 60, 63]; (i) the int8 serving mode: 500 x
   1000 generation per tensor, per channel and int8-mixed beside bf16
   (poses/s; K13's route counters: 4,000 launches on the Hopper int8 loop
   and 1,000 on the pre route a call, 3,600 and 900 mixed, none on the
   register-staged loop), the
   metrics protocol under per-channel int8 (APD in [0.80,
   1.00] and within 0.03 of bf16's), moments at 2,000 rows against the bf16
   kernel route on one host-normal stream (mean within 1e-2, std within 2e-2,
   corr(0, 32) within 5e-2; bf16 against fp32 within 1e-2 in all three),
   completion2 pc under per-channel int8 (MPJPE in
   the band and within 15% of bf16 pc) and the hybrid per channel and per
   tensor; (j) both microbenchmarks (``dposer_tpu_torch.benchmarks``) at 100
   chain steps, the ilp splits bit-identical to the whole run, the int8
   chain after 100 steps bit-equal to the plain chain; and the trainer's
   protocols, after the kernel step against the fp32 autograd step, whose
   kernel step must run K10's four K = 1024 layers on the Hopper route and
   its pre layer on the register route, and K12's five hops on the Hopper
   route; (k) the loops as CUDA graphs (``ops/cuda/graph_loop.py``, the
   samplers' default on the card): every graphed route at its main path's
   shape (generation, the metrics sampler, completion2 pc, ddim and hybrid,
   int8 per channel and int8-mixed, the PF-Euler decode, PF-ODE sampling,
   the likelihood, the 5c solve) bit-equal to its eager loop from the same
   generator state with the same launch, route and programmatic counts,
   another seed giving other values in tensors of their own, the captured
   graphs' edges between kernels printed by type, and the generation and 5c
   graphs holding a programmatic edge into every programmatic launch but
   the first (K1, K2, K5, K6, K13: ``csrc/mbarrier.cuh``); 5a, 5c, 5e and 5g time
   their eager loop beside the graph and print both walls, the graph's
   warm-up, capture and instantiation seconds and the device's busy share
   of each; (l) ``python -m dposer_tpu_torch.bench``'s line as run on the
   card; (m) motion denoising (``MotionDenoise``) of 8 fragments x 60 frames
   of ``benchmarks/gen_synth_motion.py`` on the human-scale synthetic SMPL-X
   body, sigma 0.04, 3 x 60 Adam steps in one ``optimize_batch``: every
   fragment's MPJPE below its noisy init, each fragment's ``optimize`` on the
   same draws pointwise within 1e-5 rad over 20 steps and within 5% of its
   MPJPE over the schedule, ms per fragment; (n) SMPLify with the DPoser
   prior on 8 synthetic EHF images (``benchmarks/gen_synth_ehf.py``'s
   geometry, the 10,475-vertex synthetic body), 100 + 5 x 100 steps:
   PA-MPJPE and MPJPE below the mean-pose init's, the same fit without the
   prior, ms per image; both with the device's busy share over a profiled
   window and no kernel launched (the JAX package runs these tasks under
   XLA); (o) ``python -m dposer_tpu_torch.completion``'s ``run`` over a
   synthetic test split of 5,000 poses (``benchmarks/gen_synth_amass.py``'s
   mixture), 100 poses x 10 hypotheses a batch: MPJPE and MPVPE in the
   bands, each batch's launches those of a 5c solve, one CUDA graph
   captured for the split, row-solves/s and poses/s, the first batch's wall
   beside the steady median; (p) sharded serving on one card
   (``dposer_tpu_torch/parallel``, a mesh of four shards on cuda:0): the
   500 x 1000 generation (each shard bit-equal to a 125-row call with its
   folded generator, the shards' draws different, launches 4x a 125-row
   call's, one graph a shard, no tensor map encoded by a replay), EM at N =
   20 on injected host noise with and without the corrector and imputation
   (each shard bit-equal on its rows; corrector-free within phase 4's
   row-by-row bounds of the 500-row call; K2's score mode and K3 are held
   against their plain versions at a shard's 125 rows in phase 3), the 5c
   solve (each shard bit-equal; on injected host normals the 1,000-row
   solve bit for bit) and ``DPoserComp(mesh=)`` (pasted exactly, 5c's
   bands), ODE sampling 500 x 125 (each shard bit-equal; within
   5e-2*max(1, |ref|) of the 500-row call), the likelihood 50 x 100 on two
   shards with 5g's probe (each shard bit-equal, every row's bits/dim and z
   the 50-row call's, bits/dim mean within 0.1 of 5g's), and
   ``python -m dposer_tpu_torch.completion --multihost`` as two processes
   on the card over 1,000 poses, equal bit for bit to one process; walls
   beside the unsharded calls' and a shard call's device time and bound
   (with ``--plain-loops`` also its plain loop's); (q) data-parallel
   training (``parallel.sharding``'s training half): K10 (both routes) and
   K12 on rows 640:1280 of the train shapes at ``row_offset=640`` bit-equal
   to those rows of the full launch, K12's dgamma and dbeta of the two
   halves summed within 1e-5 x max(1, |full|) of the full launch's, each
   against its plain version at the offset, and timed at 640 rows beside
   1,280; ``python -m dposer_tpu_torch.train --multihost`` as two processes
   on cuda:0 (4 steps at 1,280 rows, eval at steps 2 and 4): the first
   firing captures its sampler's graph, the second captures none, encodes
   no tensor map and draws samples bit-equal to a sampler built fresh on the
   same EMA weights, the ranks equal; beside it 5m's 8 fragments and 5n's 8
   images on a mesh of four shards on cuda:0 over 20 steps against the
   unsharded batch (poses within 1e-5 rad, fits within 2e-5 x max(1,
   |ref|), metrics within 1e-3 relative and 1e-4 absolute); then two
   processes on cuda:0 over gloo training the kernel step at 1,280 rows (640
   a rank) from the pinned checkpoint for 100 steps against one process on
   the same stream (the first 20 losses within 1e-4 relative, the last-50
   mean within 2%, the ranks' parameters and EMA bit-equal, a rank's step
   K10 x5, K11 x1, K12 x5), with ms a step, the all-reduce's share and the
   gradient bytes a step; (r) the last modules: (i) the native rasterizer
   (``body_model/visual.py``) built with g++, its masks against the plain
   numpy version's on at least 97% of the pixels at 512 x 384 in the six
   views, on the 10,475-vertex synthetic SMPL-X body and the smooth SMPL
   body, ms a render of both with the host CPU; (ii) the demo's
   ``generation_process`` on the kernel sampler's graph, 3 x 1000 steps
   recording steps 9, 19, ..., 999: the output bit-equal to the sampler's
   without ``trajectory_steps``, the frames at 9, 499 and 999 bit-equal to
   ``step_range`` calls, K1 5,000 and K2 1,000 a call and one graph; the
   body model and the renders of the 300 frames, with their walls; (iii)
   ``python -m dposer_tpu_torch.train --profile-dir`` from scratch, 20
   kernel steps and an eval: the trace holds K10's, K11's and K12's kernels
   and the spans of steps 11-20, ``last_samples.npz`` holds ``pose_trajs``
   [10, 5, 63], and the eval's trajectory is bit-equal to a fresh sampler's
   on the same EMA weights; (iv) ``demo_fit``'s fit of one image of (n)'s
   synthetic EHF geometry (its re-projection loss falls) and a TimeMLPs
   model through the ancestral predictor and ald at N = 20, card against
   CPU within 1e-4 x max(1, |ref|);
6. one ``{"kernels": [...]}`` line, the card's name and power limit, and the
   final ``{"ok": true, ...}`` line.

Needs the repository around it (the port, the pinned checkpoint under
``artifacts/trained_r5``, ``tests/fixtures.py`` for the synthetic SMPL and
SMPL-X bodies, ``dposer_tpu/assets`` for the mean pose, and
``benchmarks/gen_synth_amass.py`` and ``gen_synth_motion.py`` for the synthetic
poses); writes only under ``chiprun_out/chip_smoke``.
The self-intersection metric also needs ``g++`` (it builds its library under
``dposer_tpu_torch/native/_build``) and ``benchmarks/gen_synth_body.py`` and
``time_metrics.py`` for the smooth SMPL body.
"""
import copy
import ctypes
import importlib.util
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
    sys.exit(2)

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))  # fixtures.py: numpy only

import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from dposer_tpu_torch import completion as completion_cli  # noqa: E402
from dposer_tpu_torch import demo  # noqa: E402
from dposer_tpu_torch import demo_fit  # noqa: E402
from dposer_tpu_torch import native  # noqa: E402
from dposer_tpu_torch import parallel  # noqa: E402
from dposer_tpu_torch import fitting as fitting_cli  # noqa: E402
from dposer_tpu_torch import motion_denoising as motion_cli  # noqa: E402
from dposer_tpu_torch import train as train_cli  # noqa: E402
from dposer_tpu_torch.body_model import BodyModel  # noqa: E402
from dposer_tpu_torch.body_model import visual  # noqa: E402
from dposer_tpu_torch.body_model.fitting_losses import perspective_projection  # noqa: E402
from dposer_tpu_torch.body_model.smplx_fit import SMPLXFit  # noqa: E402
from dposer_tpu_torch.config import get_config  # noqa: E402
from dposer_tpu_torch.data import MocapDataset, PoseNormalizer  # noqa: E402
from dposer_tpu_torch.data.preprocess import bbox_from_detector  # noqa: E402
from dposer_tpu_torch.diffusion import fast_sampler as tfs  # noqa: E402
from dposer_tpu_torch.diffusion import likelihood as tlik  # noqa: E402
from dposer_tpu_torch.diffusion import losses as tlosses  # noqa: E402
from dposer_tpu_torch.diffusion.score_fn import get_score_fn  # noqa: E402
from dposer_tpu_torch.diffusion import few_step  # noqa: E402
from dposer_tpu_torch.diffusion import sampling as tsampling  # noqa: E402
from dposer_tpu_torch.diffusion.sde import SubVPSDE, VPSDE, sampling_eps_for  # noqa: E402
from dposer_tpu_torch.smplify import sequence_generator  # noqa: E402
from dposer_tpu_torch.benchmarks import data_parallel, ilp_probe, mxu_micro  # noqa: E402
from dposer_tpu_torch.ops.cuda import (build, chain_link, fused_comp, fused_em,  # noqa: E402
                                       fused_lik, fused_ode, fused_train, philox, quant,
                                       score_net)
from dposer_tpu_torch.models import TimeMLPs, create_score_model  # noqa: E402
from dposer_tpu_torch.ops.cuda.graph_loop import GraphLoop  # noqa: E402
from dposer_tpu_torch.ops.metrics import Evaler, average_pairwise_distance  # noqa: E402
from dposer_tpu_torch.ops.rotations import estimate_focal_length  # noqa: E402
from dposer_tpu_torch.tasks import DPoser, DPoserComp, MotionDenoise, SMPLify  # noqa: E402
from dposer_tpu_torch.utils.masks import create_mask  # noqa: E402
from fixtures import make_synthetic_body_model  # noqa: E402
from portbench.peaks import (BF16_TC_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S,  # noqa: E402
                             INT8_TC_OPS)

ART = os.path.join(REPO, "artifacts", "trained_r5")
CKPT = os.path.join(ART, "axis-zscore-400k-synth.pth")
STATS = os.path.join(ART, "stats")
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
TPU_KERNEL = "dposer_tpu/ops/pallas/fused_em.py:467"
TPU_COMP_KERNEL = "dposer_tpu/ops/pallas/fused_comp.py:271"
TPU_ODE_KERNEL = "dposer_tpu/ops/pallas/fused_ode.py:215"
TPU_LIK_KERNEL = "dposer_tpu/ops/pallas/fused_lik.py:180"
TPU_TRAIN_KERNEL = "dposer_tpu/ops/pallas/fused_train.py:350"
TPU_MXU_KERNEL = "benchmarks/mxu_micro.py:61"
TPU_ILP_KERNEL = "benchmarks/ilp_probe.py:85"
CSRC = "dposer_tpu_torch/ops/cuda/csrc"

APD_BAND = (0.80, 1.00)
MPJPE_BAND, MPVPE_BAND = (50.0, 400.0), (5.0, 80.0)  # mm, tests/test_trained_artifact.py
B, H, D = 500, 1024, 63
RC = 1000  # completion's rows: 100 poses x 10 hypotheses
METRICS_CHUNKS = 10  # the chunked metrics protocol's --metrics-chunks
BM = B // METRICS_CHUNKS  # its rows a chunk
BL = 50  # the likelihood protocol's batch
BT = 1280  # the train batch (configs/default_amass_configs.py)
FT_STEPS, SCRATCH_STEPS, RESUME_STEPS = 500, 1000, 200  # the training protocols (a)-(c)
TRAIN_DEVICE = "cuda"
ODE_STEPS, LIK_STEPS, LIK_EPS, DECODE_EPS = 125, 100, 1e-4, 1e-5
BPD_LIMIT = 0.1  # bits/dim between two paths' batch means (tests/test_fast_ode.py)
ODE_TOL = 5e-2  # kernel against plain deterministic samplers, times max(1, |ref|max)
PART, HYPO = "left_leg", 10
TMA_ENCODES_PER_CALL = 8  # K1's tensor-map cache misses allowed in one generation call
DRAW_TOL = 1e-5  # in-kernel normals against the plain Philox stream (logf, cospif vs float64)
REPEATS = 50  # repeated calls of K2, K3, K6-K12 that must give the same bits
GRAPH_SEED = 21  # the graph phase's generator seed (and GRAPH_SEED + 1)
SHARDS, SHARD_SEED = 4, 31  # (p): the mesh's shards, all on cuda:0, and its seeds
CLI_POSES, CLI_TIMEOUT_S = 1000, 300  # (p)(vi): the split, each process's time limit
# (q): the rank's first row, the steps of the two-rank run and the steps held
# loss by loss, the bounds, the pool of poses, each rank's time limit, the
# trainer's steps, the fits' steps, and the bound of the halves'
# dgamma/dbeta sums against the full launch's
ROW_OFFSET, DP_STEPS, DP_CHECK_STEPS = BT // 2, 100, data_parallel.CHECK_STEPS
DP_LOSS_RTOL, DP_TAIL_RTOL, DP_POOL = 1e-4, 0.02, 20000
DP_TIMEOUT_S, MH_STEPS, DP_FIT_STEPS, DP_SUM_TOL = 300, 4, 20, 1e-5
# (p): also time each shard's call on the plain versions (a run with this
# argument, for PERF.md's plain column; the default run skips it)
PLAIN_LOOPS = "--plain-loops" in sys.argv[1:]
MOTION_STD = 0.04  # (m): the joints' noise in m
# (m): optimize_batch against each fragment's optimize on the same draws:
# the poses over the first MOTION_SHORT_STEPS steps (rad), and each
# fragment's final MPJPE over the whole schedule (relative)
MOTION_SHORT_STEPS, MOTION_BATCH_TOL, MOTION_MPJPE_RTOL = 20, 1e-5, 0.05
SHARE_STEPS = 12  # the fitting phases' profiled window, Adam steps
N_IMG, EHF_W, EHF_H, EHF_TOP_V = 8, 1600, 1200, 250.0  # (n): gen_synth_ehf.py's geometry

class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def bound(n_bytes, tc_flops, fp32_ops, tc_peak=BF16_TC_FLOPS):
    """(least ms, what bounds it): bytes over the memory rate against the
    operations over the peak rate of their type (``tc_peak``: the tensor
    cores' bf16 or int8 rate)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(tc_flops / tc_peak, fp32_ops / FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def graph_ms(fn, reps=20, replays=10):
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):  # warm-up, outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * replays)


def eager_ms(fn, iters=200):
    """Time of one ``fn()`` issued back to back from Python: the host's
    launch rate when it is slower than the device."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def timed_calls(fn, n=3):
    """Wall seconds of ``n`` calls of ``fn`` (the first is the warm-up), the
    launch counters set to 0 before each, and the last call's result."""
    walls = []
    for _ in range(n):
        fused_em.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, res


_SEEDS = {}


def dseed(s):
    """The seed ``s`` as the kernels read it (a one-element int64 tensor on
    the card), made once, so that a timed launch times the kernel alone and
    not also the fill of a new seed tensor."""
    if s not in _SEEDS:
        _SEEDS[s] = fused_em.seed_tensor(s, torch.device("cuda", torch.cuda.current_device()))
    return _SEEDS[s]


def eager_twin(res, graph_fn, eager_call):
    """Time the eager loop of a protocol whose default call replays a CUDA
    graph (3 calls, the first warms up) and record its walls in ``res``
    beside the graph's first-call seconds: warm-up, capture, instantiation."""
    walls, _ = timed_calls(eager_call)
    res.update(eager_wall_s=min(walls[1:]), eager_walls_s=walls,
               graph_loops=[dict(warmup_s=lp.warmup_s, capture_s=lp.capture_s,
                                 instantiate_s=lp.instantiate_s) for lp in graph_fn.loops])


def err(out, ref):
    e = float((out - ref).abs().max())
    check(torch.isfinite(out).all().item(), "non-finite kernel output")
    return e


def smi_line():
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    check(p.returncode == 0 and p.stdout.strip(), f"nvidia-smi failed: {p.stderr}")
    return p.stdout.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_line()
    print(f"[device] {name} x{count} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    return dict(kind=name, count=count, smi=smi)


def ptxas_entries(log, word):
    """Registers, static shared memory and spills of each entry function of
    one library's ``-Xptxas -v`` log whose mangled name holds ``word``."""
    rows, entry, spill = [], None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1) if word in m.group(1) else None
            spill = None
        elif entry and "spill" in ln:
            spill = ln.strip()
        elif entry and "Used" in ln:
            smem = re.search(r"(\d+) bytes smem", ln)
            rows.append(dict(entry=entry,
                             registers=int(re.search(r"Used (\d+) registers", ln).group(1)),
                             static_smem=int(smem.group(1)) if smem else 0, spills=spill))
            entry = None
    return rows


def wgmma_instantiations(logs):
    """Registers, static shared memory and spills of every instantiation of
    the Hopper main loop from fp32 A (``csrc/dense_wgmma.cuh``, in K14) from
    the ``-Xptxas -v`` log, and the dynamic shared memory of its two rings."""
    rows = []
    for e in ptxas_entries(logs.get("chain_link", ""), "chain_link_wgmma_kernel"):
        args = ",".join(re.findall(r"L[ib](\d+)E", e["entry"]))
        rows.append(dict(library="chain_link", kernel=f"chain_link_wgmma_kernel<{args}>",
                         registers=e["registers"], static_smem=e["static_smem"],
                         spills=e["spills"]))
    fn = build.load("chain_link").dposer_wgmma_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return rows, dict(wide=fn(1), narrow=fn(0))


def k1_bf16_instantiations(logs):
    """Registers, static shared memory, spills and CTAs an SM by registers of
    every instantiation of K1's bf16 route (``dense_gn_silu.cu``'s
    ``handoff::dense_gn_silu_wgmma_kernel`` on ``csrc/dense_wgmma_ss.cuh``'s
    ring) from the ``-Xptxas -v`` log, and the ptxas lines of K1's library
    that report serialized wgmma."""
    log = logs.get("dense_gn_silu", "")
    serialized = [ln.strip() for ln in log.splitlines() if "wgmma" in ln and "serialized" in ln]
    rows = []
    for e in ptxas_entries(log, "handoff"):
        args = ",".join(re.findall(r"L[ib](\d+)E", e["entry"]))
        rows.append(dict(kernel=f"handoff::dense_gn_silu_wgmma_kernel<{args}>",
                         registers=e["registers"], static_smem=e["static_smem"],
                         spills=e["spills"],
                         ctas_per_sm_by_registers=ctas_per_sm_by_registers(e["registers"], 256)))
    return rows, serialized


def k1_bf16_launch(rows, n):
    """K1's bf16 route at ``rows`` x ``n`` as it launches on this card:
    threads and dynamic shared memory a CTA, the ring's stages and the CTAs
    an SM holds at once."""
    fn = build.load("dense_gn_silu").dposer_dense_gn_silu_bf16_launch_info
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 4)()
    check(fn(rows, n, out) == 0 and out[3] >= 1, f"K1's bf16 route: no CTA fits an SM "
                                                  f"({list(out)})")
    return dict(zip(("threads", "dynamic_smem", "stages", "ctas_per_sm"), list(out)))


def wgmma8_instantiations(logs):
    """Registers, static shared memory and spills of every instantiation of
    the Hopper int8 loop (``csrc/dense_wgmma_int8.cuh``, in K13 and K14) from
    the ``-Xptxas -v`` logs, its dynamic shared memory at K = 1024 and 128,
    and the ptxas lines that report serialized wgmma (C7513, C7520)."""
    rows, serialized = [], []
    for lib in ("dense_gn_silu_int8", "chain_link"):
        log = logs.get(lib, "")
        serialized += [ln.strip() for ln in log.splitlines()
                       if "wgmma" in ln and "serialized" in ln]
        for e in ptxas_entries(log, "wgmma8_kernel"):
            base = re.search(r"(dense_gn_silu_int8|dense_int8_product|chain_link)_wgmma8_kernel",
                             e["entry"]).group(0)
            args = ",".join(re.findall(r"L[ib](\d+)E", e["entry"]))
            rows.append(dict(library=lib, kernel=f"{base}<{args}>", registers=e["registers"],
                             static_smem=e["static_smem"], spills=e["spills"]))
    fn = build.load("dense_gn_silu_int8").dposer_wgmma8_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return rows, {"K1024": fn(1024), "K128": fn(128)}, serialized


def cluster_launch(lib, *args, kernel=None):
    """The cluster kernel ``kernel`` of ``lib`` (default ``lib``: K2
    ``head_em`` and K8 ``head_rk4`` at ``args`` = (B, H), K3
    ``langevin_update``; K7 ``dense_gn_silu_jvp`` at (B, K, N), K9
    ``head_rk4_jvp`` in ``head_rk4`` at (B, H), K11 ``head_dsm`` at (B, H,
    h_bf16)) as it launches on this card: grid CTAs,
    cluster size, threads and dynamic shared memory a CTA, and the clusters
    the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    fn = getattr(build.load(lib), f"dposer_{kernel or lib}_launch_info")
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    check(fn(*args, out) == 0 and out[4] >= 1, f"{lib}: the card holds no cluster ({list(out)})")
    return dict(zip(("grid_ctas", "cluster", "threads", "dynamic_smem", "clusters_resident"),
                    list(out)))


def train_launch(lib, n):
    """K10's Hopper route or K12 (``lib``) at width ``n`` as it launches on
    this card: threads and dynamic shared memory a CTA, its tile rows, and
    the CTAs an SM holds at once."""
    fn = getattr(build.load(lib), f"dposer_{lib}_launch_info")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 4)()
    check(fn(n, out) == 0 and out[3] >= 1, f"{lib}: no CTA fits an SM ({list(out)})")
    return dict(zip(("threads", "dynamic_smem", "tile_rows", "ctas_per_sm"), list(out)))


def k1_pre_instantiations(logs):
    """Registers, static shared memory, spills and CTAs an SM by registers of
    every instantiation of K1's pre route (``dense_gn_silu.cu``'s
    ``pre::dense_gn_silu_kernel``) from the ``-Xptxas -v`` log."""
    rows = []
    for e in ptxas_entries(logs.get("dense_gn_silu", ""), "3pre"):
        args = ",".join(re.findall(r"ILi(\d+)E", e["entry"]))
        rows.append(dict(kernel=f"pre::dense_gn_silu_kernel<{args}>", registers=e["registers"],
                         static_smem=e["static_smem"], spills=e["spills"],
                         ctas_per_sm_by_registers=ctas_per_sm_by_registers(e["registers"], 256)))
    return rows


def k13_pre_instantiations(logs):
    """Registers, static shared memory, spills and CTAs an SM by registers of
    every instantiation of K13's pre route (``dense_gn_silu_int8.cu``'s
    ``pre::dense_gn_silu_int8_kernel``) from the ``-Xptxas -v`` log."""
    rows = []
    for e in ptxas_entries(logs.get("dense_gn_silu_int8", ""), "3pre"):
        args = ",".join(re.findall(r"ILi(\d+)E", e["entry"]))
        rows.append(dict(kernel=f"pre::dense_gn_silu_int8_kernel<{args}>",
                         registers=e["registers"], static_smem=e["static_smem"],
                         spills=e["spills"],
                         ctas_per_sm_by_registers=ctas_per_sm_by_registers(e["registers"], 256)))
    return rows


def ctas_per_sm_by_registers(registers, threads):
    """The CTAs of ``threads`` threads an H100 SM's 65,536 registers hold at
    ``registers`` a thread (allocated in units of 8 a thread)."""
    return 65536 // (-(-registers // 8) * 8 * threads)


def phase_build():
    t0 = time.perf_counter()
    logs = build.build_all()
    for name, log in logs.items():
        print(f"[build] {name}: {build.library_path(name).name}\n{log.strip()}")
    secs = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernels in {secs:.1f}s")
    rows, dyn = wgmma_instantiations(logs)
    for r in rows:
        print(f"[build] wgmma main loop {r['library']}: {r['kernel']} {r['registers']} registers, "
              f"{r['static_smem']} B static smem; {r['spills'] or 'spills not reported'}")
    print(f"[build] wgmma rings: {dyn['wide']} B (wide) and {dyn['narrow']} B (narrow) of dynamic "
          f"shared memory a block; {len(rows)} instantiations"
          + ("" if rows else " (libraries were already built: no ptxas log)"))
    k1_rows, k1_serialized = k1_bf16_instantiations(logs)
    for r in k1_rows:
        print(f"[build] K1 bf16 route: {r['kernel']} {r['registers']} registers, "
              f"{r['static_smem']} B static smem, {r['ctas_per_sm_by_registers']} CTAs an SM by "
              f"registers; {r['spills'] or 'spills not reported'}")
    k1_launch = {rows_: k1_bf16_launch(rows_, H) for rows_ in (B, RC)}
    for rows_, c in k1_launch.items():
        print(f"[build] K1 bf16 route at [{rows_}, {H}]: {c['threads']} threads, "
              f"{c['dynamic_smem']} B dynamic smem a CTA ({c['stages']} stages); "
              f"{c['ctas_per_sm']} CTAs an SM")
    # K1's pre route: at most 128 registers and no spills (two CTAs an SM by
    # registers), one CTA an SM where the grid fits the SMs once, two beyond
    pre_rows = k1_pre_instantiations(logs)
    for r in pre_rows:
        print(f"[build] K1 pre route: {r['kernel']} {r['registers']} registers, "
              f"{r['static_smem']} B static smem, {r['ctas_per_sm_by_registers']} CTAs an SM by "
              f"registers; {r['spills'] or 'spills not reported'}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", r["spills"] or "")
        check(m is not None and m.groups() == ("0", "0") and r["registers"] <= 128,
              f"K1's pre route: {r}")
    pre_launch = {rows_: score_net.dense_gn_silu_pre_launch_info(rows_, H) for rows_ in (B, RC)}
    for rows_, c in pre_launch.items():
        print(f"[build] K1 pre route at [{rows_}, {H}]: {c['threads']} threads, "
              f"{c['static_smem']} B static and {c['dynamic_smem']} B reserved dynamic smem a CTA, "
              f"{c['registers']} registers, {c['local_bytes']} B local a thread; "
              f"{c['ctas_per_sm']} CTAs an SM")
        check(c["local_bytes"] == 0, f"K1's pre route spills at [{rows_}, {H}]: {c}")
    check(pre_launch[B]["ctas_per_sm"] == 1 and pre_launch[RC]["ctas_per_sm"] == 2,
          f"K1's pre route: CTAs an SM {pre_launch}")
    # K13's pre route: the same rule
    for r in k13_pre_instantiations(logs):
        print(f"[build] K13 pre route: {r['kernel']} {r['registers']} registers, "
              f"{r['static_smem']} B static smem, {r['ctas_per_sm_by_registers']} CTAs an SM by "
              f"registers; {r['spills'] or 'spills not reported'}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", r["spills"] or "")
        check(m is not None and m.groups() == ("0", "0") and r["registers"] <= 128,
              f"K13's pre route: {r}")
    pre8 = {rows_: score_net.dense_gn_silu_int8_pre_launch_info(rows_, H) for rows_ in (B, RC)}
    for rows_, c in pre8.items():
        print(f"[build] K13 pre route at [{rows_}, {H}]: {c['threads']} threads, "
              f"{c['static_smem']} B static and {c['dynamic_smem']} B reserved dynamic smem a CTA, "
              f"{c['registers']} registers, {c['local_bytes']} B local a thread; "
              f"{c['ctas_per_sm']} CTAs an SM")
        check(c["local_bytes"] == 0, f"K13's pre route spills at [{rows_}, {H}]: {c}")
    check(pre8[B]["ctas_per_sm"] == 1 and pre8[RC]["ctas_per_sm"] == 2,
          f"K13's pre route: CTAs an SM {pre8}")
    print(f"[build] K1: ptxas lines reporting serialized wgmma: {len(k1_serialized)}"
          + "".join(f"\n    {ln}" for ln in k1_serialized))
    # the bf16 route keeps no operand in registers, so nothing may serialize it
    check(not k1_serialized, "ptxas serialized a wgmma of K1")
    rows8, dyn8, serialized = wgmma8_instantiations(logs)
    for r in rows8:
        print(f"[build] int8 wgmma loop {r['library']}: {r['kernel']} {r['registers']} registers, "
              f"{r['static_smem']} B static smem; {r['spills'] or 'spills not reported'}")
    print(f"[build] int8 wgmma loop: {dyn8['K1024']} B of dynamic shared memory a block at K = "
          f"1024 ({dyn8['K128']} B at K = 128); {len(rows8)} instantiations; ptxas lines "
          f"reporting serialized wgmma: {len(serialized)}"
          + "".join(f"\n    {ln}" for ln in serialized))
    check(not serialized, "ptxas serialized a wgmma of K13 or K14")
    clusters = {}
    # K2 (both instantiations), K3; K6 at the solver's 1,000 rows; K8 at ODE
    # sampling's 500 rows; K11 at the train batch on the bf16 stash (the
    # step's) and on fp32 h
    for key, lib, args in (("head_em", "head_em", (B, H)),
                           ("head_em_impute", "head_em", (B, H)),
                           ("langevin_update", "langevin_update", ()),
                           ("head_adam", "head_adam", (RC, H)),
                           ("head_adam_perturb", "head_adam", (RC, H)),
                           ("head_rk4", "head_rk4", (B, H)),
                           ("head_dsm", "head_dsm", (BT, H, 1)),
                           ("head_dsm fp32 h", "head_dsm", (BT, H, 0))):
        kernel = key.split()[0]
        ptx = [e for e in ptxas_entries(logs.get(lib, ""), f"{kernel}_kernel")
               if lib != "head_dsm" or ("nv_bfloat16" in e["entry"]) == (args[-1] == 1)]
        clusters[key] = dict(cluster_launch(lib, *args, kernel=kernel), ptxas=ptx)
        c = clusters[key]
        print(f"[build] {key} cluster kernel: grid {c['grid_ctas']} CTAs in clusters of "
              f"{c['cluster']}, {c['threads']} threads, {c['dynamic_smem']} B dynamic smem a CTA; "
              f"{c['clusters_resident']} clusters resident at once; "
              + ("; ".join(f"{e['registers']} registers, {e['static_smem']} B static smem, "
                           f"{e['spills'] or 'spills not reported'}" for e in ptx)
                 or "no ptxas log (already built)"))
    # K6 and its perturbing instantiation: no spills, and the CTAs an SM
    # their registers allow (all 252 of a 1,000-row call resident at 2)
    for key in ("head_adam", "head_adam_perturb"):
        c = clusters[key]
        for e in c["ptxas"]:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", e["spills"] or "")
            check(m is not None and m.groups() == ("0", "0"),
                  f"{key}: ptxas reports spills ({e['spills']})")
            e["ctas_per_sm_by_registers"] = ctas_per_sm_by_registers(e["registers"], c["threads"])
            print(f"[build] {key}: {e['registers']} registers, no spills, "
                  f"{e['ctas_per_sm_by_registers']} CTAs an SM by registers; "
                  f"{c['clusters_resident'] * c['cluster']} CTAs resident at once for a grid of "
                  f"{c['grid_ctas']}")
    # the likelihood's kernels: K7's Hopper route and K9 at the likelihood's
    # 50 rows
    jvp_serialized = [ln.strip() for lib in ("dense_gn_silu_jvp", "head_rk4")
                      for ln in logs.get(lib, "").splitlines()
                      if "wgmma" in ln and "serialized" in ln]
    for lib, kernel, word, args in (
            ("dense_gn_silu_jvp", None, "dense_gn_silu_jvp_wgmma_kernel", (BL, H, H)),
            ("head_rk4", "head_rk4_jvp", "head_rk4_jvp_kernel", (BL, H))):
        ptx = ptxas_entries(logs.get(lib, ""), word)
        for e in ptx:
            print(f"[build] {kernel or lib} cluster kernel <cluster "
                  f"{','.join(re.findall(r'ILi(\d+)E', e['entry']))}>: {e['registers']} "
                  f"registers, {e['static_smem']} B static smem; "
                  f"{e['spills'] or 'spills not reported'}")
        c = cluster_launch(lib, *args, kernel=kernel)
        clusters[kernel or lib] = dict(c, ptxas=ptx)
        print(f"[build] {kernel or lib} at {args}: grid {c['grid_ctas']} CTAs in clusters of "
              f"{c['cluster']}, {c['threads']} threads, {c['dynamic_smem']} B dynamic smem a "
              f"CTA; {c['clusters_resident']} clusters resident at once")
    print(f"[build] likelihood kernels: ptxas lines reporting serialized wgmma: "
          f"{len(jvp_serialized)}" + "".join(f"\n    {ln}" for ln in jvp_serialized))
    # a serialized wgmma in K7's loop cost ~40% of it: the design keeps it out
    check(not jvp_serialized, "ptxas serialized a wgmma of K7 or K9")
    # the train step's layer kernels: K10 (both routes) and K12 on
    # dense_wgmma_ss.cuh, at the flagship width
    train_serialized = [ln.strip() for lib in ("dense_gn_silu_train", "dense_gn_silu_bwd")
                        for ln in logs.get(lib, "").splitlines()
                        if "wgmma" in ln and "serialized" in ln]
    train_kernels = {}
    for lib, word in (("dense_gn_silu_train", "dense_gn_silu_train"),
                      ("dense_gn_silu_bwd", "dense_gn_silu_bwd_kernel")):
        ptx = ptxas_entries(logs.get(lib, ""), word)
        for e in ptx:
            kind = re.search(r"(dense_gn_silu_\w+?kernel)I", e["entry"]).group(1)
            print(f"[build] {kind}<{','.join(re.findall(r'L[ib](\d+)E', e['entry']))}>: "
                  f"{e['registers']} registers, {e['static_smem']} B static smem; "
                  f"{e['spills'] or 'spills not reported'}")
        info = train_launch(lib, H)
        train_kernels[lib] = dict(info, ptxas=ptx)
        print(f"[build] {lib} Hopper route at N = {H}: {info['threads']} threads, "
              f"{info['dynamic_smem']} B dynamic smem and {info['tile_rows']} rows a CTA; "
              f"{info['ctas_per_sm']} CTAs an SM")
    print(f"[build] train kernels: ptxas lines reporting serialized wgmma: "
          f"{len(train_serialized)}" + "".join(f"\n    {ln}" for ln in train_serialized))
    check(not train_serialized, "ptxas serialized a wgmma of K10 or K12")
    return secs, dict(instantiations=rows, dynamic_smem=dyn, cluster_kernels=clusters,
                      k1_bf16_instantiations=k1_rows, k1_bf16_launch=k1_launch,
                      k1_pre_instantiations=pre_rows, k1_pre_launch=pre_launch,
                      k1_serialized_wgmma=k1_serialized,
                      int8_instantiations=rows8, int8_dynamic_smem=dyn8,
                      serialized_wgmma=serialized, likelihood_serialized_wgmma=jvp_serialized,
                      train_kernels=train_kernels, train_serialized_wgmma=train_serialized)


def load_pinned(dev):
    model, step = demo.load_model(get_config(), CKPT, dev)
    check(step == 400000, f"pinned checkpoint step {step}")
    return model


def kernel_row_line(r):
    print(f"[kernel] {r['name']}: err {r['max_abs_err']:.3g} ({r['tol']}), "
          f"{r['ms'] * 1e3:.2f} us/launch (eager {r['eager_ms'] * 1e3:.2f}), plain "
          f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us "
          f"({r['bound_by']}), library "
          f"{'-' if r['library_ms'] is None else '%.2f us' % (r['library_ms'] * 1e3)}")


def normal_moments(draws, what):
    zk = torch.cat([d.flatten() for d in draws])
    m = (float(zk.mean()), float(zk.std()), zk.numel())
    check(m[2] >= 100000 and abs(m[0]) < 0.01 and abs(m[1] - 1) < 0.01,
          f"{what} in-kernel normals: mean/std/n {m}")
    return m


def phase_kernels(model, dev):
    """Each kernel against its plain version, with timings and bounds."""
    sde = SubVPSDE(N=1000)
    net, coefs = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    i = 500  # a mid-trajectory step's time rows
    tp, W, gs, gb = net["tp_all"][i], net["W"], net["gn_scale"], net["gn_bias"]
    x = torch.randn(B, D, generator=gen, device=dev)
    rows = []

    # K1 dense_gn_silu: the three layer shapes one network forward runs as
    # network_hidden runs them (the pre layer from fp32 x on the pre route,
    # writing the bf16 copy; a block's first layer from the copy, writing
    # its copy alone; the second with the residual, the fp32 output and the
    # copy), the pre layer and the residual block at completion's 1000 rows
    # (one and two CTAs an SM for the pre route, the deep and the shallow
    # ring of the bf16 route: 128 and 256 CTAs); the pre route's output must
    # equal its own on x and W zero-padded to K = 64 bit for bit, and each
    # copy the output rounded (a block's first layer's the output the same
    # route writes beside it)
    h = score_net.dense_gn_silu_plain(x, W[0], tp[0], gs[0], gb[0])
    h1 = score_net.dense_gn_silu_plain(h, W[1], tp[1], gs[1], gb[1])
    xc = torch.randn(RC, D, generator=torch.Generator(device=dev).manual_seed(1000), device=dev)
    hc = score_net.dense_gn_silu_plain(xc, W[0], tp[0], gs[0], gb[0])
    hc1 = score_net.dense_gn_silu_plain(hc, W[1], tp[1], gs[1], gb[1])
    variants = []
    for label, a, j, res, route in (
            ("pre [500,63]x[63,1024]", x, 0, None, "pre"),
            ("pre/1000 [1000,63]x[63,1024]", xc, 0, None, "pre"),
            ("block [500,1024]x[1024,1024]", h, 1, None, "bf16"),
            ("block+residual [500,1024]x[1024,1024]", h1, 2, h, "bf16"),
            ("block+residual/1000 [1000,1024]x[1024,1024]", hc1, 2, hc, "bf16")):
        args = (a, W[j], tp[j], gs[j], gb[j])
        R, K = a.shape
        ref = score_net.dense_gn_silu_plain(*args, res)
        a_b = a.to(torch.bfloat16) if route == "bf16" else None
        a_in = None if route == "bf16" else a
        # the first layer of a block writes its copy alone; the others also
        # their fp32 output
        write_out = route != "bf16" or res is not None
        o = torch.empty_like(ref) if write_out else None
        o_b = torch.empty(R, H, dtype=torch.bfloat16, device=dev)
        kw = dict(a_b=a_b, out_b=o_b, write_out=write_out)
        fused_em.reset_launch_counts()
        got = score_net.dense_gn_silu(a_in, *args[1:], residual=res, out=o, **kw)
        torch.cuda.synchronize()
        counted = fused_em.route_counts()["dense_gn_silu"]
        want_route = {"bf16": "wgmma_bf16", "pre": "pre_wgmma"}[route]
        check(counted[want_route] == 1, f"dense_gn_silu {label}: routes {counted}")
        same, out = None, got
        if route == "pre":  # the pre route on x and W zero-padded to K = 64
            a64 = torch.zeros(R, 64, device=dev)
            a64[:, :K] = a
            w64 = torch.zeros(64, H, dtype=torch.bfloat16, device=dev)
            w64[:K] = W[j]
            same = bool(torch.equal(got, score_net.dense_gn_silu(a64, w64, *args[2:])))
            check(same, f"dense_gn_silu {label}: not bit-equal to the pre route at K = 64")
        elif not write_out:  # the same route writing the fp32 output beside its copy
            out = score_net.dense_gn_silu(None, *args[1:], residual=res, a_b=a_b)
        torch.cuda.synchronize()
        e = err(out, ref)
        tol = 1e-3 * max(1.0, float(ref.abs().max()))
        check(e <= tol, f"dense_gn_silu {label}: max abs err {e} > {tol}")
        check(torch.equal(o_b, out.to(torch.bfloat16)),
              f"dense_gn_silu {label}: the bf16 copy is not the output rounded")
        # each input byte read once, each output byte written once: A (fp32 or
        # the bf16 copy), W, the three rows, the residual, the fp32 output
        # where written, the bf16 copy
        n_bytes = ((2 if route == "bf16" else 4) * R * K + 2 * K * H + 3 * 4 * H
                   + 4 * R * H * ((res is not None) + write_out) + 2 * R * H)
        bms, by = bound(n_bytes, 2 * R * K * H, 14 * R * H)
        a16 = a.to(torch.bfloat16)

        def launch():
            return score_net.dense_gn_silu(a_in, *args[1:], residual=res, out=o, **kw)

        def library():
            y = torch.matmul(a16, W[j]).float() + tp[j]
            return F.silu(F.group_norm(y, 32, gs[j], gb[j], eps=1e-5))

        variants.append(dict(
            shape=label, route=route, max_abs_err=e, tol=tol, bit_equal=same, ms=graph_ms(launch),
            eager_ms=eager_ms(launch),
            plain_ms=graph_ms(lambda: score_net.dense_gn_silu_plain(*args, res)),
            library_ms=graph_ms(library), bound_ms=bms, bound_by=by))
    main_v = next(v for v in variants if v["shape"].startswith("block+residual [500"))
    rows.append(dict(name="dense_gn_silu", route="cuda", source=f"{CSRC}/dense_gn_silu.cu",
                     replaces=TPU_KERNEL,
                     replaces_part="fused_em.py:58 _make_kernel -> score_net.py:362 fwd "
                                   "(dense, time row, group_norm_vpu, SiLU, h + h2)",
                     max_abs_err=max(v["max_abs_err"] for v in variants),
                     tol="1e-3*max(1,|ref|max)", **{k: main_v[k] for k in (
                         "shape", "ms", "eager_ms", "plain_ms", "library_ms",
                         "bound_ms", "bound_by")}, variants=variants))
    for v in variants:
        print(f"[kernel] dense_gn_silu {v['shape']} ({v['route']}): {v['ms'] * 1e3:.2f} us, "
              f"bound {v['bound_ms'] * 1e3:.2f} us ({v['bound_by']}), plain "
              f"{v['plain_ms'] * 1e3:.2f}, library {v['library_ms'] * 1e3:.2f}")

    # K2 head_em: the EM update and the corrector's score, host normals
    hid = torch.empty(B, H, device=dev)
    score_net.network_hidden(net, x, i, hid, torch.empty_like(hid))
    z = torch.randn(B, D, generator=gen, device=dev)
    wp, bp = net["w_post"], net["b_post"]
    x_ref, xm_ref = fused_em.head_em_plain(hid, wp, bp, coefs, i, "em", D, x=x, noise=z)
    xk, xm = x.clone(), torch.empty_like(x)
    fused_em.head_em(hid, wp, bp, coefs, i, "em", x=xk, x_mean=xm, noise=z)
    s_ref, sq_ref = fused_em.head_em_plain(hid, wp, bp, coefs, i, "score", D)
    score, sq = torch.empty_like(x), torch.empty(B, device=dev)
    fused_em.head_em(hid, wp, bp, coefs, i, "score", score=score, score_sq=sq)
    torch.cuda.synchronize()
    e2 = [err(xk, x_ref), err(xm, xm_ref), err(score, s_ref)]
    tol2 = [1e-3 * max(1.0, float(r.abs().max())) for r in (x_ref, xm_ref, s_ref)]
    check(all(a <= b for a, b in zip(e2, tol2)), f"head_em: errors {e2} > {tol2}")
    sq_e = float(((sq - sq_ref).abs() / sq_ref.abs().clamp(min=1e-6)).max())
    check(sq_e <= 1e-3, f"head_em: row norms relative error {sq_e}")
    # in-kernel normals: with cnoise = 1, x_new - x_mean is the draw, held
    # element by element to the plain Philox stream (philox_normal per element)
    c1 = coefs.clone()
    c1[:, 2] = 1.0
    draws, draw_e = [], 0.0
    for step in range(4):
        xs = x.clone()
        fused_em.head_em(hid, wp, bp, c1, step, "em", x=xs, x_mean=xm, seed=20240917, slab=1)
        draws.append((xs - xm).flatten())
        want = philox.normals_grid(20240917, step, 1, B, D, device=dev)
        draw_e = max(draw_e, err(xs - xm, want))
    check(draw_e <= DRAW_TOL, f"head_em: in-kernel normals off the Philox stream by {draw_e}")
    k2_moments = normal_moments(draws, "head_em")
    # 50 repeated calls give the same bits: the split-K partials are summed
    # through distributed shared memory in a fixed order
    xt, xmt, st_, sqt = x.clone(), torch.empty_like(x), torch.empty_like(x), torch.empty_like(sq)
    runs2 = []
    for _ in range(1 + REPEATS):
        xt.copy_(x)
        fused_em.head_em(hid, wp, bp, coefs, i, "em", x=xt, x_mean=xmt, seed=7, slab=1)
        fused_em.head_em(hid, wp, bp, coefs, i, "score", score=st_, score_sq=sqt)
        runs2.append([t.clone() for t in (xt, xmt, st_, sqt)])
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for run in runs2[1:] for a, b in zip(run, runs2[0])),
          f"head_em: {REPEATS} repeated calls are not bit-identical")
    xt = x.clone()
    n2 = 4 * B * H + 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS + 2 * 4 * B * D + 32
    bms2, by2 = bound(n2, 2 * B * H * D, 110 * B * D)
    bp16, cf = bp.to(torch.bfloat16), coefs[i]

    def head_library():  # composite: bf16 addmm, then the EM update on host normals
        out = torch.addmm(bp16, hid.to(torch.bfloat16), wp)[:, :D].float()
        xm_l = cf[0] * x + cf[1] * out
        return xm_l + cf[2] * z, xm_l

    rows.append(dict(
        name="head_em", route="cuda", source=f"{CSRC}/head_em.cu", replaces=TPU_KERNEL,
        replaces_part="fused_em.py:199-206 (fwd's post-dense, EM update, box_muller); "
                      ":178 (the corrector's score)",
        shape="EM mode, in-kernel normals, [500,1024]x[1024,63]",
        max_abs_err=max(e2), tol="1e-3*max(1,|ref|max)", normals_mean_std_n=k2_moments,
        draws_max_abs_err=draw_e, repeats_bit_identical=REPEATS,
        ms=graph_ms(lambda: fused_em.head_em(hid, wp, bp, coefs, i, "em", x=xt, seed=dseed(7),
                                             slab=1)),
        eager_ms=eager_ms(lambda: fused_em.head_em(hid, wp, bp, coefs, i, "em", x=xt,
                                                   seed=dseed(7), slab=1)),
        plain_ms=graph_ms(lambda: fused_em.head_em_plain(hid, wp, bp, coefs, i, "em", D,
                                                         x=x, noise=z)),
        score_mode_ms=graph_ms(lambda: fused_em.head_em(hid, wp, bp, coefs, i, "score",
                                                        score=score, score_sq=sq)),
        score_mode_eager_ms=eager_ms(lambda: fused_em.head_em(hid, wp, bp, coefs, i, "score",
                                                              score=score, score_sq=sq)),
        library_ms=graph_ms(head_library),
        library="composite: bf16 torch.addmm + the EM update in torch ops, host normals",
        bound_ms=bms2, bound_by=by2))

    # K3 langevin_update, on the score K2 produced
    lc = coefs.clone()
    x3_ref, st_ref = fused_em.langevin_update_plain(x, score, sq, lc, i, 0.16, z)
    x3, st = x.clone(), torch.empty(1, device=dev)
    fused_em.langevin_update(x3, score, sq, lc, i, 0.16, noise=z, step_out=st)
    torch.cuda.synchronize()
    e3, tol3 = err(x3, x3_ref), 1e-4 * max(1.0, float(x3_ref.abs().max()))
    check(e3 <= tol3, f"langevin_update: max abs err {e3} > {tol3}")
    st_e = abs(float(st[0]) / float(st_ref) - 1.0)
    check(st_e <= 1e-4, f"langevin_update: step size relative error {st_e}")
    # in-kernel normals from x = 0, held to the plain Philox stream
    # (philox_normal4: a call a group of four columns)
    draws, draw_e3 = [], 0.0
    for step in range(4):
        x0 = torch.zeros_like(x)
        fused_em.langevin_update(x0, score, sq, lc, i - step, 0.16, seed=99, slab=0,
                                 step_out=st)
        zk = (x0 - st * score) / torch.sqrt(2 * st)
        draws.append(zk.flatten())
        want = philox.normals_grid(99, i - step, 0, B, D, per_group=True, device=dev)
        draw_e3 = max(draw_e3, err(zk, want))
    check(draw_e3 <= DRAW_TOL,
          f"langevin_update: in-kernel normals off the Philox stream by {draw_e3}")
    k3_moments = normal_moments(draws, "langevin_update")
    runs3 = []
    x3t = torch.empty_like(x)
    for _ in range(1 + REPEATS):
        x3t.copy_(x)
        fused_em.langevin_update(x3t, score, sq, lc, i, 0.16, seed=5, step_out=st)
        runs3.append((x3t.clone(), st.clone()))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for run in runs3[1:] for a, b in zip(run, runs3[0])),
          f"langevin_update: {REPEATS} repeated calls are not bit-identical")
    bms3, by3 = bound(3 * 4 * B * D + 4 * B + 32, 0, 220 * B * D)
    xt = x.clone()

    def langevin_library():  # composite: vector_norm, mean and the update in torch ops
        gn = torch.sqrt(sq).mean()
        zn = torch.linalg.vector_norm(z, dim=1).mean()
        st_l = (0.16 * zn / gn) ** 2 * 2 * lc[i, 4]
        return x + st_l * score + torch.sqrt(2 * st_l) * z

    rows.append(dict(
        name="langevin_update", route="cuda", source=f"{CSRC}/langevin_update.cu",
        replaces=TPU_KERNEL, replaces_part="fused_em.py:176-190 (langevin corrector)",
        shape="[500,63], in-kernel normals", max_abs_err=e3, tol="1e-4*max(1,|ref|max)",
        normals_mean_std_n=k3_moments, draws_max_abs_err=draw_e3,
        repeats_bit_identical=REPEATS,
        ms=graph_ms(lambda: fused_em.langevin_update(xt, score, sq, lc, i, 0.16,
                                                     seed=dseed(5))),
        eager_ms=eager_ms(lambda: fused_em.langevin_update(xt, score, sq, lc, i, 0.16,
                                                           seed=dseed(5))),
        plain_ms=graph_ms(lambda: fused_em.langevin_update_plain(x, score, sq, lc, i,
                                                                 0.16, z)),
        library_ms=graph_ms(langevin_library),
        library="composite: torch.linalg.vector_norm + mean + the update in torch ops",
        bound_ms=bms3, bound_by=by3))

    small = chunk_row_checks(net, coefs, lc, x, z, i, dev)
    shard = chunk_row_checks(net, coefs, lc, x, z, i, dev, rows=B // SHARDS)
    for r, s, s2 in zip(rows, small, shard):
        r[f"at_{BM}_rows"], r[f"at_{B // SHARDS}_rows"] = s, s2
    for r in rows:
        kernel_row_line(r)
        for v in r.get("variants", []):
            print(f"    {v['shape']}: err {v['max_abs_err']:.3g}, {v['ms'] * 1e3:.2f} us "
                  f"(eager {v['eager_ms'] * 1e3:.2f}), plain {v['plain_ms'] * 1e3:.2f}, "
                  f"library {v['library_ms'] * 1e3:.2f}, bound {v['bound_ms'] * 1e3:.2f} us")
        if "draws_max_abs_err" in r:
            print(f"    in-kernel normals within {r['draws_max_abs_err']:.3g} of the plain Philox "
                  f"stream; {r['repeats_bit_identical']} repeated calls bit-identical; library "
                  f"is a {r['library']}"
                  + (f"; score mode {r['score_mode_ms'] * 1e3:.2f} us (eager "
                     f"{r['score_mode_eager_ms'] * 1e3:.2f})" if "score_mode_ms" in r else ""))
        for n, what in ((BM, "the metrics protocol's chunk"), (B // SHARDS, "a shard in (p)")):
            print(f"    at {n} rows ({what}): " + "; ".join(
                f"{k} err {v['max_abs_err']:.3g} (tol {v['tol']:.3g}), {v['ms'] * 1e3:.2f} us"
                + (f", score mode {v['score_mode_ms'] * 1e3:.2f} us" if "score_mode_ms" in v
                   else "")
                for k, v in r[f"at_{n}_rows"].items()))
    return rows


def chunk_row_checks(net, coefs, lc, x, z, i, dev, rows=BM):
    """K1, K2 and K3 at ``rows``: the chunked metrics protocol's BM rows
    (``--metrics-chunks 10`` replays every step at that shape), or a shard's
    rows in (p): K1's three layer shapes, K2's EM and score modes, K3's value
    and step size (its norms are reduced over all rows across the cluster,
    split otherwise at fewer rows), each against its plain version on the
    same inputs within phase 3's tolerances, and timed. Returns one dict of
    cases per kernel."""
    tp, W, gs, gb = net["tp_all"][i], net["W"], net["gn_scale"], net["gn_bias"]
    wp, bp = net["w_post"], net["b_post"]
    xs, zs = x[:rows].contiguous(), z[:rows].contiguous()
    hs = score_net.dense_gn_silu_plain(xs, W[0], tp[0], gs[0], gb[0])
    hs1 = score_net.dense_gn_silu_plain(hs, W[1], tp[1], gs[1], gb[1])
    small = [{}, {}, {}]
    for label, a, j, res in (("pre", xs, 0, None), ("block", hs, 1, None),
                             ("block+residual", hs1, 2, hs)):
        args = (a, W[j], tp[j], gs[j], gb[j])
        ref = score_net.dense_gn_silu_plain(*args, res)
        # the K = 1024 layers from the bf16 copy, the pre layer from fp32 x
        kw = dict(a_b=a.to(torch.bfloat16)) if label != "pre" else {}
        out = score_net.dense_gn_silu(*args, residual=res, **kw)
        torch.cuda.synchronize()
        e, tol = err(out, ref), 1e-3 * max(1.0, float(ref.abs().max()))
        check(e <= tol, f"dense_gn_silu {label} at {rows} rows: max abs err {e} > {tol}")
        o = torch.empty_like(ref)
        small[0][label] = dict(max_abs_err=e, tol=tol, ms=graph_ms(
            lambda: score_net.dense_gn_silu(*args, residual=res, out=o, **kw)))
    hid_s = torch.empty(rows, H, device=dev)
    score_net.network_hidden(net, xs, i, hid_s, torch.empty_like(hid_s))
    xs_ref, xms_ref = fused_em.head_em_plain(hid_s, wp, bp, coefs, i, "em", D, x=xs, noise=zs)
    xsk, xms = xs.clone(), torch.empty_like(xs)
    fused_em.head_em(hid_s, wp, bp, coefs, i, "em", x=xsk, x_mean=xms, noise=zs)
    ss_ref, sqs_ref = fused_em.head_em_plain(hid_s, wp, bp, coefs, i, "score", D)
    ss, sqs = torch.empty_like(xs), torch.empty(rows, device=dev)
    fused_em.head_em(hid_s, wp, bp, coefs, i, "score", score=ss, score_sq=sqs)
    torch.cuda.synchronize()
    e2s = [err(xsk, xs_ref), err(xms, xms_ref), err(ss, ss_ref)]
    tol2s = [1e-3 * max(1.0, float(r.abs().max())) for r in (xs_ref, xms_ref, ss_ref)]
    check(all(a <= b for a, b in zip(e2s, tol2s)),
          f"head_em at {rows} rows: errors {e2s} > {tol2s}")
    sqs_e = float(((sqs - sqs_ref).abs() / sqs_ref.abs().clamp(min=1e-6)).max())
    check(sqs_e <= 1e-3, f"head_em at {rows} rows: row norms relative error {sqs_e}")
    xst = xs.clone()
    small[1]["em+score"] = dict(
        max_abs_err=max(e2s), tol=max(tol2s), score_sq_rel_err=sqs_e,
        ms=graph_ms(lambda: fused_em.head_em(hid_s, wp, bp, coefs, i, "em", x=xst,
                                             seed=dseed(7), slab=1)),
        score_mode_ms=graph_ms(lambda: fused_em.head_em(hid_s, wp, bp, coefs, i, "score",
                                                        score=ss, score_sq=sqs)))
    x3s_ref, sts_ref = fused_em.langevin_update_plain(xs, ss, sqs, lc, i, 0.16, zs)
    x3s, sts = xs.clone(), torch.empty(1, device=dev)
    fused_em.langevin_update(x3s, ss, sqs, lc, i, 0.16, noise=zs, step_out=sts)
    torch.cuda.synchronize()
    e3s, tol3s = err(x3s, x3s_ref), 1e-4 * max(1.0, float(x3s_ref.abs().max()))
    check(e3s <= tol3s, f"langevin_update at {rows} rows: max abs err {e3s} > {tol3s}")
    sts_e = abs(float(sts[0]) / float(sts_ref) - 1.0)
    check(sts_e <= 1e-4, f"langevin_update at {rows} rows: step size relative error {sts_e}")
    small[2]["value+step_out"] = dict(
        max_abs_err=e3s, tol=tol3s, step_rel_err=sts_e,
        ms=graph_ms(lambda: fused_em.langevin_update(xst, ss, sqs, lc, i, 0.16,
                                                     seed=dseed(5))))
    return small


def phase_completion_kernels(model, dev, clusters):
    """K4 and K2's imputation mode (at the imputation sampler's 500 rows), K5,
    K6 and K6's perturbing instantiation (at the solver's 1000 rows) against
    their plain versions, with timings and bounds, K2's imputation mode also
    against the unfused K2 -> K4 -> K4 and K6's perturbing instantiation
    against K6 -> K5 bit for bit; K1's three layer shapes timed at 1000 rows
    too, for the solver's device share. ``clusters`` is the build phase's
    launch and ptxas report of the cluster kernels."""
    gen = torch.Generator(device=dev).manual_seed(3)
    sde = SubVPSDE(N=1000)
    net, coefs = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", dev)
    netc, coefc = fused_comp.build_solver_operands(sde, model, 100 * D, 0.1, 2, 100, "3",
                                                   5.0, 900, 1e-3, dev)
    i = 500  # a mid-trajectory step of the sampler
    t = 150  # a second-iteration step of the solver
    x, obs, z = (torch.randn(RC, D, generator=gen, device=dev) for _ in range(3))
    mask = torch.ones(RC, D, device=dev)
    mask[:, :12] = 0.0
    rows = []

    # K4 masked_renoise, at the 500 rows (50 poses x 10 hypotheses) every path
    # that launches it gives it
    x4, obs4, mask4, z4 = (w[:B].contiguous() for w in (x, obs, mask, z))
    ref = fused_em.masked_renoise_plain(x4, obs4, mask4, coefs, i, z4)
    xk = x4.clone()
    fused_em.masked_renoise(xk, obs4, mask4, coefs, i, noise=z4)
    torch.cuda.synchronize()
    e4, tol4 = err(xk, ref), 1e-4 * max(1.0, float(ref.abs().max()))
    check(e4 <= tol4, f"masked_renoise: max abs err {e4} > {tol4}")
    k4_plain_equal = bool(torch.equal(xk, ref))
    c1 = coefs.clone()
    c1[:, 5], c1[:, 6] = 0.0, 1.0  # then the observed dims are the draw
    draws = []
    for step in range(4):
        xs = torch.zeros_like(x4)
        fused_em.masked_renoise(xs, obs4, torch.ones_like(mask4), c1, step, seed=31, slab=2)
        draws.append(xs)
    m4 = normal_moments(draws, "masked_renoise")
    bms, by = bound(4 * 4 * B * D + 32, 0, 116 * B * D)
    xt = x4.clone()
    mc, sd = float(coefs[i, 5]), float(coefs[i, 6])

    def renoise_library():  # composite: the re-noise in torch ops, host normals
        return torch.lerp(x4, torch.add(obs4 * mc, z4, alpha=sd), mask4)

    lib4_e = float((renoise_library() - ref).abs().max())
    rows.append(dict(
        name="masked_renoise", route="cuda", source=f"{CSRC}/pose_elementwise.cu",
        replaces=TPU_KERNEL,
        replaces_part="fused_em.py:192-197, :208-211 (masked re-noise and overwrite "
                      "around the predictor)",
        shape="[500,63], in-kernel normals", max_abs_err=e4, tol="1e-4*max(1,|ref|max)",
        normals_mean_std_n=m4, bit_equal_to_plain=k4_plain_equal,
        ms=graph_ms(lambda: fused_em.masked_renoise(xt, obs4, mask4, coefs, i, seed=dseed(5),
                                                    slab=2)),
        eager_ms=eager_ms(lambda: fused_em.masked_renoise(xt, obs4, mask4, coefs, i,
                                                          seed=dseed(5), slab=2)),
        plain_ms=graph_ms(lambda: fused_em.masked_renoise_plain(x4, obs4, mask4, coefs, i, z4)),
        library_ms=graph_ms(renoise_library), library_max_abs_err=lib4_e,
        library="composite: torch.add + torch.lerp on the mask, host normals",
        bound_ms=bms, bound_by=by))

    # K2's imputation mode at the 500 rows of the imputation sampler: the EM
    # update, the re-noise after it and the next step's before its predictor
    # (corrector-free imputation), against K2 -> K4 -> K4 bit for bit
    hid4 = torch.empty(B, H, device=dev)
    score_net.network_hidden(net, x4, i, hid4, torch.empty_like(hid4))
    wp, bp = net["w_post"], net["b_post"]
    zp, zn = (w[B:2 * B].contiguous() for w in (z, x))
    obsd = (obs4, mask4)
    hk = (hid4, wp, bp, coefs, i)

    def fused(xs, xm=None, host=True, passes=2):
        nz = dict(noise=z4, renoise_noise=(zp, zn)[:passes]) if host else dict(seed=dseed(11))
        fused_em.head_em(*hk, "em", x=xs, x_mean=xm, slab=1, observed=obsd,
                         renoise_next=0 if passes == 2 else None, **nz)

    def unfused(xs, xm=None, host=True):
        fused_em.head_em(*hk, "em", x=xs, x_mean=xm, slab=1,
                         **(dict(noise=z4) if host else dict(seed=dseed(11))))
        for j, (zr, sl) in enumerate(((zp, 2), (zn, 0))):
            fused_em.masked_renoise(xs, *obsd, coefs, i + j, slab=sl,
                                    **(dict(noise=zr) if host else dict(seed=dseed(11))))

    same = {}
    for host in (True, False):
        got, want = [x4.clone(), torch.empty_like(x4)], [x4.clone(), torch.empty_like(x4)]
        fused(*got, host=host)
        unfused(*want, host=host)
        torch.cuda.synchronize()
        same["host" if host else "kernel"] = all(torch.equal(a, b) for a, b in zip(got, want))
    check(all(same.values()), f"head_em imputation: not bit-equal to K2 -> K4 -> K4 ({same})")
    ref = x4.clone()
    ref_m = torch.empty_like(x4)
    fused_em.head_em_plain_into(*hk, "em", x=ref, x_mean=ref_m, noise=z4, slab=1,
                                observed=obsd, renoise_noise=(zp, zn), renoise_next=0)
    got = [x4.clone(), torch.empty_like(x4)]
    fused(*got)
    torch.cuda.synchronize()
    e2i = [err(got[0], ref), err(got[1], ref_m)]
    tol2i = [1e-3 * max(1.0, float(r.abs().max())) for r in (ref, ref_m)]
    check(all(a <= b for a, b in zip(e2i, tol2i)), f"head_em imputation: errors {e2i} > {tol2i}")
    runs = []
    xt = x4.clone()
    for _ in range(1 + REPEATS):
        xt.copy_(x4)
        fused(xt, host=False)
        runs.append(xt.clone())
    torch.cuda.synchronize()
    check(all(torch.equal(r, runs[0]) for r in runs[1:]),
          f"head_em imputation: {REPEATS} repeated calls are not bit-identical")
    n2i = 4 * B * H + 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS + 4 * 4 * B * D + 32
    bms, by = bound(n2i, 2 * B * H * D, 360 * B * D)
    bp16, cf = bp.to(torch.bfloat16), coefs[i]
    (mc0, sd0), (mc1, sd1) = ([float(c) for c in coefs[j, 5:7]] for j in (i, i + 1))

    def impute_library():  # composite: bf16 addmm, the EM update and two re-noises
        out = torch.addmm(bp16, hid4.to(torch.bfloat16), wp)[:, :D].float()
        xn = cf[0] * x4 + cf[1] * out + cf[2] * z4
        xn = torch.lerp(xn, torch.add(obs4 * mc0, zp, alpha=sd0), mask4)
        return torch.lerp(xn, torch.add(obs4 * mc1, zn, alpha=sd1), mask4)

    xt = x4.clone()
    rows.append(dict(
        name="head_em_impute", route="cuda", source=f"{CSRC}/head_em.cu", replaces=TPU_KERNEL,
        replaces_part="fused_em.py:199-206 (fwd's post-dense, EM update), :208-211 (the "
                      "re-noise after it), :192-197 (the next step's re-noise before its "
                      "predictor, no corrector between)",
        shape="EM mode + two re-noises, in-kernel normals, [500,1024]x[1024,63]",
        max_abs_err=max(e2i), tol="1e-3*max(1,|ref|max)", bit_equal_to_unfused=same,
        repeats_bit_identical=REPEATS, launch=cluster_launch("head_em", B, H,
                                                             kernel="head_em_impute"),
        ms=graph_ms(lambda: fused(xt, host=False)),
        eager_ms=eager_ms(lambda: fused(xt, host=False)),
        one_pass_ms=graph_ms(lambda: fused(xt, host=False, passes=1)),
        unfused_ms=graph_ms(lambda: unfused(xt, host=False)),
        unfused_eager_ms=eager_ms(lambda: unfused(xt, host=False)),
        plain_ms=graph_ms(lambda: fused_em.head_em_plain_into(
            *hk, "em", x=xt, noise=z4, slab=1, observed=obsd, renoise_noise=(zp, zn),
            renoise_next=0)),
        library_ms=graph_ms(impute_library),
        library="composite: bf16 torch.addmm + the EM update + two torch.lerp re-noises, "
                "host normals",
        bound_ms=bms, bound_by=by))

    # K5 comp_perturb
    ref = fused_comp.comp_perturb_plain(x, coefc, t, z)
    pert = torch.empty_like(x)
    fused_comp.comp_perturb(x, pert, coefc, t, noise=z)
    torch.cuda.synchronize()
    e5, tol5 = err(pert, ref), 1e-4 * max(1.0, float(ref.abs().max()))
    check(e5 <= tol5, f"comp_perturb: max abs err {e5} > {tol5}")
    # the perturbation rounds each operation on its own, as the torch ops do
    check(torch.equal(pert, ref), "comp_perturb: not bit-equal to its plain version")
    c1 = coefc.clone()
    c1[:, 0], c1[:, 1] = 0.0, 1.0  # then pert is the draw
    draws = []
    for step in range(2):
        fused_comp.comp_perturb(x, pert, c1, step, seed=32)
        draws.append(pert.clone())
    m5 = normal_moments(draws, "comp_perturb")
    bms, by = bound(2 * 4 * RC * D + 32, 0, 113 * RC * D)
    cm, cs = float(coefc[t, 0]), float(coefc[t, 1])

    def perturb_library():  # composite: the perturbation in torch ops, host normals
        return torch.add(x * cm, z, alpha=cs)

    lib5_e = float((perturb_library() - ref).abs().max())
    rows.append(dict(
        name="comp_perturb", route="cuda", source=f"{CSRC}/pose_elementwise.cu",
        replaces=TPU_COMP_KERNEL,
        replaces_part="fused_comp.py:116-117 (box_muller draw and the marginal perturbation)",
        shape="[1000,63], in-kernel normals", max_abs_err=e5, tol="1e-4*max(1,|ref|max)",
        normals_mean_std_n=m5, bit_equal_to_plain=True,
        ms=graph_ms(lambda: fused_comp.comp_perturb(x, pert, coefc, t, seed=dseed(5))),
        eager_ms=eager_ms(lambda: fused_comp.comp_perturb(x, pert, coefc, t, seed=dseed(5))),
        plain_ms=graph_ms(lambda: fused_comp.comp_perturb_plain(x, coefc, t, z)),
        library_ms=graph_ms(perturb_library), library_max_abs_err=lib5_e,
        library="composite: torch.mul + torch.add, host normals",
        bound_ms=bms, bound_by=by))

    # K6 head_adam, on the hidden state of the perturbed poses, mid-solve moments
    fused_comp.comp_perturb(x, pert, coefc, t, noise=z)
    hid = torch.empty(RC, H, device=dev)
    score_net.network_hidden(netc, pert, t, hid, torch.empty_like(hid))
    # moments of the gradient's own size, so that a wrong decay or a dropped
    # g or g*g term shows in them
    g0 = fused_comp.head_adam_plain(hid, netc["w_post"], netc["b_post"], coefc, t, x, pert, obs,
                                    mask, torch.zeros_like(x), torch.zeros_like(x))
    g_abs = float(10.0 * g0[1].abs().mean())  # m1 = 0.1 g from zero moments
    m1 = g_abs * torch.randn(RC, D, generator=gen, device=dev)
    v = g_abs ** 2 * (0.5 + torch.rand(RC, D, generator=gen, device=dev))
    wp, bp = netc["w_post"], netc["b_post"]
    e6, tol6 = [], []
    for paste in (False, True):
        want = fused_comp.head_adam_plain(hid, wp, bp, coefc, t, x, pert, obs, mask, m1, v,
                                          paste)
        got = (x.clone(), m1.clone(), v.clone())
        fused_comp.head_adam(hid, wp, bp, coefc, t, got[0], pert, obs, mask, got[1], got[2],
                             paste)
        torch.cuda.synchronize()
        e6 += [err(g, w) for g, w in zip(got, want)]
        # each output to a thousandth of its own range: m1 and v are far below 1
        tol6 += [1e-3 * max(1.0, float(want[0].abs().max()))]
        tol6 += [1e-3 * float(w.abs().max()) for w in want[1:]]
        if paste:
            check(torch.equal(got[0] * mask, obs * mask), "head_adam: paste is not exact")
    check(all(a <= b for a, b in zip(e6, tol6)), f"head_adam: errors {e6} > {tol6}")
    # 50 repeated calls give the same bits: the partials meet in rank order
    runs6 = []
    for _ in range(1 + REPEATS):
        got = (x.clone(), m1.clone(), v.clone())
        fused_comp.head_adam(hid, wp, bp, coefc, t, got[0], pert, obs, mask, got[1], got[2],
                             True)
        runs6.append(got)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for run in runs6[1:] for a, b in zip(run, runs6[0])),
          f"head_adam: {REPEATS} repeated calls are not bit-identical")
    n6 = 4 * RC * H + 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS + 9 * 4 * RC * D + 32
    bms, by = bound(n6, 2 * RC * H * D, 20 * RC * D)
    xt, mt, vt = x.clone(), m1.clone(), v.clone()
    c6, bp16 = [float(c) for c in coefc[t]], bp.to(torch.bfloat16)

    def adam_library():  # composite: bf16 addmm + the denoise, gradient and Adam in torch ops
        raw = torch.addmm(bp16, hid.to(torch.bfloat16), wp)[:, :D].float()
        x0_hat = torch.add(pert * c6[2], raw, alpha=c6[3])
        g = torch.add(mask * (x - obs) * c6[4], x - x0_hat, alpha=c6[5])
        m1n = torch.lerp(g, m1, fused_comp.ADAM_B1)
        vn = torch.lerp(g * g, v, fused_comp.ADAM_B2)
        return torch.addcdiv(x, m1n, (vn * c6[7]).sqrt_().add_(fused_comp.ADAM_EPS),
                             value=-c6[6]), m1n, vn

    lib6 = adam_library()
    want6 = fused_comp.head_adam_plain(hid, wp, bp, coefc, t, x, pert, obs, mask, m1, v)
    lib6_e = [float((a - b).abs().max()) for a, b in zip(lib6, want6)]
    rows.append(dict(
        name="head_adam", route="cuda", source=f"{CSRC}/head_adam.cu",
        design="head_cluster.cuh Tile<4>: split-K over clusters of 4 CTAs",
        launch=cluster_launch("head_adam", RC, H), repeats_bit_identical=REPEATS,
        replaces=TPU_COMP_KERNEL,
        replaces_part="fused_comp.py:118-127 (fwd's post-dense, one-step denoise, gradient, "
                      "Adam), :131 (paste of the observed dims)",
        shape="[1000,1024]x[1024,63]", max_abs_err=max(e6),
        tol="x 1e-3*max(1,|ref|max); m1, v 1e-3*|ref|max", errs_x_m1_v=e6, tols_x_m1_v=tol6,
        ms=graph_ms(lambda: fused_comp.head_adam(hid, wp, bp, coefc, t, xt, pert, obs, mask,
                                                 mt, vt)),
        eager_ms=eager_ms(lambda: fused_comp.head_adam(hid, wp, bp, coefc, t, xt, pert, obs,
                                                       mask, mt, vt)),
        plain_ms=graph_ms(lambda: fused_comp.head_adam_plain(hid, wp, bp, coefc, t, x, pert,
                                                             obs, mask, m1, v)),
        library_ms=graph_ms(adam_library), library_max_abs_err_x_m1_v=lib6_e,
        library="composite: bf16 torch.addmm + the denoise, gradient and Adam in torch ops",
        bound_ms=bms, bound_by=by))

    # K6's perturbing instantiation: the Adam step, then step t + 1's
    # perturbation of the new x (the solver's steps but its last), against
    # K6 -> K5 bit for bit at 1, 37, 500 and 1,000 rows, host and in-kernel
    # normals
    zn = torch.randn(RC, D, generator=gen, device=dev)  # step t + 1's host normals
    st0 = (x, pert, obs, mask, m1, v)

    def fold(st, host=True, rows=RC):
        nz = dict(noise=zn[:rows]) if host else dict(seed=dseed(13))
        fused_comp.head_adam_perturb(hid[:rows], wp, bp, coefc, t, *st, **nz)

    def unfused(st, host=True, rows=RC):
        nz = dict(noise=zn[:rows]) if host else dict(seed=dseed(13))
        fused_comp.head_adam(hid[:rows], wp, bp, coefc, t, *st)
        fused_comp.comp_perturb(st[0], st[1], coefc, t + 1, **nz)

    same = {}
    for rows_ in (1, 37, 500, RC):
        for host in (True, False):
            got, want = ([w[:rows_].clone() for w in st0] for _ in range(2))
            fold(got, host, rows_)
            unfused(want, host, rows_)
            torch.cuda.synchronize()
            same[f"{rows_} {'host' if host else 'kernel'}"] = all(
                torch.equal(a, b) for a, b in zip(got, want))
    check(all(same.values()), f"head_adam_perturb: not bit-equal to K6 -> K5 ({same})")
    ref = [w.clone() for w in st0]
    fused_comp.head_adam_perturb_plain_into(hid, wp, bp, coefc, t, *ref, noise=zn)
    got = [w.clone() for w in st0]
    fold(got)
    torch.cuda.synchronize()
    # x, m1, v and pert: each to a thousandth of its own range, as K6's
    ef = [err(got[j], ref[j]) for j in (0, 4, 5, 1)]
    tolf = [1e-3 * max(1.0, float(ref[0].abs().max())), 1e-3 * float(ref[4].abs().max()),
            1e-3 * float(ref[5].abs().max()), 1e-3 * max(1.0, float(ref[1].abs().max()))]
    check(all(a <= b for a, b in zip(ef, tolf)), f"head_adam_perturb: errors {ef} > {tolf}")
    runs = []
    for _ in range(1 + REPEATS):
        st = [w.clone() for w in st0]
        fold(st, host=False)
        runs.append(st)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for run in runs[1:] for a, b in zip(run, runs[0])),
          f"head_adam_perturb: {REPEATS} repeated calls are not bit-identical")
    # K6's bytes, the pert write and (host slabs) the normals' read; the draw
    # ~113 fp32 operations an element (as K5's)
    bms, by = bound(n6 + 4 * RC * D, 2 * RC * H * D, (20 + 113) * RC * D)
    bms_host, by_host = bound(n6 + 2 * 4 * RC * D, 2 * RC * H * D, 23 * RC * D)
    cm1, cs1 = float(coefc[t + 1, 0]), float(coefc[t + 1, 1])

    def perturb_adam_library():  # composite: K6's, then the perturbation in torch ops
        xn, m1n, vn = adam_library()
        return torch.add(xn * cm1, zn, alpha=cs1), xn, m1n, vn

    libf = perturb_adam_library()
    wantf = [ref[1], ref[0], ref[4], ref[5]]
    libf_e = [float((a - b).abs().max()) for a, b in zip(libf, wantf)]
    stt = [w.clone() for w in st0]
    ptx = clusters["head_adam_perturb"]["ptxas"]
    rows.append(dict(
        name="head_adam_perturb", route="cuda", source=f"{CSRC}/head_adam.cu",
        design="head_adam.cu's body with the next step's perturbation in the epilogue: "
               "head_cluster.cuh Tile<4>, split-K over clusters of 4 CTAs",
        launch=cluster_launch("head_adam", RC, H, kernel="head_adam_perturb"),
        registers=[e["registers"] for e in ptx], spills=[e["spills"] for e in ptx],
        ctas_per_sm_by_registers=[e.get("ctas_per_sm_by_registers") for e in ptx],
        repeats_bit_identical=REPEATS, bit_equal_to_unfused=same,
        replaces=TPU_COMP_KERNEL,
        replaces_part="fused_comp.py:118-127 (fwd's post-dense, one-step denoise, gradient, "
                      "Adam), :116-117 (the next step's box_muller draw and perturbation)",
        shape="[1000,1024]x[1024,63], in-kernel normals", max_abs_err=max(ef),
        tol="x, pert 1e-3*max(1,|ref|max); m1, v 1e-3*|ref|max", errs_x_m1_v_pert=ef,
        tols_x_m1_v_pert=tolf,
        ms=graph_ms(lambda: fold(stt, host=False)),
        eager_ms=eager_ms(lambda: fused_comp.head_adam_perturb(hid, wp, bp, coefc, t, *stt,
                                                               seed=dseed(13))),
        host_ms=graph_ms(lambda: fold(stt)), host_bound_ms=bms_host, host_bound_by=by_host,
        unfused_ms=graph_ms(lambda: unfused(stt, host=False)),
        unfused_eager_ms=eager_ms(lambda: unfused(stt, host=False)),
        plain_ms=graph_ms(lambda: fused_comp.comp_perturb_plain(
            fused_comp.head_adam_plain(hid, wp, bp, coefc, t, x, pert, obs, mask, m1, v)[0],
            coefc, t + 1, zn)),
        library_ms=graph_ms(perturb_adam_library), library_max_abs_err_pert_x_m1_v=libf_e,
        library="composite: bf16 torch.addmm + the denoise, gradient and Adam in torch ops, "
                "then torch.mul + torch.add, host normals",
        bound_ms=bms, bound_by=by))
    for r in rows:
        kernel_row_line(r)
        if "launch" in r:
            c = r["launch"]
            print(f"    grid {c['grid_ctas']} CTAs in clusters of {c['cluster']}, "
                  f"{c['dynamic_smem']} B dynamic smem a CTA, {c['clusters_resident']} clusters "
                  f"resident at once; {r['repeats_bit_identical']} repeated calls bit-identical")
        if r["name"] == "head_em_impute":
            print(f"    bit-equal to K2 -> K4 -> K4: {r['bit_equal_to_unfused']}; one re-noise "
                  f"{r['one_pass_ms'] * 1e3:.2f} us; unfused K2 + 2 x K4 "
                  f"{r['unfused_ms'] * 1e3:.2f} us (eager {r['unfused_eager_ms'] * 1e3:.2f})")
        if r["name"] == "head_adam_perturb":
            print(f"    bit-equal to K6 -> K5: {r['bit_equal_to_unfused']}; host normals "
                  f"{r['host_ms'] * 1e3:.2f} us (bound {r['host_bound_ms'] * 1e3:.2f}); "
                  f"unfused K6 + K5 {r['unfused_ms'] * 1e3:.2f} us (eager "
                  f"{r['unfused_eager_ms'] * 1e3:.2f}); registers {r['registers']}, CTAs an SM "
                  f"by registers {r['ctas_per_sm_by_registers']}, {r['spills']}")

    # K1 at completion's 1000 rows: checked, and timed for the device shares
    tp, W, gs, gb = netc["tp_all"][t], netc["W"], netc["gn_scale"], netc["gn_bias"]
    h0 = score_net.dense_gn_silu_plain(pert, W[0], tp[0], gs[0], gb[0])
    h1 = score_net.dense_gn_silu_plain(h0, W[1], tp[1], gs[1], gb[1])
    k1_ms = {}
    # as network_hidden runs them: the pre layer from fp32, the block's layers
    # from the bf16 copy (the first writing its copy alone)
    for label, a, j, res in (("pre", pert, 0, None), ("block", h0, 1, None),
                             ("block+residual", h1, 2, h0)):
        args = (a, W[j], tp[j], gs[j], gb[j])
        ref = score_net.dense_gn_silu_plain(*args, res)
        o_b = torch.empty(ref.shape, dtype=torch.bfloat16, device=dev)
        o = None if label == "block" else torch.empty_like(ref)
        kw = dict(out_b=o_b, write_out=o is not None)
        if label != "pre":
            a, kw["a_b"] = None, a.to(torch.bfloat16)
        score_net.dense_gn_silu(a, *args[1:], residual=res, out=o, **kw)
        torch.cuda.synchronize()
        out = o_b.float() if o is None else o
        e, tol = err(out, ref), (1e-2 if o is None else 1e-3) * max(1.0, float(ref.abs().max()))
        check(e <= tol, f"dense_gn_silu {label} at {RC} rows: max abs err {e} > {tol}")
        k1_ms[label] = graph_ms(lambda: score_net.dense_gn_silu(a, *args[1:], residual=res,
                                                                out=o, **kw))
    print(f"[kernel] dense_gn_silu at {RC} rows: " + ", ".join(
        f"{k} {v * 1e3:.2f} us" for k, v in k1_ms.items()))
    return rows, k1_ms


def phase_completion_parity(model, dev):
    """The kernel completion solver against its plain loop, and the
    imputation sampler step by step against the plain versions.

    The Adam loop is contractive (it pulls toward the data term), so the
    free-running solvers are held pointwise to 5e-3*max(1, |ref|max), the
    bound the JAX package holds its kernel to its XLA solver with; the
    observed dims must be pasted exactly. The 20-step imputation sampler
    starts each step from the plain trajectory's state (2e-2*max(1, |ref|),
    as the generation sampler); its observed dims, which pass through no
    network, must agree to 1e-5 after every imputation."""
    sde = SubVPSDE(N=1000)
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for rows, n_elems, iters, spi in ((6, 6 * D, 2, 8), (RC, RC // HYPO * D, 2, 100)):
        obs = 0.5 * torch.randn(rows, D, generator=gen, device=dev)
        mask = torch.ones(rows, D, device=dev)
        mask[:, :12] = 0.0
        noise = torch.randn(iters * spi, rows, D, generator=gen, device=dev)
        kw = dict(iterations=iters, steps_per_iter=spi, time_strategy="3", device=dev)
        ref = fused_comp.get_cuda_comp_solver(sde, model, (rows, D), n_elems, plain=True,
                                              **kw)(None, obs, mask, noise=noise)
        got = fused_comp.get_cuda_comp_solver(sde, model, (rows, D), n_elems, **kw)(
            None, obs, mask, noise=noise)
        torch.cuda.synchronize()
        e, tol = err(got, ref), 5e-3 * max(1.0, float(ref.abs().max()))
        check(e <= tol, f"solver parity at {rows} rows x {iters}x{spi}: {e} > {tol}")
        check(torch.equal(got * mask, obs * mask), f"solver at {rows} rows: observed dims "
                                                   f"are not pasted exactly")
        moved = float((got - obs).abs().max())
        check(moved > 0.1, f"solver at {rows} rows moved nothing ({moved})")
        out[f"solver_{rows}x{iters * spi}"] = dict(max_abs_err=e, tol=tol,
                                                   max_move_from_observation=moved)
        print(f"[parity] solver {rows} rows x {iters}x{spi} steps: max abs err {e:.3g} "
              f"(tol {tol:.3g}), paste exact")

    n, shape = 20, (B, D)
    z = torch.randn(shape, generator=gen, device=dev)
    noise = torch.randn((n, 4) + shape, generator=gen, device=dev)
    obs = 0.5 * torch.randn(shape, generator=gen, device=dev)
    mask = torch.ones(shape, device=dev)
    mask[:, :12] = 0.0
    sde = SubVPSDE(N=n)
    net, coefs = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", dev)
    for corrector, nz in (("none", noise[:, 1:].contiguous()), ("langevin", noise)):
        n_corr = 1 if corrector == "langevin" else 0
        kw = dict(n_corr=n_corr, snr=0.16, observed=(obs, mask))
        sk, sp = (fused_em.pc_scratch(net, B, n_corr, dev) for _ in range(2))
        xp, step_err, step_tol, obs_err = z.clone(), 0.0, 0.0, 0.0
        for i in range(n):
            xk = xp.clone()
            fused_em.pc_step(net, coefs, i, xk, sk, nz[i], **kw)
            fused_em.pc_step(net, coefs, i, xp, sp, nz[i], plain=True, **kw)
            step_err = max(step_err, err(xk, xp))
            step_tol = max(step_tol, 2e-2 * max(1.0, float(xp.abs().max())))
            obs_err = max(obs_err, float(((xk - xp) * mask).abs().max()))
        check(step_err <= step_tol,
              f"imputation step parity ({corrector}): {step_err} > {step_tol}")
        check(obs_err <= 1e-5, f"imputation ({corrector}): observed dims differ by {obs_err}")
        # after the last imputation the observed dims are the re-noised observation
        want = coefs[n - 1, 5] * obs + coefs[n - 1, 6] * nz[n - 1, -1]
        last = float(((xk - want) * mask).abs().max())
        check(last <= 1e-5, f"imputation ({corrector}): last overwrite off by {last}")
        run = [fused_em.get_cuda_em_sampler(sde, model, shape, corrector=corrector,
                                            imputation=True, device=dev, plain=plain)(
            observation=obs, mask=mask, z=z, noise=nz) for plain in (True, False)]
        torch.cuda.synchronize()
        tol = 2e-2 * max(1.0, float(run[0].abs().max()))
        frac = float(((run[1] - run[0]).abs().amax(1) <= tol).float().mean())
        check(torch.isfinite(run[1]).all().item() and frac >= 0.90,
              f"imputation sampler ({corrector}): {frac:.3f} of rows within {tol}")
        out[f"imputation_{corrector}"] = dict(step_max_abs_err=step_err, step_tol=step_tol,
                                              observed_dims_max_abs_err=obs_err,
                                              rows_within_tol=frac, tol=tol)
        print(f"[parity] imputation corrector={corrector}: step err {step_err:.3g} "
              f"(tol {step_tol:.3g}), observed dims {obs_err:.3g}, free-running rows "
              f"within tol {frac:.3f}")
    return out


def load_benchmark(name):
    """``benchmarks/<name>.py`` loaded by path (numpy only)."""
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))  # its sibling imports
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synthetic_poses(n):
    """``n`` test draws of the synthetic AMASS mixture the pinned checkpoint
    was trained on (benchmarks/gen_synth_amass.py; numpy only)."""
    mod = load_benchmark("gen_synth_amass")
    centers, w, basis = mod.make_mixture(np.random.default_rng(0))
    return mod.sample_poses(np.random.default_rng(123), n, centers, w, basis)


def check_bands(what, mpjpe, mpvpe):
    check(MPJPE_BAND[0] < mpjpe < MPJPE_BAND[1], f"{what}: MPJPE {mpjpe} outside {MPJPE_BAND}")
    check(MPVPE_BAND[0] < mpvpe < MPVPE_BAND[1], f"{what}: MPVPE {mpvpe} outside {MPVPE_BAND}")


def phase_completion_protocols(model, dev):
    os.makedirs(OUT, exist_ok=True)
    smplx, _ = make_synthetic_body_model(os.path.join(OUT, "smplx_fixture.npz"), "smplx")
    poses = synthetic_poses(100)
    poses_file = os.path.join(OUT, "synth_poses.npz")
    np.savez(poses_file, pose_samples=poses)
    by_run, res = {}, {}

    # (c) the solver: 100 poses x 10 hypotheses, 2x100 steps, strategy '3'
    config = get_config()
    sde = SubVPSDE(N=1000)
    normalizer = PoseNormalizer(STATS, normalize=config.data.normalize,
                                min_max=config.data.min_max, rot_rep=config.data.rot_rep,
                                device=dev)
    gts = torch.as_tensor(poses, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    mask, obs = create_mask(normalizer.offline_normalize(gts, from_axis=True), part=PART,
                            generator=gen)
    comp = DPoserComp(sde, model=model, time_strategy="3", backend="cuda", device=dev)
    walls, hypos = timed_calls(lambda: comp.optimize_hypos(obs, mask, HYPO, gen))
    by_run["solver_100x10_2x100"] = fused_em.launch_counts()
    c = by_run["solver_100x10_2x100"]
    per_solve = {k: c[k] for k in ("comp_perturb", "dense_gn_silu", "head_adam_perturb",
                                   "head_adam")}
    print(f"[completion] solver launches a solve: {per_solve}")
    # K5 at the first step; K6 perturbs for every later one but pastes at the last
    check(per_solve == dict(comp_perturb=1, dense_gn_silu=1000, head_adam_perturb=199,
                            head_adam=1), f"solver: launches a solve {per_solve}")
    # a forward: the pre layer on the pre route, four layers on the bf16 copy
    k1_routes = fused_em.route_counts()["dense_gn_silu"]
    print(f"[completion] K1's routes a solve: {k1_routes}")
    check(k1_routes == dict(wgmma_bf16=800, pre_wgmma=200),
          f"solver: K1's routes a solve {k1_routes}")
    check(hypos.shape == (100, HYPO, D) and torch.isfinite(hypos).all().item(), "solver output")
    check(torch.equal(hypos * mask[:, None], (obs * mask)[:, None].expand_as(hypos)),
          "solver: observed dims are not pasted exactly")
    body = BodyModel(smplx, num_betas=10, model_type="smplx", device=dev)
    ev = Evaler(body, part=PART).multi_eval_bodys(
        normalizer.offline_denormalize(hypos, to_axis=True), gts)
    mpjpe, mpvpe = float(np.mean(ev["mpjpe_body"])), float(np.mean(ev["mpvpe_all"]))
    check_bands("solver", mpjpe, mpvpe)
    wall = min(walls[1:])  # the first call is the warm-up
    res["solver"] = dict(solves_per_s=100 * HYPO / wall, poses_per_s=100 / wall, wall_s=wall,
                         walls_s=walls, rows=100 * HYPO, steps=200, mpjpe_mm=mpjpe,
                         mpvpe_mm=mpvpe, launches=by_run["solver_100x10_2x100"])
    print(f"[completion] solver 100 poses x {HYPO} hypotheses x 200 steps: "
          f"{100 * HYPO / wall:.1f} solves/s ({wall * 1e3:.1f} ms per call; calls "
          f"{['%.3f' % w for w in walls]} s), MPJPE {mpjpe:.1f} mm, MPVPE {mpvpe:.1f} mm")
    eager = fused_comp.get_cuda_comp_solver(
        sde, model, (100 * HYPO, D), 100 * D, lr=comp.lr, iterations=comp.iterations,
        steps_per_iter=comp.steps_per_iter, time_strategy="3", sample_trun=comp.sample_trun,
        sample_time=comp.sample_time, rng_mode="kernel", device=dev, loop="eager")
    (graphed,) = comp.cuda_solvers()
    eager_twin(res["solver"], graphed,
               lambda: eager(gen, obs.repeat(HYPO, 1), mask.repeat(HYPO, 1)))

    # (d) the demo's completion tasks, 50 poses x 10 hypotheses
    for name, extra in (("completion", []),
                        ("completion2_pc", ["--sampler", "pc"]),
                        ("completion2_ddim", ["--sampler", "ddim"]),
                        ("completion2_hybrid", ["--sampler", "hybrid"])):
        args = demo.parse_args(["--task", name.split("_")[0], *extra, "--device", "cuda",
                                "--ckpt-path", CKPT, "--stats-dir", STATS,
                                "--bodymodel-path", smplx, "--file-path", poses_file,
                                "--part", PART, "--hypo", str(HYPO),
                                "--output-path", os.path.join(OUT, name), "--seed", "42"])
        fused_em.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = demo.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_run[f"demo_{name}"] = fused_em.launch_counts()
        with np.load(r["hypotheses_file"]) as f:
            hy = f["pose_hypotheses"]
        check(hy.shape == (50, HYPO, D) and np.isfinite(hy).all(), f"demo {name} hypotheses")
        check_bands(f"demo {name}", r["mpjpe"], r["mpvpe"])
        # the task's renders (host C++ and cv2) are timed apart: (r) measures them
        res[name] = dict(mpjpe_mm=r["mpjpe"], mpvpe_mm=r["mpvpe"],
                         task_wall_s=wall - r["render_s"], render_s=r["render_s"],
                         launches=by_run[f"demo_{name}"])
        print(f"[completion] demo {name}: MPJPE {r['mpjpe']:.1f} mm, MPVPE {r['mpvpe']:.1f} mm, "
              f"task wall {wall - r['render_s']:.2f} s (load, build, sample, evaluate; its "
              f"renders {r['render_s']:.2f} s apart), launches {by_run[f'demo_{name}']}")
        if name.startswith("completion2"):
            c = by_run[f"demo_{name}"]
            print(f"[completion] demo {name} a call: K4 masked_renoise {c['masked_renoise']}, "
                  f"K2 head_em {c['head_em']} and its imputation mode {c['head_em_impute']}")
            # corrector-free imputation: K2 re-noises for the next step, K4
            # only at the sampler's first
            if name in ("completion2_pc", "completion2_ddim"):
                check(c["masked_renoise"] == 1 and c["head_em_impute"] > 1,
                      f"demo {name}: K4 launched {c['masked_renoise']} times, not once")
    return dict(results=res, by_run=by_run)


def phase_completion_cli(dev):
    """(o) ``python -m dposer_tpu_torch.completion``'s ``run`` over a synthetic
    AMASS test split: ``benchmarks/gen_synth_amass.py``'s mixture at seed 0,
    5,000 test poses, the pinned checkpoint's statistics, 100 poses x 10
    hypotheses a batch, left leg, the synthetic SMPL-X body. MPJPE and MPVPE
    in the bands, each batch's launches those of a 5c solve, one graph
    captured for the whole split."""
    mod = load_benchmark("gen_synth_amass")
    rng = np.random.default_rng(0)
    centers, w, basis = mod.make_mixture(rng)
    root = os.path.join(OUT, "amass_synth")
    test_dir = os.path.join(root, "version1", "test")
    os.makedirs(test_dir, exist_ok=True)
    np.save(os.path.join(test_dir, "pose_body.npy"),
            mod.sample_poses(rng, 5000, centers, w, basis))
    smplx, _ = make_synthetic_body_model(os.path.join(OUT, "smplx_fixture.npz"), "smplx")
    args = completion_cli.parse_args([
        "--device", "cuda", "--ckpt-path", CKPT, "--stats-dir", STATS, "--dataset-folder",
        root, "--version", "version1", "--bodymodel-path", smplx, "--batch_size", "100",
        "--hypo", str(HYPO), "--part", PART, "--seed", "42"])
    fused_em.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = completion_cli.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fused_em.launch_counts()
    n = r["n_batches"]
    check(n == 50 and r["mpjpe_body"].shape == (5000,), f"split: {n} batches")
    per_batch = {k: counts[k] / n for k in ("comp_perturb", "dense_gn_silu",
                                            "head_adam_perturb", "head_adam")}
    print(f"[completion cli] launches a batch: {per_batch}")
    check(per_batch == dict(comp_perturb=1, dense_gn_silu=1000, head_adam_perturb=199,
                            head_adam=1), f"completion cli: launches a batch {per_batch}")
    captured = [lp for lp in r["loops"] if lp.capture_s is not None]
    check(len(r["loops"]) == 1 and len(captured) == 1,
          f"completion cli: {len(captured)} graphs captured over {len(r['loops'])} loops")
    mpjpe, mpvpe = float(np.mean(r["mpjpe_body"])), float(np.mean(r["mpvpe_all"]))
    check_bands("completion cli", mpjpe, mpvpe)
    walls = r["batch_walls_s"]
    steady = float(np.median(walls[1:]))
    lp = captured[0]
    res = dict(mpjpe_mm=mpjpe, mpvpe_mm=mpvpe, batches=n, rows_per_batch=100 * HYPO,
               wall_s=r["wall_s"], run_wall_s=wall, first_batch_s=walls[0],
               steady_batch_median_s=steady, batch_walls_s=walls,
               row_solves_per_s=n * 100 * HYPO / r["wall_s"],
               poses_per_s=n * 100 / r["wall_s"],
               steady_row_solves_per_s=100 * HYPO / steady, launches=counts,
               graph=dict(warmup_s=lp.warmup_s, capture_s=lp.capture_s,
                          instantiate_s=lp.instantiate_s))
    print(f"[completion cli] {n} batches x {100 * HYPO} rows: MPJPE {mpjpe:.1f} mm, MPVPE "
          f"{mpvpe:.1f} mm; {res['row_solves_per_s']:.1f} row-solves/s, "
          f"{res['poses_per_s']:.1f} poses/s over the split ({r['wall_s']:.3f} s of batches, "
          f"{wall:.3f} s with loading); first batch {walls[0] * 1e3:.1f} ms (warm-up "
          f"{lp.warmup_s * 1e3:.1f}, capture {lp.capture_s * 1e3:.1f}, instantiate "
          f"{lp.instantiate_s * 1e3:.1f}), steady median {steady * 1e3:.2f} ms "
          f"({res['steady_row_solves_per_s']:.1f} row-solves/s)")
    return dict(results=res, by_run=dict(completion_cli_split=counts))


def phase_ode_kernels(model, dev):
    """K7 (at the likelihood's 50 rows), K8 (at PF-ODE sampling's 500 rows, each
    stage and the denoise) and K9 (50 rows) against their plain versions, with
    timings and bounds."""
    sde = SubVPSDE(N=1000)
    gen = torch.Generator(device=dev).manual_seed(6)
    netl, coefl = fused_ode.build_rk4_operands(sde, model, LIK_EPS, sde.T, LIK_STEPS, dev)
    neto, coefo = fused_ode.build_rk4_operands(sde, model, sde.T, 1e-3, ODE_STEPS, dev,
                                               denoise_eps=1e-3)
    j = LIK_STEPS  # a mid-trajectory row of the stage grid
    tp, W, gs, gb = netl["tp_all"][j], netl["W"], netl["gn_scale"], netl["gn_bias"]
    x = 0.5 * torch.randn(BL, D, generator=gen, device=dev)
    eps = tlik.draw_epsilon("Rademacher", (BL, D), gen, dev)
    rows = []

    # K7 dense_gn_silu_jvp: the three layer shapes one forward-with-tangent
    # runs, on the routes the likelihood takes (the pre layer on the register
    # route, writing the bf16 copies; the K = 1024 layers on the Hopper route
    # from the copies the layer before wrote), then the K = 1024 layers on
    # the register route (the route before the handoff: timed beside)
    bf = torch.bfloat16
    h, dh = score_net.dense_gn_silu_jvp_plain(x, eps, W[0], tp[0], gs[0], gb[0])
    h1, dh1 = score_net.dense_gn_silu_jvp_plain(h, dh, W[1], tp[1], gs[1], gb[1])
    copies = {id(t): t.to(bf) for t in (h, dh, h1, dh1)}
    variants = []
    for key, label, a, da, k, res, route in (
            ("pre", "pre [50,63]x[63,1024]", x, eps, 0, (None, None), "register"),
            ("block", "block [50,1024]x[1024,1024]", h, dh, 1, (None, None), "wgmma"),
            ("block+residual", "block+residual [50,1024]x[1024,1024]", h1, dh1, 2, (h, dh),
             "wgmma"),
            ("register block", "block, register route", h, dh, 1, (None, None), "register"),
            ("register block+residual", "block+residual, register route", h1, dh1, 2, (h, dh),
             "register")):
        args = (a, da, W[k], tp[k], gs[k], gb[k])
        ref = score_net.dense_gn_silu_jvp_plain(*args, *res)
        o, do = torch.empty_like(ref[0]), torch.empty_like(ref[0])
        ob, dob = torch.empty_like(ref[0], dtype=bf), torch.empty_like(ref[0], dtype=bf)
        kw = dict(residual=res[0], dresidual=res[1], out=o, dout=do, out_b=ob, dout_b=dob)
        kargs, cluster = args, None
        if route == "wgmma":
            kw.update(a_b=copies[id(a)], da_b=copies[id(da)])
            kargs, cluster = (None, None) + args[2:], score_net.jvp_cluster(a.shape[1])
        fused_em.reset_launch_counts()
        score_net.dense_gn_silu_jvp(*kargs, **kw)
        torch.cuda.synchronize()
        check(fused_em.route_counts()["dense_gn_silu_jvp"][route] == 1,
              f"dense_gn_silu_jvp {label}: not on the {route} route")
        e = [err(o, ref[0]), err(do, ref[1])]
        tol = [1e-3 * max(1.0, float(r.abs().max())) for r in ref]
        check(all(a_ <= b_ for a_, b_ in zip(e, tol)),
              f"dense_gn_silu_jvp {label}: max abs err (out, dout) {e} > {tol}")
        check(torch.equal(ob, o.to(bf)) and torch.equal(dob, do.to(bf)),
              f"dense_gn_silu_jvp {label}: the bf16 copies are not the outputs rounded")
        K, with_res = a.shape[1], res[0] is not None
        a_bytes = 2 * (2 if route == "wgmma" else 4) * BL * K
        rest = 2 * K * H + 3 * 4 * H + 2 * 4 * BL * H * (2 if with_res else 1)
        bms, by = bound(a_bytes + rest + 2 * 2 * BL * H, 2 * 2 * BL * K * H, 40 * BL * H)
        bms_old, _ = bound(2 * 4 * BL * K + rest, 2 * 2 * BL * K * H, 40 * BL * H)
        r0, r1 = res if with_res else (torch.zeros_like(o), torch.zeros_like(o))

        def lib_layer(av, rv, k=k):
            y = torch.matmul(av.to(torch.bfloat16), W[k]).float() + tp[k]
            return F.silu(F.group_norm(y, 32, gs[k], gb[k], eps=1e-5)) + rv

        def library(a=a, da=da, r0=r0, r1=r1, lib_layer=lib_layer):
            return torch.func.jvp(lib_layer, (a, r0), (da, r1))

        lib = library()
        torch.cuda.synchronize()
        # the yardstick rounds its matmul output to bf16: same function, fewer digits
        check(err(lib[1], ref[1]) <= 50 * tol[1], f"dense_gn_silu_jvp {label}: the library "
                                                  f"composite computes another tangent")
        run = lambda kargs=kargs, kw=kw: score_net.dense_gn_silu_jvp(*kargs, **kw)  # noqa: E731
        v = dict(key=key, shape=label, route=route, cluster=cluster, max_abs_err=max(e),
                 errs_out_dout=e, tols_out_dout=tol, ms=graph_ms(run), eager_ms=eager_ms(run),
                 bound_ms=bms, bound_by=by, bound_ms_at_fp32_a_no_copies=bms_old)
        if key in ("pre", "block", "block+residual"):
            v.update(plain_ms=graph_ms(lambda args=args, res=res:
                                       score_net.dense_gn_silu_jvp_plain(*args, *res)),
                     library_ms=graph_ms(library))
        if route == "wgmma" and key == "block+residual":
            # 50 repeated calls give the same bits: the split-K partials are
            # summed in rank order in the finishing CTA
            runs7 = []
            for _ in range(1 + REPEATS):
                run()
                runs7.append((o.clone(), do.clone()))
            torch.cuda.synchronize()
            check(all(torch.equal(p_, q_) for r_ in runs7[1:] for p_, q_ in zip(r_, runs7[0])),
                  f"dense_gn_silu_jvp {label}: {REPEATS} repeated calls are not bit-identical")
            v["repeats_bit_identical"] = REPEATS
        variants.append(v)
        print(f"[kernel] dense_gn_silu_jvp {label} ({route}"
              + (f", clusters of {cluster}" if cluster else "") + f"): {v['ms'] * 1e3:.2f} us "
              f"(eager {v['eager_ms'] * 1e3:.2f}), bound {bms * 1e3:.2f} us ({bms_old * 1e3:.2f} "
              f"at fp32 A without copies), err {max(e):.3g}")
    by_key = {v["key"]: v for v in variants}
    main_v = by_key["block+residual"]
    rows.append(dict(name="dense_gn_silu_jvp", route="cuda",
                     source=f"{CSRC}/dense_gn_silu_jvp.cu", replaces=TPU_LIK_KERNEL,
                     replaces_part="fused_lik.py:41 _make_kernel -> score_net.py:388 "
                                   "bind_fwd_jvp (mm, gnorm_jvp, silu_jvp, h + h2 and dh + dh2)",
                     max_abs_err=max(v["max_abs_err"] for v in variants),
                     tol="out 1e-3*max(1,|ref|max); dout 1e-3*max(1,|dref|max)",
                     repeats_bit_identical=REPEATS,
                     **{k: main_v[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by",
                                               "bound_ms_at_fp32_a_no_copies")},
                     variants=variants))

    # K8 head_rk4: every stage and the denoise, on a forward's hidden state
    jo = ODE_STEPS
    xo = torch.randn(B, D, generator=gen, device=dev)
    xs = xo + 0.01 * torch.randn(B, D, generator=gen, device=dev)
    acc = torch.randn(B, D, generator=gen, device=dev)
    hid = torch.empty(B, H, device=dev)
    score_net.network_hidden(neto, xs, jo, hid, torch.empty_like(hid))
    wp, bp = neto["w_post"], neto["b_post"]
    e8, tol8 = [], []
    for stage in (0, 1, 2, 3, fused_ode.DENOISE):
        want = fused_ode.head_rk4_plain(hid, wp, bp, coefo, jo, stage, xo, xs, acc)
        got = (xo.clone(), xs.clone(), acc.clone())
        fused_ode.head_rk4(hid, wp, bp, coefo, jo, stage, *got)
        torch.cuda.synchronize()
        e8 += [err(g, w) for g, w in zip(got, want)]
        tol8 += [1e-3 * max(1.0, float(w.abs().max())) for w in want]
    check(all(a_ <= b_ for a_, b_ in zip(e8, tol8)), f"head_rk4: errors {e8} > {tol8}")
    # 50 repeated calls bit-identical, at stage 1 and the denoise (the
    # partials summed in rank order in the finishing CTA)
    for stage in (1, fused_ode.DENOISE):
        st8 = [torch.empty_like(t) for t in (xo, xs, acc)]

        def call8(stage=stage, st8=st8):
            for t, src in zip(st8, (xo, xs, acc)):
                t.copy_(src)
            fused_ode.head_rk4(hid, wp, bp, coefo, jo, stage, *st8)
            return st8

        repeats_bit_identical(call8, call8(), f"head_rk4 stage {stage}")
    n8 = 4 * B * H + 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS + 5 * 4 * B * D + 32
    bms, by = bound(n8, 2 * B * H * D, 12 * B * D)
    st = (xo.clone(), xs.clone(), acc.clone())
    run8 = lambda stage=1: fused_ode.head_rk4(hid, wp, bp, coefo, jo, stage, *st)  # noqa: E731
    c8, bp16 = [float(c) for c in coefo[jo]], bp.to(torch.bfloat16)

    def rk4_library():  # composite: bf16 addmm + the RK4 stage-1 update in torch ops
        out = torch.addmm(bp16, hid.to(torch.bfloat16), wp)[:, :D].float()
        k = torch.add(xs * c8[0], out, alpha=c8[1])
        return xo, torch.add(xo, k, alpha=0.5 * c8[2]), torch.add(acc, k, alpha=2.0)

    want8 = fused_ode.head_rk4_plain(hid, wp, bp, coefo, jo, 1, xo, xs, acc)
    lib8_e = max(float((a - b).abs().max()) for a, b in zip(rk4_library(), want8))
    rows.append(dict(
        name="head_rk4", route="cuda", source=f"{CSRC}/head_rk4.cu", replaces=TPU_ODE_KERNEL,
        replaces_part="fused_ode.py:87-96 (fwd's post-dense and the RK4 step), :101-107 "
                      "(the final denoise)",
        shape="stage 1, [500,1024]x[1024,63]", max_abs_err=max(e8),
        tol="1e-3*max(1,|ref|max), stages 0-3 and the denoise", errs=e8, tols=tol8,
        ms=graph_ms(run8), eager_ms=eager_ms(run8),
        plain_ms=graph_ms(lambda: fused_ode.head_rk4_plain(hid, wp, bp, coefo, jo, 1, xo, xs,
                                                           acc)),
        denoise_ms=graph_ms(lambda: run8(fused_ode.DENOISE)),
        cluster=cluster_launch("head_rk4", B, H)["cluster"], repeats_bit_identical=REPEATS,
        library_ms=graph_ms(rk4_library), library_max_abs_err=lib8_e,
        library="composite: bf16 torch.addmm + the RK4 stage update in torch ops",
        bound_ms=bms, bound_by=by))
    print(f"[kernel] head_rk4: clusters of {rows[-1]['cluster']} {rows[-1]['ms'] * 1e3:.2f} us "
          f"(denoise {rows[-1]['denoise_ms'] * 1e3:.2f}); {REPEATS} repeated calls bit-identical")

    # K9 head_rk4_jvp, on the hidden state and tangent of the 50 rows
    bufs = score_net.hidden_jvp_buffers(netl, BL, dev)
    hl, dhl = score_net.network_hidden_jvp(netl, x, eps, j, bufs)
    xl, xsl, accl = x, x + 0.01 * torch.randn(BL, D, generator=gen, device=dev), \
        torch.randn(BL, D, generator=gen, device=dev)
    lp, lacc = (torch.randn(BL, generator=gen, device=dev) for _ in range(2))
    wpl, bpl = netl["w_post"], netl["b_post"]
    e9, tol9 = [], []
    for stage in range(4):
        want = fused_lik.head_rk4_jvp_plain(hl, dhl, wpl, bpl, coefl, j, stage, xl, xsl, accl,
                                            eps, lp, lacc)
        got = tuple(t.clone() for t in (xl, xsl, accl, lp, lacc))
        fused_lik.head_rk4_jvp(hl, dhl, wpl, bpl, coefl, j, stage, *got[:3], eps, *got[3:])
        torch.cuda.synchronize()
        e9 += [err(g, w) for g, w in zip(got, want)]
        tol9 += [1e-3 * max(1.0, float(w.abs().max())) for w in want]
    check(all(a_ <= b_ for a_, b_ in zip(e9, tol9)), f"head_rk4_jvp: errors {e9} > {tol9}")
    # 50 repeated calls bit-identical (the partials summed in rank order)
    runs9 = []
    for _ in range(1 + REPEATS):
        got = tuple(t.clone() for t in (xl, xsl, accl, lp, lacc))
        fused_lik.head_rk4_jvp(hl, dhl, wpl, bpl, coefl, j, 1, *got[:3], eps, *got[3:])
        runs9.append(got)
    torch.cuda.synchronize()
    check(all(torch.equal(p_, q_) for r_ in runs9[1:] for p_, q_ in zip(r_, runs9[0])),
          f"head_rk4_jvp: {REPEATS} repeated calls are not bit-identical")
    n9 = (2 * 4 * BL * H + 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS
          + 6 * 4 * BL * D + 3 * 4 * BL + 32)
    bms, by = bound(n9, 2 * 2 * BL * H * D, 16 * BL * D)
    st9 = tuple(t.clone() for t in (xl, xsl, accl, lp, lacc))
    run9 = lambda: fused_lik.head_rk4_jvp(  # noqa: E731
        hl, dhl, wpl, bpl, coefl, j, 1, *st9[:3], eps, *st9[3:])
    c9, bpl16 = [float(c) for c in coefl[j]], bpl.to(torch.bfloat16)

    def head_fn(hh):
        return torch.addmm(bpl16, hh.to(torch.bfloat16), wpl)[:, :D].float()

    def rk4_jvp_library():  # composite: torch.func.jvp of bf16 addmm + RK4 on x and delta logp
        out, dout = torch.func.jvp(head_fn, (hl,), (dhl,))
        k = torch.add(xsl * c9[0], out, alpha=c9[1])
        kl = (eps * eps).sum(1) * c9[0] + (dout * eps).sum(1) * c9[1]
        return (xl, torch.add(xl, k, alpha=0.5 * c9[2]), torch.add(accl, k, alpha=2.0), lp,
                torch.add(lacc, kl, alpha=2.0))

    want9 = fused_lik.head_rk4_jvp_plain(hl, dhl, wpl, bpl, coefl, j, 1, xl, xsl, accl, eps,
                                         lp, lacc)
    lib9_e = max(float((a - b).abs().max()) for a, b in zip(rk4_jvp_library(), want9))
    rows.append(dict(
        name="head_rk4_jvp", route="cuda", source=f"{CSRC}/head_rk4.cu",
        replaces=TPU_LIK_KERNEL,
        replaces_part="fused_lik.py:75-79 (fwd_jvp's post-dense pair, k_x and k_lp), :91-102 "
                      "(the RK4 step on x and delta_logp)",
        shape="stage 1, [50,1024] pair x [1024,63]", max_abs_err=max(e9),
        tol="1e-3*max(1,|ref|max), stages 0-3, x xs acc lp lacc", errs=e9, tols=tol9,
        cluster=cluster_launch("head_rk4", BL, H, kernel="head_rk4_jvp")["cluster"],
        repeats_bit_identical=REPEATS, ms=graph_ms(run9), eager_ms=eager_ms(run9),
        plain_ms=graph_ms(lambda: fused_lik.head_rk4_jvp_plain(hl, dhl, wpl, bpl, coefl, j, 1,
                                                               xl, xsl, accl, eps, lp, lacc)),
        library_ms=graph_ms(rk4_jvp_library), library_max_abs_err=lib9_e,
        library="composite: torch.func.jvp of bf16 torch.addmm + RK4 on x and delta logp",
        bound_ms=bms, bound_by=by))
    print(f"[kernel] head_rk4_jvp: clusters of {rows[-1]['cluster']} {rows[-1]['ms'] * 1e3:.2f} "
          f"us; {REPEATS} repeated calls bit-identical")
    for r in rows:
        kernel_row_line(r)
    return rows


# ---------------------------------------------------------------------------
# the fitting path: motion denoising and SMPLify (no kernel, as in JAX)
# ---------------------------------------------------------------------------

def fitting_launches(what):
    """The kernel launches of a fitting run: none, since its prior runs the
    fp32 ``nn.Module`` (the JAX tasks call ``model.apply`` under XLA)."""
    counts = fused_em.launch_counts()
    check(not any(counts.values()), f"{what} launched kernels: {counts}")
    return counts


def device_share(fn, steps):
    """The device's busy share over a short window ``fn`` of ``steps`` Adam
    steps: its kernels' device time in a profiled call over the wall of an
    unprofiled one (a whole fit holds ~10^5 kernels, too many to trace);
    None where the profiler records no device time."""
    _, wall = timed(fn)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us, _ = device_kernel_us(prof)
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation)
    out = dict(window_steps=steps, window_ms_per_step=wall * 1e3 / steps,
               kernels_per_step=n / steps, device_ms_per_step=None, busy_share=None)
    if dev_us > 0.0:
        out.update(device_ms_per_step=dev_us / 1e3 / steps, busy_share=dev_us / 1e6 / wall)
    return out


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_fitting_protocols(model, dev):
    """(m) motion denoising of 8 fragments x 60 frames of
    ``benchmarks/gen_synth_motion.py`` (``--n-seqs 8 --frames 60 --seed 0``)
    on the human-scale 120-vertex synthetic SMPL-X body, sigma 0.04, strategy
    '3', ``noise_schedule_kwargs(0.04)`` (3 x 60 Adam steps), all fragments
    in one ``optimize_batch``: each fragment's final MPJPE below its init,
    and ``optimize`` of each fragment alone on the same draws within
    ``MOTION_BATCH_TOL`` rad of the batch's poses over the first
    ``MOTION_SHORT_STEPS`` steps and within ``MOTION_MPJPE_RTOL`` of its
    final MPJPE over the schedule. (n) SMPLify with the DPoser prior on 8
    images of ``benchmarks/gen_synth_ehf.py``'s geometry (in-distribution
    draws of the synthetic AMASS mixture, ``--pose-scale 1.0``, through the
    port's ``SMPLXFit`` on the 10,475-vertex synthetic body, projected with
    the 1600 x 1200 EHF camera, ``joints[:25]`` at confidence 1), from the
    mean pose at the reference defaults (step 1e-2, 5 x 100 iterations,
    batch 8): PA-MPJPE and MPJPE by ``eval_EHF``'s arithmetic below the
    unfitted init's; and the same fit without the prior. The bbox, focal
    length and initial camera are ``fitting.py``'s arithmetic; images are
    not read (the card's machine has no cv2). Both run the pinned network in
    fp32 under autograd and launch no kernel."""
    t_phase = time.perf_counter()
    sde = SubVPSDE(N=motion_cli.SDE_N)
    score_fn = get_score_fn(sde, model, continuous=True)
    config = get_config()
    normalizer = PoseNormalizer(STATS, normalize=config.data.normalize,
                                min_max=config.data.min_max, rot_rep=config.data.rot_rep,
                                device=dev)
    os.makedirs(OUT, exist_ok=True)
    res, by_run = {}, {}

    # (m) motion denoising
    gsm = load_benchmark("gen_synth_motion")
    centers, w, basis = gsm.make_mixture(np.random.default_rng(0))
    rng = np.random.default_rng(0)
    gts = torch.as_tensor(np.stack([gsm.sample_sequence(rng, 60, centers, w, basis, 30.0)
                                    for _ in range(8)]), device=dev)
    human, _ = make_synthetic_body_model(os.path.join(OUT, "smplx_human.npz"), "smplx",
                                         n_verts=120, template_scale=0.15, seed=0)
    body = BodyModel(human, num_betas=10, model_type="smplx", device=dev)
    md = MotionDenoise(sde, score_fn, body, normalizer, dposer_weight=1.0, batch_size=60)
    sched = motion_cli.noise_schedule_kwargs(MOTION_STD)

    def fragment_draws():
        gens = [sequence_generator(0, i, dev) for i in range(8)]
        return gens, torch.stack([motion_cli.noisy_joints(body, gts[i], MOTION_STD, g)
                                  for i, g in enumerate(gens)])

    gens, noisy = fragment_draws()
    fused_em.reset_launch_counts()
    poses, wall = timed(lambda: md.optimize_batch(noisy, time_strategy="3", generators=gens,
                                                  **sched))
    by_run["motion_denoising"] = fitting_launches("motion denoising")
    check(poses.shape == (8, 60, D) and torch.isfinite(poses).all().item(),
          "motion denoising output")
    per = [md.metrics(poses[i], noisy[i], gts[i]) for i in range(8)]
    init, final = ([float(np.mean(r[k])) for r in per] for k in ("init_MPJPE", "MPJPE"))
    mpvpe = [float(np.mean(r["MPVPE"])) for r in per]
    for i in range(8):
        check(final[i] < init[i], f"motion fragment {i}: MPJPE {final[i]} cm not below its "
                                  f"init {init[i]} cm")
    # each fragment alone: the same draws; the batch's products (480 rows,
    # the fragment's 60) round otherwise, and 180 Adam steps amplify that
    # (Adam divides each gradient by its running norm, so an ulp in a gradient
    # near 0 flips a step): pointwise over the first SHORT_STEPS steps, by
    # the fragments' MPJPE over the whole schedule
    gens1, noisy1 = fragment_draws()
    check(torch.equal(noisy1, noisy), "motion: the fragments' noise is not reproducible")
    alone, alone_final, seq_walls = [], [], []
    for i in range(8):
        _, w1 = timed(lambda: md.optimize(noisy1[i], gts[i], time_strategy="3",
                                          generator=gens1[i], **sched))
        alone.append(md.last_poses)
        alone_final.append(float(np.mean(md.metrics(md.last_poses, noisy1[i],
                                                    gts[i])["MPJPE"])))
        seq_walls.append(w1)
    full_err = float((torch.stack(alone) - poses).abs().max())
    mpjpe_rel = max(abs(a - b) / b for a, b in zip(alone_final, final))
    check(mpjpe_rel <= MOTION_MPJPE_RTOL, f"motion: optimize_batch's MPJPE against optimize's "
                                          f"{mpjpe_rel:.3g} relative (> {MOTION_MPJPE_RTOL})")
    short = dict(sched, iterations=1, steps_per_iter=MOTION_SHORT_STEPS)
    gens_s, _ = fragment_draws()
    short_b = md.optimize_batch(noisy, time_strategy="3", generators=gens_s, **short)
    gens_s, _ = fragment_draws()
    short_err = 0.0
    for i in range(8):
        md.optimize(noisy[i], time_strategy="3", generator=gens_s[i], **short)
        short_err = max(short_err, float((md.last_poses - short_b[i]).abs().max()))
    check(short_err <= MOTION_BATCH_TOL, f"motion: optimize_batch against optimize over "
                                         f"{MOTION_SHORT_STEPS} steps {short_err} rad "
                                         f"(> {MOTION_BATCH_TOL})")
    batch_err = dict(short_steps=MOTION_SHORT_STEPS, short_max_abs_rad=short_err,
                     full_max_abs_rad=full_err, full_mpjpe_max_rel=mpjpe_rel,
                     alone_mpjpe_cm=alone_final)
    window = dict(sched, iterations=1, steps_per_iter=SHARE_STEPS)
    share = device_share(lambda: md.optimize_batch(noisy, time_strategy="3", generators=gens,
                                                   **window), SHARE_STEPS)
    steps = sched["iterations"] * sched["steps_per_iter"]
    res["motion_denoising"] = dict(
        fragments=8, frames=60, steps=steps, noise_std=MOTION_STD, init_mpjpe_cm=init,
        mpjpe_cm=final, mpvpe_cm=mpvpe, wall_s=wall, ms_per_fragment=wall * 1e3 / 8,
        ms_per_step=wall * 1e3 / steps, alone_walls_s=seq_walls,
        alone_ms_per_fragment=float(np.mean(seq_walls)) * 1e3,
        batch_vs_alone=batch_err, launches=by_run["motion_denoising"], **share)
    print(f"[fitting] (m) motion denoising 8 x 60 frames, sigma {MOTION_STD}, {steps} steps: "
          f"MPJPE {np.mean(init):.3f} -> {np.mean(final):.3f} cm (every fragment below its "
          f"init; per fragment {['%.2f' % v for v in final]}), MPVPE {np.mean(mpvpe):.3f} cm; "
          f"{wall * 1e3 / 8:.1f} ms per fragment batched ({wall:.2f} s a batch, "
          f"{wall * 1e3 / steps:.2f} ms a step), {np.mean(seq_walls) * 1e3:.1f} ms per fragment "
          f"alone; optimize_batch against optimize: {short_err:.3g} rad over {MOTION_SHORT_STEPS} "
          f"steps (tol {MOTION_BATCH_TOL}), {full_err:.3g} rad and MPJPE {mpjpe_rel:.3g} "
          f"relative over {steps} (tol {MOTION_MPJPE_RTOL}); a step over {SHARE_STEPS}: "
          f"{share['kernels_per_step']:.0f} kernels, {share['device_ms_per_step']} ms of them "
          f"in {share['window_ms_per_step']:.2f} ms, busy share {share['busy_share']}")

    # (n) SMPLify on synthetic EHF geometry
    gsa = load_benchmark("gen_synth_amass")
    centers, w, basis = gsa.make_mixture(np.random.default_rng(0))
    rng = np.random.default_rng(2024)
    gt_body = torch.as_tensor(gsa.sample_poses(rng, N_IMG, centers, w, basis), device=dev)
    hd = os.path.join(OUT, "smplx_hd.npz")
    make_synthetic_body_model(hd, "smplx", n_verts=10475, template_scale=0.15, seed=0)
    smpl = SMPLXFit(hd, device=dev)
    os.remove(hd)  # 110 MB: loaded, and not brought back
    root = torch.as_tensor(MocapDataset.EHF_CAM_R_AA, dtype=torch.float32,
                           device=dev).expand(N_IMG, 3)
    focal = float(estimate_focal_length(EHF_H, EHF_W))
    center, scale = bbox_from_detector(fitting_cli.EHF_BBOX)

    def col(v):
        return torch.full((N_IMG,), float(v), device=dev)

    init_cam_t, cc = fitting_cli.init_camera(
        torch.as_tensor(np.tile(center, (N_IMG, 1)), dtype=torch.float32, device=dev),
        col(scale), col(EHF_H), col(EHF_W), col(focal))
    zeros = torch.zeros(N_IMG, 10, device=dev)
    eye = torch.eye(3, device=dev).expand(N_IMG, 3, 3)
    with torch.no_grad():
        t_gt = init_cam_t.clone()
        for _ in range(3):  # gen_synth_ehf.py's standing placement: the top keypoint at row 250
            kp = perspective_projection(smpl(betas=zeros, body_pose=gt_body, global_orient=root,
                                             transl=t_gt).joints, eye, t_gt, focal, cc)
            t_gt[:, 1] += (EHF_TOP_V - kp[:, :25, 1].min(1).values) * t_gt[:, 2] / focal
        out = smpl(betas=zeros, body_pose=gt_body, global_orient=root, transl=t_gt)
        kp = perspective_projection(out.joints, eye, t_gt, focal, cc)
    keypoints = torch.zeros(N_IMG, 49, 3, device=dev)
    keypoints[:, :25, :2], keypoints[:, :25, 2] = kp[:, :25], 1.0
    cam_R = MocapDataset([], np.zeros((0, 5))).cam_R
    mesh_gt = out.vertices.cpu().numpy() @ cam_R  # the ply's frame: cam_R.T @ (v + t)
    seated = kp[:, :25, 1].min(1).values > 400  # fitting.py's bend-pose rule
    check(not bool(seated.any()), "SMPLify: a synthetic subject reads as seated")
    init_pose = smpl.mean_poses[:66].expand(N_IMG, -1).clone()
    init_betas = smpl.mean_shape.expand(N_IMG, -1).clone()
    db = MocapDataset([], np.zeros((0, 5)), body_model=smpl.bm)

    def evaluate(fit):
        rows = [db.eval_mesh([a[i:i + 1].cpu().numpy() for a in fit[:3]], mesh_gt[i])
                for i in range(N_IMG)]
        return ([r["pa_mpjpe_body"][0] for r in rows], [r["mpjpe_body"][0] for r in rows])

    pa0, mp0 = evaluate((init_pose, init_betas, init_cam_t))
    prior = DPoser(sde, score_fn, normalizer, batch_size=N_IMG, device=dev)
    for name, pp in (("smplify", prior), ("smplify_no_prior", None)):
        fitter = SMPLify(smpl, pose_prior=pp, step_size=1e-2, cam_step_size=1e-2,
                         batch_size=N_IMG, num_iters=100, focal_length=focal, sde_N=sde.N)
        gen = torch.Generator(device=dev).manual_seed(42)
        fused_em.reset_launch_counts()
        fit, wall = timed(lambda: fitter(init_pose, init_betas, init_cam_t, cc, keypoints,
                                         generator=gen))
        by_run[name] = fitting_launches(name)
        check(all(torch.isfinite(a).all().item() for a in fit), f"{name}: non-finite fit")
        pa, mp = evaluate(fit)
        res[name] = dict(images=N_IMG, steps=100 + 5 * 100, init_pa_mpjpe_mm=pa0,
                         init_mpjpe_mm=mp0, pa_mpjpe_mm=pa, mpjpe_mm=mp, wall_s=wall,
                         ms_per_image=wall * 1e3 / N_IMG, launches=by_run[name])
        print(f"[fitting] (n) {name} {N_IMG} images, 100 + 5 x 100 steps: PA-MPJPE "
              f"{np.mean(pa0):.2f} -> {np.mean(pa):.2f} mm, MPJPE {np.mean(mp0):.2f} -> "
              f"{np.mean(mp):.2f} mm; {wall * 1e3 / N_IMG:.1f} ms per image ({wall:.2f} s a "
              f"batch)")
    r = res["smplify"]
    check(np.mean(r["pa_mpjpe_mm"]) < np.mean(pa0) and np.mean(r["mpjpe_mm"]) < np.mean(mp0),
          f"SMPLify: PA-MPJPE {np.mean(r['pa_mpjpe_mm'])} / MPJPE {np.mean(r['mpjpe_mm'])} mm "
          f"not below the mean-pose init's {np.mean(pa0)} / {np.mean(mp0)}")
    short = SMPLify(smpl, pose_prior=prior, step_size=1e-2, batch_size=N_IMG,
                    num_iters=SHARE_STEPS // 6, focal_length=focal, sde_N=sde.N)
    r.update(device_share(lambda: short(init_pose, init_betas, init_cam_t, cc, keypoints,
                                        generator=gen), 6 * (SHARE_STEPS // 6)))
    print(f"[fitting] (n) smplify, a step over {r['window_steps']}: "
          f"{r['kernels_per_step']:.0f} kernels, {r['device_ms_per_step']} ms of them in "
          f"{r['window_ms_per_step']:.2f} ms, busy share {r['busy_share']}")
    res["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[fitting] (m) and (n) in {res['phase_wall_s']:.1f} s")
    inputs = dict(sde=sde, score_fn=score_fn, normalizer=normalizer, body=body, noisy=noisy,
                  gts=gts, sched=sched, smpl=smpl, prior=prior, focal=focal, cc=cc,
                  keypoints=keypoints, init=(init_pose, init_betas, init_cam_t))
    return dict(results=res, by_run=by_run, inputs=inputs)


def normalized_synthetic_poses(n, dev):
    config = get_config()
    normalizer = PoseNormalizer(STATS, normalize=config.data.normalize,
                                min_max=config.data.min_max, rot_rep=config.data.rot_rep,
                                device=dev)
    return normalizer.offline_normalize(torch.as_tensor(synthetic_poses(n), device=dev),
                                        from_axis=True)


def phase_ode_parity(model, dev):
    """The kernel PF-ODE sampler and the kernel likelihood against their plain
    loops, and the kernel PF-Euler decode against the fp32 tabled sampler.

    These loops draw no noise, so unlike generation a kernel loop is held to
    its plain loop pointwise end to end, every row: the samplers to
    ``ODE_TOL``*max(1, |ref|max), with the share of rows inside the 5e-3 the JAX
    package allows its RK4 kernel reported beside it (a few rows of 500 pass
    it: kernel and plain round the same bf16 operands but sum in another
    order); the likelihood's z to 3e-2*max(1, |ref|max) and each row's bits/dim
    to 0.1, that package's limits for its likelihood kernel. Against the fp32
    tabled sampler the 1000-step decode differs by bf16 rounding itself, and a
    few rows part further: there at least 95% of the rows must lie within
    2e-2*max(1, |ref|max), with the median error under a tenth of that."""
    sde = SubVPSDE(N=1000)
    gen = torch.Generator(device=dev).manual_seed(7)
    z = torch.randn(B, D, generator=gen, device=dev)
    out, failures = {}, []

    def hold(key, what, got, ref, pointwise=True):
        scale = max(1.0, float(ref.abs().max()))
        row_err = (got - ref).abs().amax(1)
        e, med = err(got, ref), float((got - ref).abs().median())
        shares = {f"rows_within_{k}": float((row_err <= t * scale).float().mean())
                  for k, t in (("5e_3", 5e-3), ("2e_2", 2e-2))}
        out[key] = dict(max_abs_err=e, ref_abs_max=scale, median_abs_err=med, **shares,
                        tol=ODE_TOL * scale if pointwise else None)
        print(f"[parity] {what}: max abs err {e:.3g}"
              + (f" (tol {ODE_TOL * scale:.3g})" if pointwise else "")
              + f", median {med:.3g}, rows within 5e-3 / 2e-2 of max(1,|ref|) "
                f"{shares['rows_within_5e_3']:.3f} / {shares['rows_within_2e_2']:.3f}")
        if pointwise and e > ODE_TOL * scale:
            failures.append(f"{what}: {e} > {ODE_TOL * scale}")
        if not pointwise and (shares["rows_within_2e_2"] < 0.95 or med > 2e-3 * scale):
            failures.append(f"{what}: {shares['rows_within_2e_2']:.3f} of rows within "
                            f"{2e-2 * scale}, median {med}")

    for n_steps in (20, ODE_STEPS):
        for denoise in (False, True):
            kw = dict(n_steps=n_steps, eps=1e-3, denoise=denoise, device=dev)
            _, ref = fused_ode.get_cuda_ode_sampler(sde, model, (B, D), plain=True, **kw)(z=z)
            _, got = fused_ode.get_cuda_ode_sampler(sde, model, (B, D), **kw)(z=z)
            torch.cuda.synchronize()
            hold(f"ode_{n_steps}{'_denoise' if denoise else ''}",
                 f"ODE sampler {n_steps} steps, denoise {denoise}", got, ref)

    kw = dict(eps=DECODE_EPS, probability_flow=True, device=dev)
    fp32 = tfs.get_fast_pc_sampler(sde, model, (B, D), **kw)(
        z=z, noise=torch.zeros(1, 1, B, D, device=dev).expand(sde.N, -1, -1, -1))
    ref = fused_em.get_cuda_em_sampler(sde, model, (B, D), plain=True, **kw)(z=z)
    got = fused_em.get_cuda_em_sampler(sde, model, (B, D), rng_mode="kernel", **kw)(gen, z=z)
    torch.cuda.synchronize()
    hold("pf_euler", "PF-Euler decode 1000 steps", got, ref)
    hold("pf_euler_vs_fp32", "PF-Euler decode 1000 steps against the fp32 tabled sampler",
         got, fp32, pointwise=False)

    data = normalized_synthetic_poses(BL, dev)
    eps = tlik.draw_epsilon("Rademacher", (BL, D), gen, dev)
    kw = dict(n_steps=LIK_STEPS, eps=LIK_EPS, device=dev)
    bpd_ref, z_ref, _ = fused_lik.get_cuda_likelihood_fn(sde, model, (BL, D), plain=True, **kw)(
        None, data, epsilon=eps)
    bpd, zk, _ = fused_lik.get_cuda_likelihood_fn(sde, model, (BL, D), **kw)(
        None, data, epsilon=eps)
    torch.cuda.synchronize()
    ez, eb = err(zk, z_ref), err(bpd, bpd_ref)
    tolz = 3e-2 * max(1.0, float(z_ref.abs().max()))
    out["likelihood"] = dict(z_max_abs_err=ez, z_tol=tolz, bpd_max_abs_err=eb,
                             bpd_tol=BPD_LIMIT, bpd_mean=float(bpd.mean()))
    print(f"[parity] likelihood {BL} x {LIK_STEPS}: z max abs err {ez:.3g} (tol {tolz:.3g}), "
          f"bits/dim per row {eb:.3g} (tol {BPD_LIMIT})")
    if ez > tolz or eb > BPD_LIMIT:
        failures.append(f"likelihood: z {ez} > {tolz} or bits/dim {eb} > {BPD_LIMIT}")
    check(not failures, "PF-ODE parity: " + "; ".join(failures))
    return out


def phase_ode_protocols(model, dev):
    sde = SubVPSDE(N=1000)
    gen = torch.Generator(device=dev).manual_seed(8)
    by_run, res = {}, {}

    # (e) PF-ODE sampling, 500 x 125
    sampler = fused_ode.get_cuda_ode_sampler(sde, model, (B, D), n_steps=ODE_STEPS, eps=1e-3,
                                             device=dev)
    walls, (nfe, x) = timed_calls(lambda: sampler(gen))
    by_run["ode_500x125"] = fused_em.launch_counts()
    check(nfe == 4 * ODE_STEPS and x.shape == (B, D) and torch.isfinite(x).all().item(),
          "PF-ODE sampler output")
    wall = min(walls[1:])
    res["ode_sampling"] = dict(poses_per_s=B / wall, wall_s=wall, walls_s=walls, nfe=nfe,
                               sample_abs_max=float(x.abs().max()),
                               launches=by_run["ode_500x125"])
    print(f"[ode] PF-ODE sampling 500 x {ODE_STEPS} RK4 steps: {B / wall:.1f} poses/s "
          f"({wall * 1e3:.1f} ms per call; calls {['%.3f' % w for w in walls]} s), launches "
          f"{by_run['ode_500x125']}")
    eager = fused_ode.get_cuda_ode_sampler(sde, model, (B, D), n_steps=ODE_STEPS, eps=1e-3,
                                           device=dev, loop="eager")
    eager_twin(res["ode_sampling"], sampler, lambda: eager(gen))

    # (f) the PF-Euler decode, 500 x 1000 at eps 1e-5
    decoder = demo.build_sampler(get_config(), sde, model, B, DECODE_EPS, "none", dev,
                                 probability_flow=True)
    z = torch.randn(B, D, generator=gen, device=dev)
    walls, x = timed_calls(lambda: decoder(gen, z=z))
    by_run["pf_euler_500x1000"] = fused_em.launch_counts()
    check(x.shape == (B, D) and torch.isfinite(x).all().item(), "PF-Euler decode output")
    wall = min(walls[1:])
    res["pf_euler_decode"] = dict(poses_per_s=B / wall, wall_s=wall, walls_s=walls,
                                  launches=by_run["pf_euler_500x1000"])
    print(f"[ode] PF-Euler decode 500 x 1000 steps: {B / wall:.1f} poses/s ({wall * 1e3:.1f} "
          f"ms per call; calls {['%.3f' % w for w in walls]} s)")

    # (g) likelihood, 50 synthetic poses x 100 steps, and the three paths' bits/dim
    data = normalized_synthetic_poses(BL, dev)
    eps = tlik.draw_epsilon("Rademacher", (BL, D), gen, dev)
    lik = fused_lik.get_cuda_likelihood_fn(sde, model, (BL, D), n_steps=LIK_STEPS, eps=LIK_EPS,
                                           device=dev)
    walls, (bpd, zk, nfe) = timed_calls(lambda: lik(None, data, epsilon=eps))
    by_run["likelihood_50x100"] = fused_em.launch_counts()
    k7_routes = fused_em.route_counts()["dense_gn_silu_jvp"]
    n_stages = 4 * LIK_STEPS
    check(k7_routes == {"wgmma": 4 * n_stages, "register": n_stages},
          f"likelihood: K7's routes {k7_routes}, expected the pre layer on the register "
          f"route and the four block layers on the Hopper route each stage")
    check(nfe == 4 * LIK_STEPS and bpd.shape == (BL,) and torch.isfinite(bpd).all().item()
          and torch.isfinite(zk).all().item(), "likelihood output")
    t0 = time.perf_counter()
    bpd32, z32, _ = tlik.get_fast_likelihood_fn(sde, model, n_steps=LIK_STEPS, eps=LIK_EPS)(
        None, data, epsilon=eps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    score_fn = get_score_fn(sde, model, continuous=True)
    bpd_ad, z_ad, nfe_ad = tlik.get_likelihood_fn(sde, score_fn, rtol=1e-4, atol=1e-4,
                                                  eps=LIK_EPS)(None, data, epsilon=eps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(torch.isfinite(bpd_ad).all().item(), "the adaptive likelihood ran out of steps")
    means = dict(kernel=float(bpd.mean()), fp32_rk4=float(bpd32.mean()),
                 adaptive_rk45=float(bpd_ad.mean()))
    gaps = dict(kernel_vs_fp32=abs(means["kernel"] - means["fp32_rk4"]),
                kernel_vs_adaptive=abs(means["kernel"] - means["adaptive_rk45"]),
                fp32_vs_adaptive=abs(means["fp32_rk4"] - means["adaptive_rk45"]))
    check(max(gaps.values()) <= BPD_LIMIT, f"bits/dim batch means {means} part by {gaps}")
    wall = min(walls[1:])
    scale = max(1.0, float(z_ad.abs().max()))
    # one stage's device time (K7 x5 and K9, graph replay: no host gaps) on
    # the likelihood's own operands, and the device's busy share of a batch
    net, coefs = fused_ode.build_rk4_operands(sde, model, LIK_EPS, sde.T, LIK_STEPS, dev)
    st = [data.clone(), data.clone(), torch.zeros_like(data), torch.zeros(BL, device=dev),
          torch.zeros(BL, device=dev)]
    bufs = score_net.hidden_jvp_buffers(net, BL, dev)
    jm = LIK_STEPS  # a mid-trajectory row of the stage grid

    def stage():
        hh, dhh = score_net.network_hidden_jvp(net, st[1], eps, jm, bufs)
        fused_lik.head_rk4_jvp(hh, dhh, net["w_post"], net["b_post"], coefs, jm, 1, st[0],
                               st[1], st[2], eps, st[3], st[4])

    stage_ms = graph_ms(stage)
    busy = n_stages * stage_ms / (wall * 1e3)
    res["likelihood"] = dict(
        ms_per_batch=wall * 1e3, walls_s=walls, batch=BL, nfe=nfe,
        stage_device_us=stage_ms * 1e3, device_ms_per_batch=n_stages * stage_ms,
        device_busy_share=busy, k7_routes=k7_routes, bpd_means=means,
        bpd_mean_gaps=gaps, bpd_limit=BPD_LIMIT,
        bpd_row_max_gap_kernel_vs_adaptive=float((bpd - bpd_ad).abs().max()),
        z_max_abs_err_kernel_vs_adaptive=float((zk - z_ad).abs().max()),
        z_max_abs_err_fp32_vs_adaptive=float((z32 - z_ad).abs().max()), z_abs_max=scale,
        adaptive_nfe=nfe_ad, fp32_rk4_wall_s=t1 - t0, adaptive_wall_s=t2 - t1,
        launches=by_run["likelihood_50x100"])
    eager = fused_lik.get_cuda_likelihood_fn(sde, model, (BL, D), n_steps=LIK_STEPS,
                                             eps=LIK_EPS, device=dev, loop="eager")
    eager_twin(res["likelihood"], lik, lambda: eager(None, data, epsilon=eps))
    print(f"[likelihood] {BL} x {LIK_STEPS} RK4 steps: {wall * 1e3:.1f} ms per batch (calls "
          f"{['%.3f' % w for w in walls]} s); a stage {stage_ms * 1e3:.1f} us of device time "
          f"(graph replay), {n_stages * stage_ms:.1f} ms a batch, busy {100 * busy:.0f}%; K7 "
          f"routes {k7_routes}; bits/dim means {means}, gaps {gaps}; adaptive nfe {nfe_ad}; "
          f"fp32 RK4 {t1 - t0:.2f} s, adaptive {t2 - t1:.2f} s once each")

    # (h) the demo's interpolation task on synthetic poses
    os.makedirs(OUT, exist_ok=True)
    poses_file = os.path.join(OUT, "synth_poses_interp.npz")
    np.savez(poses_file, pose_samples=synthetic_poses(20))
    args = demo.parse_args(["--task", "interpolation", "--device", "cuda", "--ckpt-path", CKPT,
                            "--stats-dir", STATS, "--file-path", poses_file,
                            "--output-path", os.path.join(OUT, "interpolation"),
                            "--seed", "42"])
    fused_em.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = demo.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_run["demo_interpolation"] = fused_em.launch_counts()
    with np.load(r["frames_file"]) as f:
        frames, recon, anchors = f["pose_frames"], f["recon"], f["anchors"]
    check(frames.shape == (5, 60, D) and np.isfinite(frames).all(), "interpolation frames")
    check(np.isfinite(r["recon_err"]) and r["recon_err"] < 0.1,
          f"interpolation reconstruction error {r['recon_err']}")
    res["interpolation"] = dict(recon_err_normalized=r["recon_err"],
                                recon_err_axis_angle=float(np.abs(recon - anchors).mean()),
                                frame_step_abs_max=float(np.abs(np.diff(frames, axis=1)).max()),
                                task_wall_s=wall - r["render_s"], render_s=r["render_s"],
                                launches=by_run["demo_interpolation"])
    print(f"[interpolation] demo: reconstruction error {r['recon_err']:.4f} (normalized), "
          f"task wall {wall - r['render_s']:.2f} s (renders {r['render_s']:.2f} s apart), "
          f"launches {by_run['demo_interpolation']}")
    return dict(results=res, by_run=by_run, lik_inputs=(data, eps))

# ---------------------------------------------------------------------------
# sharded serving on one card (dposer_tpu_torch/parallel)
# ---------------------------------------------------------------------------

def forward_bound_ms(rows, jvp=False):
    """The bound of one forward's five hidden layers at ``rows`` (the pre
    layer, then two blocks of two layers, the second of each with its
    residual), each launch bounded as phase 3 bounds it: K1, or K7 with its
    tangent on the bf16 copies the layer before wrote."""
    total = 0.0
    for k, res in ((D, False), (H, False), (H, True), (H, False), (H, True)):
        if jvp:
            rest = 2 * k * H + 3 * 4 * H + 2 * 4 * rows * H * (2 if res else 1)
            total += bound(2 * (2 if k == H else 4) * rows * k + rest + 2 * 2 * rows * H,
                           2 * 2 * rows * k * H, 40 * rows * H)[0]
        else:
            total += bound(4 * rows * k + 2 * k * H + 3 * 4 * H
                           + 4 * rows * H * (2 if res else 1), 2 * rows * k * H, 14 * rows * H)[0]
    return total


def head_bound_ms(name, rows):
    """One launch's bound of a head or an elementwise kernel at ``rows``, with
    phase 3's bytes and operations."""
    w = 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS
    n6 = 4 * rows * H + w + 9 * 4 * rows * D + 32
    return bound(*{
        "head_em": (4 * rows * H + w + 2 * 4 * rows * D + 32, 2 * rows * H * D, 110 * rows * D),
        "head_em_impute": (4 * rows * H + w + 4 * 4 * rows * D + 32, 2 * rows * H * D,
                           360 * rows * D),
        "langevin_update": (3 * 4 * rows * D + 4 * rows + 32, 0, 220 * rows * D),
        "masked_renoise": (4 * 4 * rows * D + 32, 0, 116 * rows * D),
        "comp_perturb": (2 * 4 * rows * D + 32, 0, 113 * rows * D),
        "head_adam": (n6, 2 * rows * H * D, 20 * rows * D),
        "head_adam_perturb": (n6 + 4 * rows * D, 2 * rows * H * D, 133 * rows * D),
        "head_rk4": (4 * rows * H + w + 5 * 4 * rows * D + 32, 2 * rows * H * D, 12 * rows * D),
        "head_rk4_jvp": (2 * 4 * rows * H + w + 6 * 4 * rows * D + 3 * 4 * rows + 32,
                         2 * 2 * rows * H * D, 16 * rows * D),
    }[name])[0]


def call_bound_ms(counts, rows):
    """The bound of one call's kernels at ``rows``: each launch's bound, summed
    over the call's launch counts (K1 and K7 five layers a forward)."""
    total = 0.0
    for name, n in counts.items():
        if n and name in ("dense_gn_silu", "dense_gn_silu_jvp"):
            total += n / 5 * forward_bound_ms(rows, jvp=name == "dense_gn_silu_jvp")
        elif n:
            total += n * head_bound_ms(name, rows)
    return total


def event_ms(fn, n=5):
    """Device time of one ``fn()`` between CUDA events, over ``n`` calls after
    one warm call (a graphed loop's call: its input copies and one replay)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def shard_of(x, r, n=SHARDS, axis=0):
    """Shard ``r``'s contiguous rows of ``x`` out of ``n``, as the mesh splits
    them."""
    return x.narrow(axis, r * x.shape[axis] // n, x.shape[axis] // n).contiguous()


def check_shards(what, out, refs):
    """Each shard's rows of ``out`` bit-equal to its single-device result."""
    for r, ref in enumerate(refs):
        check(torch.equal(shard_of(out, r, len(refs)), ref),
              f"{what}: shard {r} is not bit-equal to the single-device call at "
              f"{ref.shape[0]} rows")


def plain_loop_ms(build_plain, call):
    """(p) with ``--plain-loops``: the device time of one shard's call on the
    plain versions (``plain=True`` on injected inputs, captured and replayed
    by ``graph_ms``); None in the default run, which does not pay for the
    plain loops' capture."""
    if not PLAIN_LOOPS:
        return None
    plain = build_plain()
    return graph_ms(lambda: call(plain), reps=1, replays=3)


def plain_text(ms):
    return "not timed (--plain-loops)" if ms is None else f"{ms:.2f}"


def one_call_counts(fn):
    """The launch counts of one ``fn()``, and its result."""
    fused_em.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return fused_em.launch_counts(), out


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


CLI_RANK = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from dposer_tpu_torch import completion as cli
r = cli.run(cli.parse_args({argv!r}))
np.savez({out!r}, mpjpe=r["mpjpe_body"], mpvpe=r["mpvpe_all"], batches=r["batch_indices"])
"""


def cli_two_processes(argv):
    """(p)(vi) the completion CLI as two processes on this card over a gloo
    group at a free localhost port, each with a time limit (a hang fails the
    phase; every process is stopped): their saved per-sample errors and
    their standard outputs."""
    url = f"127.0.0.1:{free_port()}"
    files = [os.path.join(OUT, f"cli_rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", CLI_RANK.format(repo=REPO, out=files[r], argv=argv + [
            "--multihost", "--coordinator", url, "--num-processes", "2", "--process-id",
            str(r)])],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for r, proc in enumerate(procs):
            try:
                out, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise PhaseError(f"completion cli rank {r}: no end within {CLI_TIMEOUT_S} s")
            check(proc.returncode == 0,
                  f"completion cli rank {r} exited {proc.returncode}:\n{out[-3000:]}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return [np.load(f) for f in files], outs


def phase_sharded(model, dev, lik_data, lik_eps, lik_bpd_mean):
    """(p) sharded serving on one card: the four sharded kernel wrappers on a
    mesh of four shards on cuda:0 (the likelihood on two), each shard
    bit-equal to a single-device call at its rows with its folded generator
    or its rows of the injected inputs; ``DPoserComp(mesh=)``; the
    completion CLI as two processes against one. Where rows are independent
    the sharded result is also the unsharded call's, bit for bit: EM without
    the corrector, the solve on injected host normals, ODE, the likelihood
    on an injected probe. Walls printed, not gated; a shard's call timed
    between CUDA events (its graph's replay) beside the bound of its kernels
    at the shard's rows, and with ``--plain-loops`` its plain loop's
    (``plain_loop_ms``)."""
    t_phase = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    mesh = parallel.make_mesh(devices=[dev] * SHARDS)
    sde, config = SubVPSDE(N=1000), get_config()
    rs = B // SHARDS
    by_run, res = {}, {}

    def gens(seed):
        return parallel.shard_generators(mesh, torch.Generator(device=dev).manual_seed(seed))

    def best(walls):
        return min(walls[1:])  # the first call captures

    # (i) generation, 500 x 1000, in-kernel normals
    sharded = demo.build_sampler(config, sde, model, B, 1e-3, "none", dev, mesh=mesh)
    single = demo.build_sampler(config, sde, model, rs, 1e-3, "none", dev)
    whole = demo.build_sampler(config, sde, model, B, 1e-3, "none", dev)
    walls, encodes = [], []
    for _ in range(3):
        fused_em.reset_launch_counts()
        e0 = build.tma_encodes("dense_gn_silu")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = sharded(torch.Generator(device=dev).manual_seed(SHARD_SEED))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        encodes.append(build.tma_encodes("dense_gn_silu") - e0)
    counts = fused_em.launch_counts()
    by_run["sharded_generation_4x125"] = counts
    check(len(sharded.loops) == SHARDS and all(lp.graph and lp.capture_s is not None
                                                for lp in sharded.loops),
          f"sharded generation: {len(sharded.loops)} loops, expected one graph a shard")
    check(encodes[1:] == [0, 0], f"sharded generation: replays encoded {encodes[1:]} tensor maps")
    g = gens(SHARD_SEED)
    one, ref0 = one_call_counts(lambda: single(g[0]))
    check(all(counts[k] == SHARDS * one[k] for k in counts),
          f"sharded generation: launches {counts}, not {SHARDS} x a {rs}-row call's {one}")
    check_shards("sharded generation", x, [ref0] + [single(g[r]) for r in range(1, SHARDS)])
    gaps = [float((shard_of(x, a) - shard_of(x, b)).abs().max())
            for a in range(SHARDS) for b in range(a + 1, SHARDS)]
    check(min(gaps) > 1e-3, f"sharded generation: two shards drew the same rows ({gaps})")
    check(torch.isfinite(x).all().item(), "sharded generation: non-finite output")
    whole_walls, xw = timed_calls(
        lambda: whole(torch.Generator(device=dev).manual_seed(SHARD_SEED)))
    single_walls, _ = timed_calls(lambda: single(g[0]))
    shard_ms = event_ms(lambda: sharded.shards[0](g[0]))
    gp = torch.Generator(device=dev).manual_seed(SHARD_SEED + 3)
    zp, noisep = (torch.randn(shape, generator=gp, device=dev)
                  for shape in ((rs, D), (sde.N, 1, rs, D)))
    plain_ms = plain_loop_ms(
        lambda: fused_em.get_cuda_em_sampler(sde, model, (rs, D), eps=1e-3,
                                             denoise=config.sampling.noise_removal,
                                             predictor=config.sampling.predictor, device=dev,
                                             plain=True),
        lambda plain: plain(z=zp, noise=noisep))
    res["generation"] = dict(
        wall_s=best(walls), walls_s=walls, whole_500_wall_s=best(whole_walls),
        single_125_wall_s=best(single_walls), tma_encodes=encodes, launches=counts,
        launches_125_row_call=one, shard_call_device_ms=shard_ms, shard_call_plain_ms=plain_ms,
        shard_call_bound_ms=call_bound_ms(one, rs), moments=moments(x),
        whole_moments=moments(xw), shards_bit_equal=True, graphs=len(sharded.loops),
        graph_loops=[dict(warmup_s=lp.warmup_s, capture_s=lp.capture_s,
                          instantiate_s=lp.instantiate_s) for lp in sharded.loops])
    r_ = res["generation"]
    print(f"[sharded] (i) generation 500 x 1000 as {SHARDS} x {rs} on {dev}: every shard "
          f"bit-equal to a {rs}-row call with its folded generator, the shards' draws differ "
          f"(min gap {min(gaps):.3g}); launches {counts} = {SHARDS} x {one}; "
          f"{len(sharded.loops)} graphs; tensor maps encoded a call {encodes}; moments "
          f"{r_['moments']} (the 500-row call {r_['whole_moments']}); wall "
          f"{r_['wall_s'] * 1e3:.1f} ms (500 rows {r_['whole_500_wall_s'] * 1e3:.1f}, {rs} rows "
          f"{r_['single_125_wall_s'] * 1e3:.1f}); a shard's call {shard_ms:.2f} ms of device "
          f"time (its plain loop {plain_text(plain_ms)}, graph replay), bound "
          f"{r_['shard_call_bound_ms']:.2f}")

    # (ii) EM at N = 20, host noise injected: each shard on its rows of z and noise
    sde20 = SubVPSDE(N=20)
    gn = torch.Generator(device=dev).manual_seed(SHARD_SEED + 1)
    z = torch.randn(B, D, generator=gn, device=dev)
    mask, obs = create_mask(normalized_synthetic_poses(B, dev), part=PART, generator=gn)
    res["em_n20"] = {}
    for corrector in ("none", "langevin"):
        for imputation in (False, True):
            name = corrector + ("_imputation" if imputation else "")
            k = (corrector == "langevin") + 2 * imputation + 1
            noise = torch.randn((20, k, B, D), generator=gn, device=dev)
            io = dict(observation=obs, mask=mask) if imputation else {}
            kw = dict(corrector=corrector, imputation=imputation, device=dev)
            fused_em.reset_launch_counts()
            out = fused_em.get_cuda_em_sampler(sde20, model, (B, D), mesh=mesh, **kw)(
                z=z, noise=noise, **io)
            torch.cuda.synchronize()
            by_run[f"sharded_em_n20_{name}"] = fused_em.launch_counts()
            one_shard = fused_em.get_cuda_em_sampler(sde20, model, (rs, D), **kw)
            check_shards(f"sharded EM ({name})", out, [
                one_shard(z=shard_of(z, r), noise=shard_of(noise, r, axis=2),
                          **{k_: shard_of(v, r) for k_, v in io.items()})
                for r in range(SHARDS)])
            entry = dict(shards_bit_equal=True)
            if corrector == "none":  # rows are independent: the 500-row call, phase 4's bounds
                ref = fused_em.get_cuda_em_sampler(sde20, model, (B, D), **kw)(
                    z=z, noise=noise, **io)
                tol = 2e-2 * max(1.0, float(ref.abs().max()))
                row_err = (out - ref).abs().amax(1)
                frac = float((row_err <= tol).float().mean())
                med = float((out - ref).abs().median())
                check(frac >= 0.90 and med <= tol / 10,
                      f"sharded EM ({name}): {frac:.3f} of rows within {tol} of the 500-row "
                      f"call, median {med}")
                entry.update(rows_within_tol=frac, median_abs_err=med,
                             max_abs_err=float(row_err.max()), tol=tol)
            res["em_n20"][name] = entry
            print(f"[sharded] (ii) EM N = 20 ({name}), host noise: every shard bit-equal to a "
                  f"{rs}-row call on its rows; {entry}")

    # (iii) the 5c solve, 1,000 rows x 2x100, in-kernel normals; then DPoserComp(mesh=)
    normalizer = PoseNormalizer(STATS, normalize=config.data.normalize,
                                min_max=config.data.min_max, rot_rep=config.data.rot_rep,
                                device=dev)
    gts = torch.as_tensor(synthetic_poses(100), device=dev)
    gc = torch.Generator(device=dev).manual_seed(5)
    mask, obs = create_mask(normalizer.offline_normalize(gts, from_axis=True), part=PART,
                            generator=gc)
    obs_t, mask_t = obs.repeat(HYPO, 1), mask.repeat(HYPO, 1)
    kw = dict(time_strategy="3", rng_mode="kernel")
    solver = fused_comp.get_cuda_comp_solver(sde, model, (RC, D), 100 * D, mesh=mesh, **kw)
    single = fused_comp.get_cuda_comp_solver(sde, model, (RC // SHARDS, D), 100 * D,
                                             device=dev, **kw)
    whole = fused_comp.get_cuda_comp_solver(sde, model, (RC, D), 100 * D, device=dev, **kw)
    walls, xs = timed_calls(lambda: solver(torch.Generator(device=dev).manual_seed(SHARD_SEED),
                                           obs_t, mask_t))
    by_run["sharded_solver_4x250"] = counts = fused_em.launch_counts()
    g = gens(SHARD_SEED)
    parts = [(shard_of(obs_t, r), shard_of(mask_t, r)) for r in range(SHARDS)]
    one, ref0 = one_call_counts(lambda: single(g[0], *parts[0]))
    check(all(counts[k] == SHARDS * one[k] for k in counts),
          f"sharded solver: launches {counts}, not {SHARDS} x {one}")
    check_shards("sharded solver", xs,
                 [ref0] + [single(g[r], *parts[r]) for r in range(1, SHARDS)])
    whole_walls, _ = timed_calls(
        lambda: whole(torch.Generator(device=dev).manual_seed(SHARD_SEED), obs_t, mask_t))
    shard_ms = event_ms(lambda: solver.shards[0](g[0], *parts[0]))
    # on injected host normals the rows are independent (n_elems is global):
    # the sharded solve is the 1,000-row solve, bit for bit
    noise_h = torch.randn((200, RC, D), generator=gp, device=dev)
    kh = dict(time_strategy="3", rng_mode="host")
    xs_h = fused_comp.get_cuda_comp_solver(sde, model, (RC, D), 100 * D, mesh=mesh, **kh)(
        None, obs_t, mask_t, noise=noise_h)
    ref_h = fused_comp.get_cuda_comp_solver(sde, model, (RC, D), 100 * D, device=dev, **kh)(
        None, obs_t, mask_t, noise=noise_h)
    check(torch.equal(xs_h, ref_h), f"sharded solver on host normals: max abs err "
                                    f"{err(xs_h, ref_h)} against the 1,000-row solve")
    plain_ms = plain_loop_ms(
        lambda: fused_comp.get_cuda_comp_solver(sde, model, (RC // SHARDS, D), 100 * D,
                                                time_strategy="3", device=dev, plain=True),
        lambda plain: plain(None, *parts[0], noise=shard_of(noise_h, 0, axis=1)))
    comp = DPoserComp(sde, model=model, time_strategy="3", backend="cuda", device=dev,
                      mesh=mesh)
    fused_em.reset_launch_counts()
    hypos = comp.optimize_hypos(obs, mask, HYPO, gc)
    torch.cuda.synchronize()
    by_run["sharded_dposercomp_100x10"] = fused_em.launch_counts()
    check(hypos.shape == (100, HYPO, D) and torch.isfinite(hypos).all().item(),
          "sharded DPoserComp output")
    check(torch.equal(hypos * mask[:, None], (obs * mask)[:, None].expand_as(hypos)),
          "sharded DPoserComp: observed dims are not pasted exactly")
    smplx, _ = make_synthetic_body_model(os.path.join(OUT, "smplx_fixture.npz"), "smplx")
    ev = Evaler(BodyModel(smplx, num_betas=10, model_type="smplx", device=dev),
                part=PART).multi_eval_bodys(normalizer.offline_denormalize(hypos, to_axis=True),
                                            gts)
    mpjpe, mpvpe = float(np.mean(ev["mpjpe_body"])), float(np.mean(ev["mpvpe_all"]))
    check_bands("sharded DPoserComp", mpjpe, mpvpe)
    res["solver"] = dict(wall_s=best(walls), walls_s=walls, whole_1000_wall_s=best(whole_walls),
                         launches=counts, launches_250_row_call=one,
                         shard_call_device_ms=shard_ms, shard_call_plain_ms=plain_ms,
                         shard_call_bound_ms=call_bound_ms(one, RC // SHARDS),
                         shards_bit_equal=True, host_normals_equal_1000_row_solve=True,
                         dposercomp_mpjpe_mm=mpjpe,
                         dposercomp_mpvpe_mm=mpvpe)
    r_ = res["solver"]
    print(f"[sharded] (iii) solver 1000 x 2x100 as {SHARDS} x {RC // SHARDS}: every shard "
          f"bit-equal; on host normals the 1,000-row solve bit for bit; launches {counts} = "
          f"{SHARDS} x {one}; wall {r_['wall_s'] * 1e3:.1f} ms "
          f"(1,000 rows {r_['whole_1000_wall_s'] * 1e3:.1f}); a shard's call {shard_ms:.2f} ms "
          f"of device time (its plain loop {plain_text(plain_ms)}), bound "
          f"{r_['shard_call_bound_ms']:.2f}; DPoserComp(mesh=) 100 x "
          f"{HYPO}: pasted exactly, MPJPE {mpjpe:.1f} mm, MPVPE {mpvpe:.1f} mm")

    # (iv) PF-ODE sampling, 500 x 125
    kw = dict(n_steps=ODE_STEPS, eps=1e-3)
    sampler = fused_ode.get_cuda_ode_sampler(sde, model, (B, D), mesh=mesh, **kw)
    single = fused_ode.get_cuda_ode_sampler(sde, model, (rs, D), device=dev, **kw)
    whole = fused_ode.get_cuda_ode_sampler(sde, model, (B, D), device=dev, **kw)
    walls, (nfe, x) = timed_calls(
        lambda: sampler(torch.Generator(device=dev).manual_seed(SHARD_SEED)))
    by_run["sharded_ode_4x125"] = counts = fused_em.launch_counts()
    check(nfe == 4 * ODE_STEPS, f"sharded ODE: nfe {nfe}")
    g = gens(SHARD_SEED)
    one, ref0 = one_call_counts(lambda: single(g[0])[1])
    check_shards("sharded ODE", x, [ref0] + [single(g[r])[1] for r in range(1, SHARDS)])
    zz = torch.randn(B, D, generator=torch.Generator(device=dev).manual_seed(SHARD_SEED + 2),
                     device=dev)
    xz, ref = sampler(z=zz)[1], whole(z=zz)[1]
    e, tol = err(xz, ref), ODE_TOL * max(1.0, float(ref.abs().max()))
    check(e <= tol, f"sharded ODE against the 500-row call: {e} > {tol}")
    whole_walls, _ = timed_calls(
        lambda: whole(torch.Generator(device=dev).manual_seed(SHARD_SEED)))
    shard_ms = event_ms(lambda: sampler.shards[0](g[0]))
    plain_ms = plain_loop_ms(
        lambda: fused_ode.get_cuda_ode_sampler(sde, model, (rs, D), device=dev, plain=True,
                                               **kw),
        lambda plain: plain(z=zp))
    res["ode"] = dict(wall_s=best(walls), walls_s=walls, whole_500_wall_s=best(whole_walls),
                      launches=counts, launches_125_row_call=one, shard_call_device_ms=shard_ms,
                      shard_call_plain_ms=plain_ms,
                      shard_call_bound_ms=call_bound_ms(one, rs), shards_bit_equal=True,
                      max_abs_err_vs_500=e, tol=tol)
    r_ = res["ode"]
    print(f"[sharded] (iv) PF-ODE 500 x {ODE_STEPS} as {SHARDS} x {rs}: every shard "
          f"bit-equal; against the 500-row call {e:.3g} (tol {tol:.3g}); wall "
          f"{r_['wall_s'] * 1e3:.1f} ms (500 rows {r_['whole_500_wall_s'] * 1e3:.1f}); a "
          f"shard's call {shard_ms:.2f} ms of device time (its plain loop "
          f"{plain_text(plain_ms)}), bound {r_['shard_call_bound_ms']:.2f}")

    # (v) the likelihood, 50 x 100 on a mesh of 2, with 5g's data and probe injected
    mesh2 = parallel.make_mesh(devices=[dev] * 2)
    kw = dict(n_steps=LIK_STEPS, eps=LIK_EPS)
    lik = fused_lik.get_cuda_likelihood_fn(sde, model, (BL, D), mesh=mesh2, **kw)
    single = fused_lik.get_cuda_likelihood_fn(sde, model, (BL // 2, D), device=dev, **kw)
    whole = fused_lik.get_cuda_likelihood_fn(sde, model, (BL, D), device=dev, **kw)
    walls, (bpd, zl, nfe) = timed_calls(lambda: lik(None, lik_data, epsilon=lik_eps))
    by_run["sharded_likelihood_2x25"] = counts = fused_em.launch_counts()
    halves = [(shard_of(lik_data, r, 2), shard_of(lik_eps, r, 2)) for r in range(2)]
    one, first = one_call_counts(lambda: single(None, halves[0][0], epsilon=halves[0][1]))
    refs = [first] + [single(None, d_, epsilon=e_) for d_, e_ in halves[1:]]
    check_shards("sharded likelihood (bits/dim)", bpd, [r_[0] for r_ in refs])
    check_shards("sharded likelihood (z)", zl, [r_[1] for r_ in refs])
    # each row's bits/dim and z are the 50-row call's, bit for bit
    bpd_w, zl_w, _ = whole(None, lik_data, epsilon=lik_eps)
    check(torch.equal(bpd, bpd_w) and torch.equal(zl, zl_w),
          f"sharded likelihood against the {BL}-row call: bits/dim {err(bpd, bpd_w)}, "
          f"z {err(zl, zl_w)}")
    gap = abs(float(bpd.mean()) - lik_bpd_mean)
    check(gap <= BPD_LIMIT, f"sharded likelihood: bits/dim mean {float(bpd.mean())} against "
                            f"5g's {lik_bpd_mean}")
    whole_walls, _ = timed_calls(lambda: whole(None, lik_data, epsilon=lik_eps))
    shard_ms = event_ms(lambda: lik.shards[0](None, halves[0][0], epsilon=halves[0][1]))
    plain_ms = plain_loop_ms(
        lambda: fused_lik.get_cuda_likelihood_fn(sde, model, (BL // 2, D), device=dev,
                                                 plain=True, **kw),
        lambda plain: plain(None, halves[0][0], epsilon=halves[0][1]))
    res["likelihood"] = dict(wall_s=best(walls), walls_s=walls,
                             whole_50_wall_s=best(whole_walls), launches=counts,
                             launches_25_row_call=one, shard_call_device_ms=shard_ms,
                             shard_call_plain_ms=plain_ms,
                             shard_call_bound_ms=call_bound_ms(one, BL // 2),
                             shards_bit_equal=True, rows_equal_50_row_call=True,
                             bpd_mean=float(bpd.mean()),
                             bpd_mean_5g=lik_bpd_mean, bpd_mean_gap=gap)
    r_ = res["likelihood"]
    print(f"[sharded] (v) likelihood 50 x {LIK_STEPS} as 2 x 25: every shard bit-equal, and "
          f"every row's bits/dim and z the 50-row call's; "
          f"bits/dim mean {r_['bpd_mean']:.4f} (5g {lik_bpd_mean:.4f}); wall "
          f"{r_['wall_s'] * 1e3:.1f} ms (50 rows {r_['whole_50_wall_s'] * 1e3:.1f}); a shard's "
          f"call {shard_ms:.2f} ms of device time (its plain loop {plain_text(plain_ms)}), "
          f"bound {r_['shard_call_bound_ms']:.2f}")

    # (vi) the completion CLI as two processes on this card against one process
    mod = load_benchmark("gen_synth_amass")
    rng = np.random.default_rng(0)
    centers, w, basis = mod.make_mixture(rng)
    root = os.path.join(OUT, "amass_synth_1k")
    os.makedirs(os.path.join(root, "version1", "test"), exist_ok=True)
    np.save(os.path.join(root, "version1", "test", "pose_body.npy"),
            mod.sample_poses(rng, CLI_POSES, centers, w, basis))
    argv = ["--device", "cuda", "--ckpt-path", CKPT, "--stats-dir", STATS, "--dataset-folder",
            root, "--version", "version1", "--bodymodel-path", smplx, "--batch_size", "100",
            "--hypo", str(HYPO), "--part", PART, "--seed", "42"]
    t0 = time.perf_counter()
    ranks, outs = cli_two_processes(argv)
    two_wall = time.perf_counter() - t0
    fused_em.reset_launch_counts()
    t0 = time.perf_counter()
    r1 = completion_cli.run(completion_cli.parse_args(argv))
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    by_run["completion_cli_split_1000"] = fused_em.launch_counts()
    n_batches = CLI_POSES // 100
    check(r1["n_batches"] == n_batches, f"completion cli: {r1['n_batches']} batches")
    got = [[int(b) for b in f["batches"]] for f in ranks]
    check(got == [list(range(n_batches // 2)), list(range(n_batches // 2, n_batches))],
          f"completion cli: the ranks' batches {got}")
    for r, f in enumerate(ranks):
        check(np.array_equal(f["mpjpe"], r1["mpjpe_body"])
              and np.array_equal(f["mpvpe"], r1["mpvpe_all"]),
              f"completion cli rank {r}: the gathered per-sample errors differ from one "
              f"process's")
    check("The average of mpjpe_body" in outs[0] and "The average of" not in outs[1],
          "completion cli: rank 0 alone prints the averages")
    res["completion_cli_two_processes"] = dict(
        poses=CLI_POSES, batches=n_batches, per_sample_bit_equal=True,
        two_process_wall_s=two_wall, one_process_run_s=one_wall,
        mpjpe_mm=float(np.mean(r1["mpjpe_body"])), mpvpe_mm=float(np.mean(r1["mpvpe_all"])))
    print(f"[sharded] (vi) completion cli over {CLI_POSES} poses: two processes on {dev} "
          f"(batches {got[0]} and {got[1]}, {two_wall:.1f} s with their start-up) gather the "
          f"one-process run's {len(r1['mpjpe_body'])} per-sample MPJPE and MPVPE bit for bit "
          f"(one process {one_wall:.2f} s); rank 1 printed no averages")
    res["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[sharded] phase 5p wall {res['phase_wall_s']:.1f} s")
    return dict(results=res, by_run=by_run)


def phase_parity(model, dev):
    """The kernel sampler against the same loop on the plain versions: N = 20,
    the pinned weights, injected z and noise, corrector none and langevin.

    Step by step, both start each step from the plain trajectory's state and
    must agree to 2e-2*max(1, |ref|max) (the bound the JAX package holds its
    kernel to, tests/test_pallas_sampler.py). Free-running, the trained
    network's 20-step trajectories are chaotic under bf16 rounding: a change
    of summation order flips the rounding of a few activations, and a few
    rows of 500 then land elsewhere. So the whole trajectories are held to
    that bound row by row, for at least 90% of the rows, with the median
    error under a tenth of it, and the fp32 tabled sampler's distance is
    reported beside them."""
    n, shape = 20, (B, D)
    gen = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn(shape, generator=gen, device=dev)
    noise = torch.randn((n, 2) + shape, generator=gen, device=dev)
    sde = SubVPSDE(N=n)
    net, coefs = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", dev)
    out = {}
    for corrector, nz in (("none", noise[:, 1:].contiguous()), ("langevin", noise)):
        n_corr = 1 if corrector == "langevin" else 0
        kw = dict(n_corr=n_corr, snr=0.16)
        sk, sp = (fused_em.pc_scratch(net, B, n_corr, dev) for _ in range(2))
        xp, step_err, step_tol = z.clone(), 0.0, 0.0
        for i in range(n):
            xk = xp.clone()
            fused_em.pc_step(net, coefs, i, xk, sk, nz[i], **kw)
            fused_em.pc_step(net, coefs, i, xp, sp, nz[i], plain=True, **kw)
            step_err = max(step_err, err(xk, xp))
            step_tol = max(step_tol, 2e-2 * max(1.0, float(xp.abs().max())))
        check(step_err <= step_tol, f"sampler step parity ({corrector}): {step_err} > {step_tol}")

        def run(plain):
            return fused_em.get_cuda_em_sampler(sde, model, shape, corrector=corrector,
                                                device=dev, plain=plain)(z=z, noise=nz)
        ref, got = run(True), run(False)
        fp32 = tfs.get_fast_pc_sampler(sde, model, shape, corrector=corrector,
                                       device=dev)(z=z, noise=nz)
        torch.cuda.synchronize()
        tol = 2e-2 * max(1.0, float(ref.abs().max()))
        row_err = (got - ref).abs().amax(1)
        frac = float((row_err <= tol).float().mean())
        check(torch.isfinite(got).all().item(), f"sampler ({corrector}): non-finite output")
        med = float((got - ref).abs().median())
        check(frac >= 0.90 and med <= tol / 10,
              f"sampler parity ({corrector}): {frac:.3f} of rows within {tol}, median {med}")
        out[corrector] = dict(
            step_max_abs_err=step_err, step_tol=step_tol, max_abs_err=float(row_err.max()),
            median_abs_err=med, rows_within_tol=frac, tol=tol,
            fp32_max_abs_err=float((got - fp32).abs().max()),
            fp32_rows_within_tol=float(((got - fp32).abs().amax(1) <= tol).float().mean()),
            plain_vs_fp32_max_abs_err=float((ref - fp32).abs().max()))
        print(f"[parity] corrector={corrector}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in out[corrector].items()))
    return out


def phase_protocols(model, dev):
    # (a) generation: 500 poses x 1000 sub-VP EM steps, in-kernel normals
    config = get_config()
    sde = SubVPSDE(N=1000)
    sampler = demo.build_sampler(config, sde, model, B, 1e-3, "none", dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    walls, dev_ms, encodes = [], [], []
    for _ in range(3):
        fused_em.reset_launch_counts()  # the counts read below are one call's
        enc0 = build.tma_encodes("dense_gn_silu")
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        x = sampler(gen)
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        dev_ms.append(a.elapsed_time(b))
        encodes.append(build.tma_encodes("dense_gn_silu") - enc0)
    check(x.shape == (B, D) and torch.isfinite(x).all().item(), "generation output")
    gen_counts = fused_em.launch_counts()
    # a forward: the pre layer on the pre route, four layers on the bf16 copy
    k1_routes = fused_em.route_counts()["dense_gn_silu"]
    print(f"[generation] K1's routes a call: {k1_routes}")
    check(k1_routes == dict(wgmma_bf16=4000, pre_wgmma=1000),
          f"generation: K1's routes a call {k1_routes}")
    # K1 encodes its tensor maps once per (pointer, shape) and caches them: a
    # call's four K = 1024 layers need two activation and four weight maps
    print(f"[generation] tensor maps encoded per call: {encodes} for "
          f"{gen_counts['dense_gn_silu']} K1 launches a call")
    check(max(encodes) <= TMA_ENCODES_PER_CALL,
          f"K1 encoded {max(encodes)} tensor maps in one generation call "
          f"(> {TMA_ENCODES_PER_CALL}): the map cache is not holding")
    wall = min(walls[1:])  # steady state: the first call is the warm-up
    gen_res = dict(poses_per_s=B / wall, wall_s=wall, walls_s=walls, tma_encodes=encodes,
                   median_poses_per_s=B / float(np.median(walls[1:])), event_ms=dev_ms,
                   steps=1000, batch=B, launches=gen_counts, k1_routes=k1_routes)
    print(f"[generation] 500 x 1000 steps: {B / wall:.1f} poses/s best, "
          f"{gen_res['median_poses_per_s']:.1f} median "
          f"({wall * 1e3:.1f} ms per call; calls {['%.3f' % w for w in walls]} s)")
    eager = demo.build_sampler(config, sde, model, B, 1e-3, "none", dev, loop="eager")
    eager_twin(gen_res, sampler, lambda: eager(gen))

    # (b) the demo's generation task with --metrics, on the synthetic SMPL body
    os.makedirs(OUT, exist_ok=True)
    smpl, _ = make_synthetic_body_model(os.path.join(OUT, "smpl_fixture.npz"), "smpl")
    fused_em.reset_launch_counts()
    args = demo.parse_args(["--task", "generation", "--metrics", "--device", "cuda",
                            "--ckpt-path", CKPT, "--stats-dir", STATS, "--smpl-path", smpl,
                            "--output-path", OUT, "--seed", "42"])
    res = demo.run(args)
    torch.cuda.synchronize()
    demo_counts = fused_em.launch_counts()
    with np.load(res["samples_file"]) as f:
        poses = f["pose_samples"]
    check(poses.shape == (50, D) and np.isfinite(poses).all(), "demo samples")
    apd = res["apd"]
    check(APD_BAND[0] <= apd <= APD_BAND[1], f"APD {apd} outside {APD_BAND}")
    print(f"[metrics] APD {apd:.4f} in {APD_BAND}; protocol wall {res['metrics_wall_s']:.2f}s "
          f"(SI's {res['si_wall_s']:.2f} s included)")
    check(np.isfinite(res["si"]) and 0.0 <= res["si"] <= 100.0, f"SI {res['si']}")
    si_res, si_by_run = metrics_si(model, poses, dev)
    return dict(generation=gen_res, metrics=dict(apd=apd, wall_s=res["metrics_wall_s"],
                                                 si_wall_s=res["si_wall_s"],
                                                 si_fixture=res["si"], launches=demo_counts,
                                                 smooth_body=si_res),
                by_run=dict(generation_500x1000=gen_counts,
                            demo_generation_metrics=demo_counts, **si_by_run))


def host_cpu():
    """The host CPU's model (``lscpu``, else ``/proc/cpuinfo``) and its
    thread count."""
    lines = []
    try:
        lines = subprocess.run(["lscpu"], capture_output=True, text=True).stdout.splitlines()
    except FileNotFoundError:
        pass
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            lines += f.read().splitlines()
    fields = {}
    for ln in lines:  # newer lscpu indents "Model name" under "Vendor ID"
        key, sep, value = ln.partition(":")
        if sep:
            fields.setdefault(key.strip().lower(), value.strip())
    model = fields.get("model name", "unknown")
    if model == "unknown":  # a virtual machine may hide the name: its family and model
        model = (f"{fields.get('vendor id', '?')} family {fields.get('cpu family', '?')} "
                 f"model {fields.get('model', '?')} (name hidden)")
    return dict(model=model, threads=os.cpu_count())


def metrics_si(model, poses, dev):
    """(b) the self-intersection metric of the metrics protocol: the native
    library built with g++, multithreaded SI equal to single-threaded SI on
    20 meshes of the smooth 7,056-vertex SMPL body
    (``benchmarks/gen_synth_body.py::make_smooth_smpl_body``), and the
    demo's protocol on that body at ``--metrics-chunks`` 1 and 10: SI in
    [0, 100], APD of the chunked run within 5% of the single batch's (its
    samples are other draws; the APD band belongs to the fixture body),
    and each run's wall beside its SI and sampling seconds. Then the device
    time of one protocol sampler call (CUDA events around the graph's
    replay) at 500 rows and at a chunk's rows, which tells how much of the
    chunked run's sampling seconds the device itself adds."""
    check(shutil.which("g++") is not None,
          "no g++ on the PATH: the self-intersection metric cannot be built")
    t0 = time.perf_counter()
    lib = native.build_lib()
    native.load()
    cpu = host_cpu()
    print(f"[metrics] native SI library {os.path.basename(lib)} built in "
          f"{time.perf_counter() - t0:.2f} s; host CPU {cpu['model']}, {cpu['threads']} threads")
    smooth = load_benchmark("gen_synth_body").make_smooth_smpl_body(
        os.path.join(OUT, "smooth_smpl.npz"))
    body = BodyModel(smooth, num_betas=10, model_type="smpl", device=dev)
    pose = torch.cat([torch.as_tensor(poses[:20], device=dev),
                      torch.zeros(20, 6, device=dev)], 1)
    verts, faces = body(pose_body=pose).v.cpu().numpy(), body.f.cpu().numpy()
    si_mt = native.self_intersections_percentage(verts, faces)
    si_st = native.self_intersections_percentage(verts, faces, n_threads=1)
    check(np.array_equal(si_mt, si_st), f"SI multithreaded {si_mt} != single-threaded {si_st}")
    print(f"[metrics] SI on 20 smooth-body meshes ({verts.shape[1]} vertices, {len(faces)} "
          f"faces): multithreaded equal to single-threaded, mean {float(si_st.mean()):.3f}%")
    res, by_run = dict(host_cpu=cpu, mt_equals_st_20_meshes=True), {}
    for chunks in (1, METRICS_CHUNKS):
        args = demo.parse_args(["--task", "generation", "--metrics", "--metrics-chunks",
                                str(chunks), "--device", "cuda", "--ckpt-path", CKPT,
                                "--stats-dir", STATS, "--smpl-path", smooth, "--output-path",
                                os.path.join(OUT, f"metrics_chunks{chunks}"), "--seed", "42"])
        fused_em.reset_launch_counts()
        r = demo.run(args)
        torch.cuda.synchronize()
        by_run[f"demo_metrics_smooth_chunks{chunks}"] = fused_em.launch_counts()
        check(np.isfinite(r["si"]) and 0.0 <= r["si"] <= 100.0,
              f"chunks {chunks}: SI {r['si']} outside [0, 100]")
        res[f"chunks{chunks}"] = {k: r[k] for k in ("apd", "si", "metrics_wall_s", "si_wall_s",
                                                     "sample_wall_s")}
        print(f"[metrics] smooth body, chunks {chunks}: SI {r['si']:.3f}% (JAX on a TPU host, "
              f"the same checkpoint and body: 0.89%, context only), APD {r['apd']:.4f}; "
              f"protocol wall {r['metrics_wall_s']:.3f} s, SI {r['si_wall_s']:.3f} s, "
              f"sampling {r['sample_wall_s']:.3f} s (host {cpu['model']}, {cpu['threads']} "
              f"threads)")
    a1, a10 = res["chunks1"]["apd"], res[f"chunks{METRICS_CHUNKS}"]["apd"]
    check(abs(a10 - a1) <= 0.05 * a1,
          f"APD chunks {METRICS_CHUNKS} {a10} not within 5% of chunks 1 {a1}")
    sde, dev_ms = SubVPSDE(N=1000), {}
    for rows in (B, BM):
        sampler = demo.build_sampler(get_config(), sde, model, rows, demo.METRICS_EPS,
                                     "langevin", dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        sampler(gen)  # warm-up and capture
        times = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            sampler(gen)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        dev_ms[rows] = min(times)
    res["sampler_call_device_ms"] = {str(k): v for k, v in dev_ms.items()}
    res["chunked_device_ms"] = METRICS_CHUNKS * dev_ms[BM]
    print(f"[metrics] device time of one protocol sampler call (1000 steps, langevin): "
          f"{dev_ms[B]:.2f} ms at {B} rows, {dev_ms[BM]:.2f} ms at {BM} rows, so "
          f"{METRICS_CHUNKS} chunks take {res['chunked_device_ms']:.2f} ms of device time")
    return res, by_run


# ---------------------------------------------------------------------------
# the loops as CUDA graphs (ops/cuda/graph_loop.py)
# ---------------------------------------------------------------------------

def _tensors(out):
    return tuple(out) if isinstance(out, tuple) else (out,)


# The routes whose captured graphs must hold a programmatic edge into every
# programmatic launch but each graph's first (graph_against_eager)
PDL_GATED = ("generation", "solver")


def graph_against_eager(name, build, call, dev, n_graphs=1):
    """One graphed route at its main path's shape: ``build(loop)`` makes the
    route's sampler, ``call(fn, generator)`` runs it once. The graph's first
    call (warm-up, capture, replay) must give the eager call's bits from the
    same generator state, with the same launch, route and programmatic
    counts; a second call from another seed must give other values in
    tensors of its own. The captured graphs' edges between kernels are
    printed by type (``GraphLoop.kernel_edges``); for the routes of
    ``PDL_GATED`` the programmatic ones must number the call's programmatic
    launches, less at most one a graph (its first launch follows the reset
    of the loop's state)."""
    eager, graph = build("eager"), build("graph")
    kinds = ([lp.graph for lp in graph.loops], [lp.graph for lp in eager.loops])
    check(kinds == ([True] * n_graphs, [False] * n_graphs), f"{name}: loops {kinds}")
    outs, counts, walls = {}, {}, {}
    for kind, fn in (("eager", eager), ("graph", graph)):
        fused_em.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[kind] = _tensors(call(fn, torch.Generator(device=dev).manual_seed(GRAPH_SEED)))
        torch.cuda.synchronize()
        walls[kind] = time.perf_counter() - t0
        counts[kind] = (fused_em.launch_counts(), fused_em.route_counts(),
                        fused_em.programmatic_counts())
    check(all(torch.equal(a, b) for a, b in zip(outs["graph"], outs["eager"])),
          f"{name}: the graph is not bit-equal to the eager loop")
    check(counts["graph"] == counts["eager"],
          f"{name}: launches {counts['graph']} on the graph, {counts['eager']} eager")
    again = _tensors(call(graph, torch.Generator(device=dev).manual_seed(GRAPH_SEED + 1)))
    torch.cuda.synchronize()
    check(not torch.equal(again[0], outs["graph"][0]),
          f"{name}: another seed gave the graph's output again")
    check(again[0].data_ptr() != outs["graph"][0].data_ptr(),
          f"{name}: two calls returned the same tensor")
    check(all(torch.isfinite(t).all().item() for t in outs["graph"] + again),
          f"{name}: non-finite output")
    loops = [dict(warmup_s=lp.warmup_s, capture_s=lp.capture_s,
                  instantiate_s=lp.instantiate_s, edges=lp.kernel_edges()) for lp in graph.loops]
    n = sum(counts["graph"][0].values())
    n_pdl = sum(counts["graph"][2].values())
    n_edges = sum(lp["edges"]["programmatic"] for lp in loops)
    print(f"[graph] {name}: {n_pdl} programmatic launches a call, the graphs' edges between "
          f"kernels {[lp['edges'] for lp in loops]}")
    if name in PDL_GATED:
        check(n_pdl > 0 and n_pdl - n_graphs <= n_edges <= n_pdl,
              f"{name}: {n_edges} programmatic edges for {n_pdl} programmatic launches")
    print(f"[graph] {name}: bit-equal to eager, {n} launches a call on both, another seed "
          f"differs; first call {walls['graph'] * 1e3:.1f} ms (eager {walls['eager'] * 1e3:.1f}"
          f" ms); " + "; ".join(f"warm-up {lp['warmup_s'] * 1e3:.1f} ms, capture "
                                f"{lp['capture_s'] * 1e3:.1f} ms, instantiate "
                                f"{lp['instantiate_s'] * 1e3:.1f} ms" for lp in loops))
    return dict(bit_equal=True, launches_equal=True, launches=n, other_seed_differs=True,
                distinct_tensors=True, first_call_s=walls["graph"], eager_call_s=walls["eager"],
                programmatic_launches=n_pdl, programmatic_edges=n_edges, loops=loops)


def phase_graphs(model, dev, amax):
    """Every graphed route at its main path's shape, graph against eager:
    generation (5a), the metrics sampler (langevin), completion2 pc, ddim and
    hybrid (50 poses x 10 hypotheses), int8 per channel and int8-mixed, the
    PF-Euler decode, PF-ODE sampling, the likelihood and the 5c solve."""
    config = get_config()
    sp = config.sampling
    sde = SubVPSDE(N=1000)
    eps = sampling_eps_for(sde)
    poses = normalized_synthetic_poses(100, dev)
    mask_rc, obs_rc = create_mask(poses, part=PART,
                                  generator=torch.Generator(device=dev).manual_seed(5))
    obs, mask = obs_rc[:50].contiguous(), mask_rc[:50].contiguous()  # completion2's 50
    obs_rc, mask_rc = obs_rc.repeat(HYPO, 1), mask_rc.repeat(HYPO, 1)  # 5c's 1,000 rows
    data = normalized_synthetic_poses(BL, dev)
    kern = dict(rng_mode="kernel", device=dev)

    def em(loop, eps=1e-3, corrector="none", **kw):
        return demo.build_sampler(config, sde, model, B, eps, corrector, dev, loop=loop, **kw)

    comp = DPoserComp(sde, model=model, time_strategy="3", backend="cuda", device=dev)

    def solver(loop):
        return fused_comp.get_cuda_comp_solver(
            sde, model, (RC, D), 100 * D, lr=comp.lr, iterations=comp.iterations,
            steps_per_iter=comp.steps_per_iter, time_strategy="3", sample_trun=comp.sample_trun,
            sample_time=comp.sample_time, loop=loop, **kern)

    pc_kw = dict(eps=eps, denoise=sp.noise_removal, corrector=sp.corrector, snr=sp.snr,
                 n_corrector_steps=sp.n_steps_each, predictor=sp.predictor, **kern)
    routes = [
        ("generation", lambda loop: em(loop), lambda fn, g: fn(g), 1),
        ("metrics_langevin", lambda loop: em(loop, 5e-3, "langevin"), lambda fn, g: fn(g), 1),
        ("completion2_pc", lambda loop: fused_em.get_cuda_em_hypo_sampler(
            sde, model, (50, D), HYPO, loop=loop, **pc_kw), lambda fn, g: fn(g, obs, mask), 1),
        ("completion2_ddim", lambda loop: few_step.get_cuda_ddim_hypo_sampler(
            sde, model, (50, D), HYPO, n_steps=50, eps=eps, denoise=sp.noise_removal,
            loop=loop, **kern), lambda fn, g: fn(g, obs, mask)[1], 1),
        ("completion2_hybrid", lambda loop: few_step.get_cuda_hybrid_hypo_sampler(
            sde, model, (50, D), HYPO, n_head=25, m_tail=100, eps=eps,
            tail_corrector="langevin", snr=sp.snr, n_corrector_steps=sp.n_steps_each,
            loop=loop, **kern), lambda fn, g: fn(g, obs, mask)[1], 2),
        ("int8_channel", lambda loop: em(loop, quant_kw=dict(quant="int8",
                                                             act_amax=amax["channel"])),
         lambda fn, g: fn(g), 1),
        ("int8_mixed", lambda loop: em(loop, quant_kw=dict(quant="int8", act_amax=amax["tensor"],
                                                           bf16_tail_steps=100)),
         lambda fn, g: fn(g), 2),
        ("pf_euler_decode", lambda loop: em(loop, DECODE_EPS, probability_flow=True),
         lambda fn, g: fn(g), 1),
        ("ode_sampling", lambda loop: fused_ode.get_cuda_ode_sampler(
            sde, model, (B, D), n_steps=ODE_STEPS, eps=1e-3, device=dev, loop=loop),
         lambda fn, g: fn(g)[1], 1),
        ("likelihood", lambda loop: fused_lik.get_cuda_likelihood_fn(
            sde, model, (BL, D), n_steps=LIK_STEPS, eps=LIK_EPS, device=dev, loop=loop),
         lambda fn, g: fn(g, data)[:2], 1),
        ("solver", solver, lambda fn, g: fn(g, obs_rc, mask_rc), 1),
    ]
    t0 = time.perf_counter()
    res = {name: graph_against_eager(name, build, call, dev, n)
           for name, build, call, n in routes}
    print(f"[graph] {len(res)} routes: graph bit-equal to eager in "
          f"{time.perf_counter() - t0:.1f} s")
    return res


def bench_line():
    """``python -m dposer_tpu_torch.bench`` on the card, as a user runs it:
    its one JSON line, printed and checked."""
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.bench"], capture_output=True,
                       text=True, cwd=REPO, timeout=600)
    lines = p.stdout.strip().splitlines()
    check(p.returncode == 0 and len(lines) == 1, f"bench: exit {p.returncode}, stdout "
          f"{p.stdout[-2000:]!r}, stderr {p.stderr[-2000:]!r}")
    res = json.loads(lines[0])
    check(res["metric"] == "subvp_generation_poses_per_sec" and res["value"] > 0
          and res["baseline_source"] == "fresh", f"bench line {res}")
    print(f"[bench] {lines[0]}")
    return res


# ---------------------------------------------------------------------------
# the int8 serving mode (K13) and the microbenchmarks (K14)
# ---------------------------------------------------------------------------

def calibrate(model, dev, scheme, eps=1e-3, corrector="none"):
    """The demo's calibration: 256 poses, the full 1000-step fp32 trajectory,
    a generator seeded with the demo's seed + 999."""
    fn = (quant.calibrate_act_amax_per_channel if scheme == "channel"
          else quant.calibrate_act_amax)
    return fn(SubVPSDE(N=1000), model, (demo.CALIB_BATCH, D),
              torch.Generator(device=dev).manual_seed(42 + demo.CALIB_SEED_OFFSET), eps=eps,
              corrector=corrector, device=dev)


def phase_int8_kernels(model, dev, amax):
    """(i) The Hopper int8 loop (``csrc/dense_wgmma_int8.cuh``) first, alone:
    one [64,128]x[128,64] tile, then K13's pre-epilogue product at the
    sampler's [500,1024]x[1024,1024] on each scheme's weights, bit-equal to
    the exact sums times the rescale row, and the loop's time at one block
    against 128 and at K 128 against 1024; (ii) K13 against its plain
    version at the sampler's shapes, per-tensor and per-channel rows, on
    states of a real trajectory (the bf16 kernel sampler's state after 500
    of 1000 steps): the pre layer on the fp32 state (the pre route), each
    K = 1024 layer on the int8 copy the layer before it wrote (the Hopper
    loop), each writing the next layer's int8 copy, held byte for
    byte to ``quantize_act`` of its own fp32 output; the K = 1024 layers also
    on the register route, as they ran before the handoff; timings, the bound
    from the new byte flow (fp32 in and no copy beside it), plain and
    library times;
    (iii) K14 in its four modes at the microbenchmarks' [512,1024]x[1024,1024],
    the int8 inner link (int8 in, int8 out) and last link (the state update
    and its int8 copy) exact against the plain link."""
    sde = SubVPSDE(N=1000)
    gen = torch.Generator(device=dev).manual_seed(11)
    # (i) the loop alone: one tile, exact (qs = 1: the int32 sums themselves)
    a_t = torch.randint(-127, 128, (64, 128), dtype=torch.int8, generator=gen, device=dev)
    w_t = torch.randint(-127, 128, (64, 128), dtype=torch.int8, generator=gen, device=dev)
    tile = score_net.int8_loop_product(a_t, w_t, torch.ones(64, device=dev))
    torch.cuda.synchronize()
    check(torch.equal(tile, quant.int8_matmul(a_t.float(), w_t.t())),
          "the int8 wgmma loop's first [64,128]x[128,64] tile is not the exact int32 sums")
    probe = {}
    for label, rows_, cols, k in (("1 block, K 1024", 64, 64, 1024),
                                  ("128 blocks, K 1024", B, H, 1024),
                                  ("128 blocks, K 128", B, H, 128)):
        ap = torch.randint(-127, 128, (rows_, k), dtype=torch.int8, generator=gen, device=dev)
        wp_ = torch.randint(-127, 128, (cols, k), dtype=torch.int8, generator=gen, device=dev)
        qp = torch.ones(cols, device=dev)
        probe[label] = graph_ms(lambda ap=ap, wp_=wp_, qp=qp:
                                score_net.int8_loop_product(ap, wp_, qp))
    print("[int8] the Hopper int8 loop alone (product, plain store): first tile exact; "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in probe.items()))

    i = 500
    x = fused_em.get_cuda_em_sampler(sde, model, (B, D), denoise=False, step_range=(0, i),
                                     rng_mode="kernel", device=dev)(gen)
    rows, variants, copies = [], [], {}
    for scheme in ("tensor", "channel"):
        net, _ = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", dev,
                                                 quant="int8", act_amax=amax[scheme])
        tp, gs, gb = net["tp_all"][i], net["gn_scale"], net["gn_bias"]
        lw = lambda j: score_net.layer_weights(net, j)  # noqa: E731
        qrow = net["qinv_rows"]
        h = score_net.dense_gn_silu_int8_plain(x, *lw(0), tp[0], gs[0], gb[0])
        h1 = score_net.dense_gn_silu_int8_plain(h, *lw(1), tp[1], gs[1], gb[1])
        # the pre-epilogue product of the Hopper loop, exact, on this scheme's weights
        aq1 = quant.quantize_act(h, qrow[1]).to(torch.int8)
        prod = score_net.int8_loop_product(aq1, net["Wq"][1], net["qs_rows"][1])
        torch.cuda.synchronize()
        check(torch.equal(prod, quant.int8_matmul(aq1.float(), net["Wq"][1].t())
                          * net["qs_rows"][1]),
              f"dense_gn_silu_int8 {scheme}: the Hopper loop's product is not exact")
        for label, a, j, res, route in (
                ("pre [500,63]x[63,1024]", x, 0, None, "pre_wgmma8"),
                ("block [500,1024]x[1024,1024]", h, 1, None, "wgmma_int8"),
                ("block+residual [500,1024]x[1024,1024]", h1, 2, h, "wgmma_int8"),
                ("block/register [500,1024]x[1024,1024]", h, 1, None, "register"),
                ("block+residual/register [500,1024]x[1024,1024]", h1, 2, h, "register")):
            hopper = route == "wgmma_int8"
            wq, qinv, qs = lw(j)
            args = (a, wq, qinv, qs, tp[j], gs[j], gb[j])
            a_q = quant.quantize_act(a, qinv).to(torch.int8) if hopper else None
            qn = qrow[j + 1] if hopper or j == 0 else None  # the copy the sampler hands on
            o_q = torch.empty((B, H), dtype=torch.int8, device=dev) if qn is not None else None
            qkw = dict(a_q=a_q, qinv_next=qn, out_q=o_q)
            ref = score_net.dense_gn_silu_int8_plain(*args, res)
            fused_em.reset_launch_counts()
            out = score_net.dense_gn_silu_int8(None if hopper else a, *args[1:], residual=res,
                                               **qkw)
            torch.cuda.synchronize()
            check(fused_em.route_counts()["dense_gn_silu_int8"][route] == 1,
                  f"dense_gn_silu_int8 {label}: not on the {route} route")
            e, tol = err(out, ref), 1e-3 * max(1.0, float(ref.abs().max()))
            check(e <= tol, f"dense_gn_silu_int8 {scheme} {label}: max abs err {e} > {tol}")
            if o_q is not None:
                same = torch.equal(o_q, quant.quantize_act(out, qn).to(torch.int8))
                check(same, f"dense_gn_silu_int8 {scheme} {label}: the int8 copy is not "
                            f"quantize_act of the layer's own fp32 output")
                copies[f"{label.split()[0]} {scheme}"] = "bit-equal"
            K = a.shape[1]
            rows_n = 4 * 4 * H + 4 * B * H * (2 if res is not None else 1)  # rows, res, out
            old_bytes = 4 * B * K + K * H + 4 * K + rows_n
            n_bytes = ((B * K if hopper else 4 * B * K + 4 * K) + K * H + rows_n
                       + (4 * H + B * H if qn is not None else 0))
            bms, by = bound(n_bytes, 2 * B * K * H, 14 * B * H, INT8_TC_OPS)
            old_bms, _ = bound(old_bytes, 2 * B * K * H, 14 * B * H, INT8_TC_OPS)
            o = torch.empty_like(ref)
            kp = (K + 7) // 8 * 8  # torch._int_mm takes K in multiples of 8
            wq_t = F.pad(wq, (0, kp - K)).t()  # [K, N], column-major as cuBLASLt wants

            def library(a=a, a_q=a_q, qinv=qinv, qs=qs, j=j, res=res, K=K, kp=kp, wq_t=wq_t,
                        qn=qn):
                aq = (torch.clamp(torch.round(a * qinv), -127, 127).to(torch.int8)
                      if a_q is None else a_q)
                y = torch._int_mm(F.pad(aq, (0, kp - K)), wq_t).float() * qs + tp[j]
                y = F.silu(F.group_norm(y, 32, gs[j], gb[j], eps=1e-5))
                y = y if res is None else y + res
                return y if qn is None else (y, torch.clamp(torch.round(y * qn), -127,
                                                            127).to(torch.int8))

            lib = library()
            lib_e = float(((lib if qn is None else lib[0]) - ref).abs().max())
            run = lambda args=args, res=res, o=o, hopper=hopper, qkw=qkw: (  # noqa: E731
                score_net.dense_gn_silu_int8(None if hopper else args[0], *args[1:],
                                             residual=res, out=o, **qkw))
            variants.append(dict(
                shape=f"{label.split()[0]} {scheme} {label.split()[1]}", route=route,
                int8_copy=qn is not None, max_abs_err=e, tol=tol, ms=graph_ms(run),
                eager_ms=eager_ms(run),
                plain_ms=graph_ms(lambda args=args, res=res:
                                  score_net.dense_gn_silu_int8_plain(*args, res)),
                library_ms=graph_ms(library), library_max_abs_err=lib_e, bound_ms=bms,
                bound_by=by, bound_ms_fp32_in=old_bms))
    main_v = next(v for v in variants if v["shape"].startswith("block+residual channel"))
    rows.append(dict(name="dense_gn_silu_int8", route="cuda",
                     source=f"{CSRC}/dense_gn_silu_int8.cu", replaces=TPU_KERNEL,
                     replaces_part="fused_em.py:62,104-110 quant_inv -> score_net.py:337-360 "
                                   "quant mm (int8 x int8 -> int32, rescale row), then the "
                                   "time row, group_norm_vpu, SiLU, h + h2",
                     main_loop=f"{CSRC}/dense_wgmma_int8.cuh (K = 1024 layers, on the int8 "
                               f"copy the layer before wrote); the pre route in "
                               f"{CSRC}/dense_gn_silu_int8.cu (the pre layer, on the fp32 "
                               f"state: bulk copies, one wgmma s8 stage)",
                     max_abs_err=max(v["max_abs_err"] for v in variants),
                     tol="1e-3*max(1,|ref|max); the loop's product, the int8 copies: exact",
                     **{k: main_v[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by",
                                               "bound_ms_fp32_in")},
                     library="torch._int_mm (K padded to 8) + rescale + group_norm + silu, "
                             "on the same int8 input (quantized first on the register route), "
                             "+ the int8 copy",
                     int8_copies=copies, loop_alone_ms=probe, variants=variants))

    # (iii) K14 chain_link in its four modes; int8 on both routes
    a = torch.randn(mxu_micro.B, mxu_micro.H, generator=gen, device=dev)
    _, ws, ws_i8 = mxu_micro.make_inputs(dev, mxu_micro.B, mxu_micro.H)
    int8_rows = chain_link.int8_rows(mxu_micro.H, mxu_micro.H, dev)
    qnext = int8_rows["qinv"]  # the chain requantizes every link's input by one row
    a_q = quant.quantize_act(a, qnext).to(torch.int8)
    R = a.shape[0]
    cvariants = []
    for mode in ("bf16", "bf16-out", "gn-silu", "int8", "int8 inner", "int8 last"):
        base = mode.split()[0]
        w = ws_i8[0] if base == "int8" else ws[0]
        rk = int8_rows if base == "int8" else {}
        hkw = {}
        if mode == "int8 inner":
            hkw = dict(a_q=a_q, qinv_next=qnext)
        elif mode == "int8 last":
            hkw = dict(a_q=a_q, qinv_next=qnext, update=True)
        errs = []
        for update in ((False, True) if not hkw else (hkw.get("update", False),)):
            kw = {k: v for k, v in hkw.items() if k != "update"}
            xs = torch.randn(a.shape, generator=gen, device=dev)
            oq_ref = oq = None
            if "a_q" in kw:
                oq_ref, oq = (torch.empty(a.shape, dtype=torch.int8, device=dev)
                              for _ in range(2))
            out_ref = xs.clone() if (update or not kw) else None
            out_k = xs if (update or not kw) else None
            ref = chain_link.chain_link_plain_into(None if kw else a, w, base, out=out_ref,
                                                   update=update, out_q=oq_ref, **kw, **rk)
            got = chain_link.chain_link(None if kw else a, w, base, out=out_k, update=update,
                                        out_q=oq, **kw, **rk)
            torch.cuda.synchronize()
            if kw:  # the Hopper int8 loop: exact, fp32 state and int8 copy alike
                check(torch.equal(got, ref) and torch.equal(oq, oq_ref),
                      f"chain_link {mode}: not bit-equal to the plain link")
                errs.append(0.0)
                continue
            # bf16-out: one flipped rounding is a bf16 ulp, 2^-7 of the value
            tol = (8e-3 if mode == "bf16-out" else 1e-3) * max(1.0, float(ref.abs().max()))
            errs.append(err(got, ref))
            check(errs[-1] <= tol, f"chain_link {mode} update={update}: {errs[-1]} > {tol}")
        K = w.shape[1] if base == "int8" else w.shape[0]
        N = w.shape[0] if base == "int8" else w.shape[1]
        if mode == "int8 inner":
            n_bytes = R * K + K * N + 8 * N + R * N
        elif mode == "int8 last":
            n_bytes = R * K + K * N + 8 * N + 2 * 4 * R * N + R * N
        else:
            n_bytes = (4 * R * K + (1 if base == "int8" else 2) * K * N + 4 * R * N
                       + (8 * N if base == "int8" else 0))
        bms, by = bound(n_bytes, 2 * R * K * N, 14 * R * N if mode == "gn-silu" else 0,
                        INT8_TC_OPS if base == "int8" else BF16_TC_FLOPS)
        o, oq_t = torch.empty_like(a), torch.empty(a.shape, dtype=torch.int8, device=dev)
        xt = torch.randn(a.shape, generator=gen, device=dev)
        a16, wt = a.to(torch.bfloat16), w.t()
        if mode == "int8":
            library = lambda: torch._int_mm(  # noqa: E731
                torch.clamp(torch.round(a * chain_link.INT8_QINV), -127, 127).to(torch.int8),
                wt).float() * chain_link.INT8_SCALE
            run = lambda: chain_link.chain_link(a, w, "int8", out=o, **rk)  # noqa: E731
        elif mode == "int8 inner":
            library = lambda: torch.clamp(torch.round(  # noqa: E731
                torch._int_mm(a_q, wt).float() * chain_link.INT8_SCALE * chain_link.INT8_QINV),
                -127, 127).to(torch.int8)
            run = lambda: chain_link.chain_link(None, w, "int8", a_q=a_q,  # noqa: E731
                                                qinv_next=qnext, out_q=oq_t, **rk)
        elif mode == "int8 last":
            def library():
                xn = xt * 0.5 + torch._int_mm(a_q, wt).float() * chain_link.INT8_SCALE * 1e-3
                return xn, torch.clamp(torch.round(xn * chain_link.INT8_QINV), -127,
                                       127).to(torch.int8)
            run = lambda: chain_link.chain_link(None, w, "int8", out=xt, update=True,  # noqa: E731
                                                a_q=a_q, qinv_next=qnext, out_q=oq_t, **rk)
        elif mode == "gn-silu":
            library = lambda w=w: F.silu(F.group_norm(  # noqa: E731
                torch.matmul(a16, w).float(), 32, eps=1e-5))
            run = lambda w=w: chain_link.chain_link(a, w, "gn-silu", out=o)  # noqa: E731
        else:
            library = lambda w=w: torch.matmul(a16, w).float()  # noqa: E731
            run = lambda w=w, mode=mode: chain_link.chain_link(a, w, mode, out=o)  # noqa: E731
        if hkw:  # the link's plain version on its int8 input, writing what it writes
            pkw = dict(out=xt.clone() if mode == "int8 last" else None,
                       update=mode == "int8 last", out_q=oq_t.clone(), a_q=a_q,
                       qinv_next=qnext, **rk)
            plain = lambda w=w, pkw=pkw: chain_link.chain_link_plain_into(  # noqa: E731
                None, w, "int8", **pkw)
        else:
            plain = lambda w=w, base=base, rk=rk: chain_link.chain_link_plain(  # noqa: E731
                a, w, base, **rk)
        cvariants.append(dict(
            shape=f"{mode} [512,1024]x[1024,1024]", max_abs_err=max(errs), ms=graph_ms(run),
            eager_ms=eager_ms(run), plain_ms=graph_ms(plain), library_ms=graph_ms(library),
            bound_ms=bms, bound_by=by))
    main_c = cvariants[0]
    rows.append(dict(name="chain_link", route="cuda", source=f"{CSRC}/chain_link.cu",
                     replaces=f"{TPU_MXU_KERNEL}; {TPU_ILP_KERNEL}",
                     replaces_part="mxu_micro.py:36-52 (one of the chain's matmuls, bf16 with "
                                   "fp32 or bf16 accumulation, or int8 with the requant) and "
                                   "ilp_probe.py:37-58 (matmul -> GN32 no affine -> SiLU), "
                                   "with the state update on a chain's last link",
                     main_loop=f"{CSRC}/dense_wgmma.cuh (bf16, bf16-out, gn-silu); "
                               f"{CSRC}/dense_wgmma_int8.cuh (int8 on the int8 copy the link "
                               f"before wrote); {CSRC}/dense_gemm_int8.cuh (int8, a call's "
                               f"first link)",
                     max_abs_err=max(v["max_abs_err"] for v in cvariants),
                     tol="1e-3*max(1,|ref|max); bf16-out 8e-3 (one bf16 ulp); int8 inner and "
                         "last links exact",
                     **{k: main_c[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by")},
                     library="torch.matmul bf16 (+ group_norm + silu); torch._int_mm int8 (+ "
                             "the rescale, update and requantization)",
                     variants=cvariants))
    for r in rows:
        kernel_row_line(r)
        for v in r["variants"]:
            print(f"    {v['shape']}: err {v['max_abs_err']:.3g}, {v['ms'] * 1e3:.2f} us "
                  f"(eager {v['eager_ms'] * 1e3:.2f}), plain {v['plain_ms'] * 1e3:.2f}, "
                  f"library {v['library_ms'] * 1e3:.2f}, bound {v['bound_ms'] * 1e3:.2f} us"
                  + (f" (fp32 in, no copy: {v['bound_ms_fp32_in'] * 1e3:.2f})"
                     if "bound_ms_fp32_in" in v else ""))
    print(f"[int8] K13's int8 copies: {copies}")
    return rows


def phase_int8_parity(model, dev, amax):
    """(iii) The int8 kernel sampler against its plain loop, N = 20, 500 rows,
    injected z and noise, per tensor and per channel: step by step under the
    bound phase 4 holds the bf16 sampler to (2e-2*max(1, |ref|max)), and the
    free-running trajectories reported."""
    n, shape = 20, (B, D)
    gen = torch.Generator(device=dev).manual_seed(12)
    z = torch.randn(shape, generator=gen, device=dev)
    noise = torch.randn((n, 1) + shape, generator=gen, device=dev)
    sde = SubVPSDE(N=n)
    out = {}
    for scheme in ("tensor", "channel"):
        kw = dict(quant="int8", act_amax=amax[scheme])
        net, coefs = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", dev,
                                                     **kw)
        sk, sp = (fused_em.pc_scratch(net, B, 0, dev) for _ in range(2))
        xp, step_err, step_tol = z.clone(), 0.0, 0.0
        fused_em.reset_launch_counts()
        for i in range(n):
            xk = xp.clone()
            fused_em.pc_step(net, coefs, i, xk, sk, noise[i], n_corr=0, snr=0.16)
            fused_em.pc_step(net, coefs, i, xp, sp, noise[i], n_corr=0, snr=0.16, plain=True)
            step_err = max(step_err, err(xk, xp))
            step_tol = max(step_tol, 2e-2 * max(1.0, float(xp.abs().max())))
        counts = fused_em.launch_counts()
        check(counts["dense_gn_silu_int8"] == 5 * n and counts["dense_gn_silu"] == 0,
              f"int8 sampler steps launched {counts}")
        check(step_err <= step_tol, f"int8 sampler step parity ({scheme}): {step_err} > "
                                    f"{step_tol}")
        got = fused_em.get_cuda_em_sampler(sde, model, shape, device=dev, **kw)(z=z, noise=noise)
        ref = fused_em.get_cuda_em_sampler(sde, model, shape, device=dev, plain=True,
                                           **kw)(z=z, noise=noise)
        bf16 = fused_em.get_cuda_em_sampler(sde, model, shape, device=dev)(z=z, noise=noise)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all().item(), f"int8 sampler ({scheme}): non-finite output")
        tol = 2e-2 * max(1.0, float(ref.abs().max()))
        row_err = (got - ref).abs().amax(1)
        out[f"int8_{scheme}"] = dict(
            step_max_abs_err=step_err, step_tol=step_tol, max_abs_err=float(row_err.max()),
            median_abs_err=float((got - ref).abs().median()),
            rows_within_tol=float((row_err <= tol).float().mean()), tol=tol,
            bf16_kernel_max_abs_err=float((got - bf16).abs().max()),
            bf16_kernel_median_abs_err=float((got - bf16).abs().median()))
        print(f"[parity] int8 {scheme}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in out[f"int8_{scheme}"].items()))
    return out


def timed_generation(sampler, gen):
    fused_em.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = sampler(gen)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, x, fused_em.launch_counts(), fused_em.route_counts()


def moments(x):
    a = x.double()
    return dict(mean=float(a.mean()), std=float(a.std()),
                corr_0_32=float(torch.corrcoef(torch.stack([a[:, 0], a[:, 32]]))[0, 1]))


def phase_int8_protocols(model, dev, amax, bf16_apd, bf16_c2_pc_mpjpe):
    """(iv) The int8 protocols on the pinned checkpoint: 500 x 1000 generation
    per tensor, per channel and int8-mixed beside bf16 (turns: bf16, channel,
    tensor, mixed, twice); the metrics protocol under per-channel int8 (APD in
    the band and within 0.03 of bf16's in this run); moments at 2,000 rows,
    per-channel int8 against the bf16 kernel route on one host-normal stream;
    completion2 pc under per-channel int8 (MPJPE in the band, within 15% of
    bf16 pc), hybrid per channel and per tensor reported."""
    config = get_config()
    sde = SubVPSDE(N=1000)
    res, by_run = {}, {}
    modes = {"bf16": {}, "int8_channel": dict(quant="int8", act_amax=amax["channel"]),
             "int8_tensor": dict(quant="int8", act_amax=amax["tensor"]),
             "int8_mixed": dict(quant="int8", act_amax=amax["tensor"], bf16_tail_steps=100)}
    samplers = {m: demo.build_sampler(config, sde, model, B, 1e-3, "none", dev, quant_kw=kw)
                for m, kw in modes.items()}
    gen = torch.Generator(device=dev).manual_seed(13)
    walls, routes = {m: [] for m in modes}, {}
    for _ in range(3):  # the first turn warms up
        for m, s in samplers.items():
            wall, x, counts, routes[m] = timed_generation(s, gen)
            walls[m].append(wall)
            check(x.shape == (B, D) and torch.isfinite(x).all().item(), f"generation {m}")
            by_run[f"generation_500x1000_{m}"] = counts
    for m in modes:
        best = min(walls[m][1:])
        res[f"generation_{m}"] = dict(poses_per_s=B / best, wall_s=best, walls_s=walls[m],
                                      launches=by_run[f"generation_500x1000_{m}"],
                                      k13_routes=routes[m]["dense_gn_silu_int8"])
        print(f"[int8] generation 500 x 1000 {m}: {B / best:.1f} poses/s best "
              f"(calls {['%.3f' % w for w in walls[m]]} s)")
    check(by_run["generation_500x1000_int8_channel"]["dense_gn_silu_int8"] == 5000 and
          by_run["generation_500x1000_int8_channel"]["dense_gn_silu"] == 0,
          "int8 generation did not run on K13")
    check(by_run["generation_500x1000_int8_mixed"]["dense_gn_silu_int8"] == 4500 and
          by_run["generation_500x1000_int8_mixed"]["dense_gn_silu"] == 500,
          "int8-mixed generation: 900 int8 steps and 100 bf16 steps")
    # which loop carried each int8 layer: the pre layer on the fp32 state (the
    # pre route), the four K = 1024 layers on the int8 handoff (the Hopper
    # int8 loop), none on the register-staged loop
    for m, want in (("int8_tensor", (4000, 1000, 0)), ("int8_channel", (4000, 1000, 0)),
                    ("int8_mixed", (3600, 900, 0))):
        got = routes[m]["dense_gn_silu_int8"]
        check((got["wgmma_int8"], got["pre_wgmma8"], got["register"]) == want,
              f"generation {m}: K13 routes {got}, expected wgmma_int8/pre_wgmma8/register "
              f"{want}")
    print("[int8] K13 routes a 500 x 1000 call: " + "; ".join(
        f"{m} {routes[m]['dense_gn_silu_int8']}" for m in modes if m != "bf16"))

    # the metrics protocol through the demo, per-channel int8
    smpl, _ = make_synthetic_body_model(os.path.join(OUT, "smpl_fixture.npz"), "smpl")
    fused_em.reset_launch_counts()
    r = demo.run(demo.parse_args(["--task", "generation", "--metrics", "--device", "cuda",
                                  "--ckpt-path", CKPT, "--stats-dir", STATS, "--smpl-path",
                                  smpl, "--output-path", os.path.join(OUT, "int8"),
                                  "--seed", "42", "--quant", "int8", "--quant-scheme",
                                  "channel"]))
    torch.cuda.synchronize()
    by_run["demo_generation_metrics_int8_channel"] = fused_em.launch_counts()
    apd = r["apd"]
    check(APD_BAND[0] <= apd <= APD_BAND[1] and abs(apd - bf16_apd) <= 0.03,
          f"int8 per-channel APD {apd}: outside {APD_BAND} or more than 0.03 from bf16's "
          f"{bf16_apd}")
    res["metrics_int8_channel"] = dict(apd=apd, bf16_apd=bf16_apd, wall_s=r["metrics_wall_s"],
                                       si_wall_s=r["si_wall_s"],
                                       launches=by_run["demo_generation_metrics_int8_channel"])
    print(f"[int8] metrics per-channel: APD {apd:.4f} (bf16 {bf16_apd:.4f}), protocol wall "
          f"{r['metrics_wall_s']:.2f} s (SI's {r['si_wall_s']:.2f} s included)")

    # moments at 2,000 rows on one host-normal stream (the fp32 tabled sampler
    # and per-tensor int8 reported beside them)
    shape = (2000, D)
    mom = {}
    for seed, names in ((33, ("fp32", "bf16", "int8_channel", "int8_tensor")),
                        (34, ("bf16", "int8_channel"))):
        for m in names:
            s = (tfs.get_fast_pc_sampler(sde, model, shape, device=dev) if m == "fp32" else
                 fused_em.get_cuda_em_sampler(sde, model, shape, rng_mode="host", device=dev,
                                              **modes[m]))
            fused_em.reset_launch_counts()
            x = s(torch.Generator(device=dev).manual_seed(seed))
            check(torch.isfinite(x).all().item(), f"moments {m}: non-finite samples")
            by_run[f"moments_2000x1000_{m}_seed{seed}"] = fused_em.launch_counts()
            mom[f"{m}_seed{seed}"] = moments(x)
    # tests/test_golden_pipeline.py:143-220 on its toy prior: mean and std within
    # 1e-2, corr(0, 32) within 5e-2. The bf16 kernels hold that against fp32. On
    # the pinned checkpoint per-channel int8 narrows the samples, std ~1.4% below
    # bf16's at both seeds, as JAX's own int8-chan APD lies 1.6% below its bf16
    # on the same checkpoint (PERFORMANCE.md:374-377): its std is held to 2e-2.
    f32, a = mom["fp32_seed33"], mom["bf16_seed33"]
    check(abs(a["mean"] - f32["mean"]) < 1e-2 and abs(a["std"] - f32["std"]) < 1e-2
          and abs(a["corr_0_32"] - f32["corr_0_32"]) < 5e-2,
          f"bf16 kernel moments {a} against fp32 {f32}")
    for seed in (33, 34):
        a, b = mom[f"bf16_seed{seed}"], mom[f"int8_channel_seed{seed}"]
        check(abs(a["mean"] - b["mean"]) < 1e-2 and abs(a["std"] - b["std"]) < 2e-2
              and abs(a["corr_0_32"] - b["corr_0_32"]) < 5e-2,
              f"int8 per-channel moments {b} against bf16 {a} (seed {seed})")
    res["moments_2000"] = mom
    print(f"[int8] moments at 2,000 rows: " + "; ".join(f"{k} {v}" for k, v in mom.items()))

    # completion2 under int8 through the demo
    smplx, _ = make_synthetic_body_model(os.path.join(OUT, "smplx_fixture.npz"), "smplx")
    poses_file = os.path.join(OUT, "synth_poses.npz")
    for name, extra in (("pc_int8_channel", ["--sampler", "pc", "--quant-scheme", "channel"]),
                        ("hybrid_int8_channel", ["--sampler", "hybrid", "--quant-scheme",
                                                 "channel"]),
                        ("hybrid_int8_tensor", ["--sampler", "hybrid"])):
        fused_em.reset_launch_counts()
        r = demo.run(demo.parse_args([
            "--task", "completion2", *extra, "--quant", "int8", "--device", "cuda",
            "--ckpt-path", CKPT, "--stats-dir", STATS, "--bodymodel-path", smplx,
            "--file-path", poses_file, "--part", PART, "--hypo", str(HYPO),
            "--output-path", os.path.join(OUT, name), "--seed", "42"]))
        torch.cuda.synchronize()
        by_run[f"demo_completion2_{name}"] = fused_em.launch_counts()
        check(np.isfinite(r["mpjpe"]) and np.isfinite(r["mpvpe"]), f"completion2 {name}")
        res[f"completion2_{name}"] = dict(mpjpe_mm=r["mpjpe"], mpvpe_mm=r["mpvpe"],
                                          launches=by_run[f"demo_completion2_{name}"])
        print(f"[int8] demo completion2 {name}: MPJPE {r['mpjpe']:.1f} mm, MPVPE "
              f"{r['mpvpe']:.1f} mm")
    pc = res["completion2_pc_int8_channel"]
    check_bands("completion2 pc int8 per-channel", pc["mpjpe_mm"], pc["mpvpe_mm"])
    check(abs(pc["mpjpe_mm"] / bf16_c2_pc_mpjpe - 1.0) <= 0.15,
          f"completion2 pc int8 per-channel MPJPE {pc['mpjpe_mm']} more than 15% from "
          f"bf16's {bf16_c2_pc_mpjpe}")
    pc["bf16_mpjpe_mm"] = bf16_c2_pc_mpjpe
    return dict(results=res, by_run=by_run)


def phase_microbenchmarks():
    """(v) Both microbenchmarks end to end at 100 chain steps: every row and
    split, finite checksums, splits bit-identical to the whole run."""
    args = ["--steps", "100", "--m-pipe", "2", "--rounds", "2"]
    fused_em.reset_launch_counts()
    t0 = time.perf_counter()
    mxu = mxu_micro.main(args)
    ilp = ilp_probe.main(args)
    torch.cuda.synchronize()
    counts = fused_em.launch_counts()
    check(all(np.isfinite(r["checksum"]) and r["ms"] > 0 for r in mxu), "mxu_micro rows")
    check([s["bitwise_equal_whole"] for s in ilp] == [None, True, True],
          f"ilp_probe: splits not bit-identical to the whole run: {ilp}")
    wall = time.perf_counter() - t0
    # the int8 chain hands q(h) on from link to link: after 100 steps its
    # state is bit-equal to the plain chain's; one link a call on the
    # register-staged loop (the first), every other on the Hopper int8 loop
    x0, ws, ws_i8 = mxu_micro.make_inputs(torch.device("cuda", 0), mxu_micro.B, mxu_micro.H)
    fused_em.reset_launch_counts()
    got = mxu_micro.run_row("int8", x0, ws, ws_i8, 100)
    torch.cuda.synchronize()
    routes = fused_em.route_counts()["chain_link"]
    want = mxu_micro.run_row("int8", x0, ws, ws_i8, 100, link=chain_link.chain_link_plain_into)
    check(torch.equal(got, want), "[micro] the int8 chain after 100 steps is not bit-equal to "
                                  "the plain chain")
    check(routes == {"wgmma": 0, "wgmma_int8": 6 * 100 - 1, "register": 1},
          f"[micro] int8 chain routes {routes}")
    print(f"[micro] both microbenchmarks in {wall:.1f} s, launches {counts['chain_link']}; "
          f"the int8 chain after 100 steps bit-equal to the plain chain (routes {routes})")
    return dict(results=dict(mxu_micro=mxu, ilp_probe=ilp, wall_s=wall,
                             int8_chain_bit_equal_plain=True, int8_chain_routes=routes),
                by_run=dict(microbenchmarks=counts))


# ---------------------------------------------------------------------------
# training: K10-K12 and the trainer CLI
# ---------------------------------------------------------------------------

def train_operands(model, dev, seed=9):
    """The kernels' operands of one flagship train step: 1,280 normalized
    synthetic poses, t and z drawn from ``seed``, the pinned weights."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = normalized_synthetic_poses(BT, dev)
    t = torch.rand(BT, generator=gen, device=dev) * (1 - 1e-5) + 1e-5
    z = torch.randn(BT, D, generator=gen, device=dev)
    loss_fn = fused_train.get_cuda_train_loss_fn(SubVPSDE(N=1000), model, reduce_mean=True)
    return batch, t, z, loss_fn.operands(batch, t, z)


def library_layer(a, w, proj, gamma, beta, res, cot):
    """autograd's bf16 layer through matmul, group_norm, silu and dropout:
    ``(forward, forward + backward)`` as callables."""
    a_l, w_l = a.to(torch.bfloat16).requires_grad_(True), w.clone().requires_grad_(True)
    g_l, b_l = gamma.clone().requires_grad_(True), beta.clone().requires_grad_(True)

    def fwd():
        y = torch.matmul(a_l, w_l).float() + proj.float()
        y = F.dropout(F.silu(F.group_norm(y, 32, g_l, b_l, eps=1e-5)), 0.1, True)
        return y if res is None else y + res

    def fwd_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(fwd(), (a_l, w_l, g_l, b_l), cot)

    return fwd, fwd_bwd


def repeats_bit_identical(fn, outs, what, n=REPEATS):
    """``fn()`` ``n`` more times: each call's tensors must equal ``outs``'s
    (Nones skipped) bit for bit."""
    ref = [None if t is None else t.clone() for t in outs]
    for _ in range(n):
        again = fn()
        check(all(r is None or torch.equal(r, t) for r, t in zip(ref, again)),
              f"{what}: {n} repeated calls are not bit-identical")


def phase_train_kernels(model, dev):
    """K10, K11 and K12 at the flagship train step's shapes (batch 1,280), with
    dropout 0.1 and the plain version's mask, against their plain versions,
    with timings and bounds. The inputs are a real step's: the plain chain's
    activations on the pinned weights. K10 runs each layer kind on the route
    a step takes it (the pre layer from fp32 A on the register route, the K =
    1024 layers from the bf16 stash on the Hopper route, a block's first
    layer without its fp32 output) and, beside them, the K = 1024 layers on
    the register route from fp32 A and the first layer writing its output;
    each bound is given at the route's bytes and at fp32 A."""
    _, _, _, op = train_operands(model, dev)
    keep, seed = op["keep"], 20261016
    W, Wb, P, gw, gb = op["w_fwd"], op["w_bwd"], op["proj"], op["gn_w"], op["gn_b"]
    plain_f, plain_b = fused_train.dense_gn_silu_train_plain, fused_train.dense_gn_silu_bwd_plain
    fwd = [plain_f(op["x_pert"], W[0], P[0], gw[0], gb[0], seed, 0, keep)]
    for j in range(1, 5):
        a, res = fwd[-1][0], (fwd[j - 2][0] if j % 2 == 0 else None)
        fwd.append(plain_f(a, W[j], P[j], gw[j], gb[j], seed, j, keep, res))
    rows, extra = [], {}

    # K10: the three layer kinds of a step on its routes, then the others
    variants, lib_by_j = [], {}
    for label, j, route, write_out in (
            ("pre [1280,63]x[63,1024]", 0, "register", True),
            ("block [1280,1024]x[1024,1024], no fp32 out", 1, "wgmma", False),
            ("block+residual [1280,1024]x[1024,1024]", 2, "wgmma", True),
            ("last [1280,1024]x[1024,1024]+residual, no fp32 out", 4, "wgmma", False),
            ("block-with-out [1280,1024]x[1024,1024]", 1, "wgmma", True),
            ("register-block [1280,1024]x[1024,1024]", 1, "register", True),
            ("register-block+residual [1280,1024]x[1024,1024]", 2, "register", True)):
        a = op["x_pert"] if j == 0 else fwd[j - 1][0]
        a_b = fwd[j - 1][1] if route == "wgmma" else None  # the stash of the layer before
        res = fwd[j - 2][0] if j in (2, 4) else None
        args = (W[j], P[j], gw[j], gb[j], seed, j, keep)
        ref = plain_f(a, *args, res)
        a_in = None if a_b is not None else a
        fused_em.reset_launch_counts()
        got = fused_train.dense_gn_silu_train(a_in, *args, residual=res, a_b=a_b,
                                              write_out=write_out)
        torch.cuda.synchronize()
        check(fused_em.route_counts()["dense_gn_silu_train"][route] == 1,
              f"dense_gn_silu_train {label}: not on the {route} route")
        e_out, tol = ((err(got[0], ref[0]), 1e-3 * max(1.0, float(ref[0].abs().max())))
                      if write_out else (0.0, 0.0))
        e_bf = [err(g.float(), r.float()) for g, r in zip(got[1:3], ref[1:3])]
        tol_bf = [1e-2 * max(1.0, float(r.float().abs().max())) for r in ref[1:3]]
        e_rs = float(((got[3] - ref[3]).abs() / ref[3]).max())
        check(e_out <= tol and all(x <= y for x, y in zip(e_bf, tol_bf)) and e_rs <= 1e-3,
              f"dense_gn_silu_train {label}: out {e_out} (tol {tol}), stash/xhat {e_bf} "
              f"(tol {tol_bf}), rstd rel {e_rs}")
        # the kernel applied the plain version's mask: every dropped element
        # is the residual alone (the kept ones are held by the tolerance);
        # without the fp32 out the stash shows it, the residual rounded
        dropped = ~fused_train.dropout_keep(seed, j, BT, H, keep, dev)
        base = torch.zeros(BT, H, device=dev) if res is None else res
        shown = got[0] if write_out else got[1].float()
        if not write_out:
            base = base.to(torch.bfloat16).float()
        check(torch.equal(shown[dropped], base[dropped]),
              f"dense_gn_silu_train {label}: another dropout mask")
        bufs = [torch.empty_like(x) for x in ref]
        if not write_out:
            bufs[0] = None
        run = lambda: fused_train.dense_gn_silu_train(  # noqa: E731
            a_in, *args, residual=res, out=bufs[0], stash=bufs[1], xhat=bufs[2], rstd=bufs[3],
            a_b=a_b, write_out=write_out)
        repeats_bit_identical(run, run(), f"dense_gn_silu_train {label}")
        K = a.shape[1]
        rest = (2 * K * H + 2 * BT * H + 2 * 4 * H + (4 * BT * H if write_out else 0)
                + 2 * 2 * BT * H + 4 * BT * 32 + (4 * BT * H if res is not None else 0))
        bms, by = bound((2 if a_b is not None else 4) * BT * K + rest, 2 * BT * K * H, 40 * BT * H)
        bms_fp32, _ = bound(4 * BT * K + rest, 2 * BT * K * H, 40 * BT * H)
        if j not in lib_by_j:
            lib_fwd, lib_fwd_bwd = library_layer(a, W[j], P[j], gw[j], gb[j], res,
                                                 torch.randn_like(ref[0]))
            lib_by_j[j] = (graph_ms(lib_fwd), profiled_ms(lib_fwd_bwd))
        variants.append(dict(shape=label, route=route, writes_out=write_out,
                             max_abs_err=e_out, tol=tol, errs_stash_xhat=e_bf,
                             rstd_rel_err=e_rs, repeats_bit_identical=REPEATS,
                             ms=graph_ms(run), eager_ms=eager_ms(run),
                             plain_ms=graph_ms(lambda: plain_f(a, *args, res)),
                             library_ms=lib_by_j[j][0], library_fwd_bwd_ms=lib_by_j[j][1],
                             bound_ms=bms, bound_by=by, bound_fp32_a_ms=bms_fp32))
    main_v = variants[2]
    rows.append(dict(name="dense_gn_silu_train", route="cuda",
                     source=f"{CSRC}/dense_gn_silu_train.cu", replaces=TPU_TRAIN_KERNEL,
                     replaces_part="fused_train.py:80 _make_kernel stack_fwd (:132-149), "
                                   "stash_in (:170-176)",
                     max_abs_err=max(v["max_abs_err"] for v in variants),
                     tol="out 1e-3*max(1,|ref|max); stash, xhat 1e-2*max(1,|ref|max) "
                         "(a bf16 ulp); rstd 1e-3 relative; the same dropout mask; "
                         f"{REPEATS} repeated calls bit-identical",
                     **{k: main_v[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by",
                                               "bound_fp32_a_ms")},
                     library="bf16 matmul + group_norm + silu + dropout, forward",
                     variants=variants))

    # K11: the head and the loss seed on the last layer's bf16 stash, as the
    # step hands it over, and beside it on the fp32 h (the same bits)
    h4, h4_b = fwd[4][0], fwd[4][1]
    rest11 = (op["wpost_k"], op["bpost"], op["coefs"], op["z"])
    args11 = (h4_b,) + rest11
    ref = fused_train.head_dsm_plain(h4, *rest11)
    got = fused_train.head_dsm(*args11)
    got32 = fused_train.head_dsm(h4, *rest11)
    torch.cuda.synchronize()
    e_loss = float(((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1e-12)).max())
    e_dout, tol_dout = err(got[1], ref[1]), 1e-3 * float(ref[1].abs().max())
    check(e_loss <= 1e-3 and e_dout <= tol_dout,
          f"head_dsm: loss rows rel {e_loss}, dout {e_dout} (tol {tol_dout})")
    check(all(torch.equal(a, b) for a, b in zip(got, got32)),
          "head_dsm: the bf16 stash and fp32 h give different bits")
    for what, hh in (("the stash", h4_b), ("fp32 h", h4)):
        repeats_bit_identical(lambda hh=hh: fused_train.head_dsm(hh, *rest11), got,
                              f"head_dsm on {what}")
    other = 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS + 3 * 4 * BT + 2 * 4 * BT * D \
        + 4 * BT
    bms, by = bound(2 * BT * H + other, 2 * BT * H * score_net.HEAD_COLS, 8 * BT * D)
    bms32, _ = bound(4 * BT * H + other, 2 * BT * H * score_net.HEAD_COLS, 8 * BT * D)
    lr_b, do_b = torch.empty_like(ref[0]), torch.empty_like(ref[1])
    run11 = lambda hh=h4_b: fused_train.head_dsm(hh, *rest11, loss_rows=lr_b,  # noqa: E731
                                                  dout=do_b)
    wk, bk16 = op["wpost_k"], op["bpost"].to(op["wpost_k"].dtype)
    ca, cv, cs = (op["coefs"][:, c:c + 1] for c in range(3))

    def dsm_library():  # composite on the stash: addmm + the DSM loss rows and their gradient
        out = torch.addmm(bk16, h4_b, wk)[:, :D].float()
        r = torch.addcmul(cv * op["z"], ca, out)
        return (r * r).sum(1) * cs[:, 0], 2.0 * cs * ca * r

    lib11_e = [float((a - b).abs().max()) for a, b in zip(dsm_library(), ref)]
    rows.append(dict(
        name="head_dsm", route="cuda", source=f"{CSRC}/head_dsm.cu", replaces=TPU_TRAIN_KERNEL,
        replaces_part="fused_train.py:177-188 (post-dense, the DSM loss rows, dout)",
        shape="[1280,1024] bf16 stash x [1024,63]", max_abs_err=e_dout,
        tol="loss rows 1e-3 relative; dout 1e-3*|ref|max; the stash and fp32 h bit-equal; "
            f"{REPEATS} repeated calls bit-identical", loss_rows_rel_err=e_loss,
        cluster=cluster_launch("head_dsm", BT, H, 1)["cluster"], repeats_bit_identical=REPEATS,
        stash_bit_equal_fp32_h=True, ms=graph_ms(run11), eager_ms=eager_ms(run11),
        fp32_h_ms=graph_ms(lambda: run11(h4)),
        plain_ms=graph_ms(lambda: fused_train.head_dsm_plain(*args11)),
        library_ms=graph_ms(dsm_library), library_max_abs_err_loss_dout=lib11_e,
        library="composite on the stash: torch.addmm in w_post's type + the DSM loss rows "
                "and dout",
        bound_ms=bms, bound_by=by, bound_fp32_h_ms=bms32))
    print(f"[kernel] head_dsm: clusters of {rows[-1]['cluster']} {rows[-1]['ms'] * 1e3:.2f} us on "
          f"the stash ({rows[-1]['fp32_h_ms'] * 1e3:.2f} on fp32 h), bit-equal; {REPEATS} "
          f"repeated calls bit-identical")

    # K12: the first hop (the zero-padded dout), and a hidden hop without and
    # with the residual stream's carried gradient
    dpad = torch.zeros(BT, score_net.HEAD_COLS, dtype=torch.bfloat16, device=dev)
    dpad[:, :D] = ref[1]
    chain = {4: plain_b(dpad, op["wpost_t"], fwd[4][2], fwd[4][3], gw[4], gb[4], seed, 4, keep)}
    chain[3] = plain_b(chain[4][0], Wb[3], fwd[3][2], fwd[3][3], gw[3], gb[3], seed, 3, keep)
    variants = []
    for label, j, A, Wt, g_res in (
            ("hop 1 [1280,64]x[64,1024]", 4, dpad, op["wpost_t"], None),
            ("hidden [1280,1024]x[1024,1024]", 3, chain[4][0], Wb[3], None),
            ("hidden+g_res [1280,1024]x[1024,1024]", 2, chain[3][0], Wb[2], chain[4][1])):
        with_out = j % 2 == 0
        args = (A, Wt, fwd[j][2], fwd[j][3], gw[j], gb[j], seed, j, keep)
        ref = plain_b(*args, g_res)
        g_out = torch.empty(BT, H, device=dev) if with_out else None
        fused_em.reset_launch_counts()
        got = fused_train.dense_gn_silu_bwd(*args, g_res=g_res, g_out=g_out)
        torch.cuda.synchronize()
        e_dh, tol_dh = err(got[0].float(), ref[0].float()), 1e-2 * float(ref[0].float().abs().max())
        e_g = [err(got[1], ref[1]) if with_out else 0.0] + [err(a, b)
                                                            for a, b in zip(got[2:], ref[2:])]
        tol_g = [1e-3 * float(ref[1].abs().max())] + [1e-3 * float(b.abs().max())
                                                       for b in ref[2:]]
        check(e_dh <= tol_dh and all(x <= y for x, y in zip(e_g, tol_g)),
              f"dense_gn_silu_bwd {label}: dh {e_dh} (tol {tol_dh}), g/dgamma/dbeta {e_g} "
              f"(tol {tol_g})")
        check(fused_em.route_counts()["dense_gn_silu_bwd"]["wgmma"] >= 1,
              f"dense_gn_silu_bwd {label}: not on the Hopper route")
        repeats_bit_identical(lambda: fused_train.dense_gn_silu_bwd(*args, g_res=g_res,
                                                                    g_out=g_out), got,
                              f"dense_gn_silu_bwd {label}")
        K = A.shape[1]
        n_bytes = (2 * BT * K + 2 * K * H + 2 * BT * H + 4 * BT * 32 + 2 * 4 * H + 2 * BT * H
                   + (4 * BT * H if g_res is not None else 0) + (4 * BT * H if with_out else 0)
                   + 2 * 4 * H)
        bms, by = bound(n_bytes, 2 * BT * K * H, 40 * BT * H)
        dh_b = torch.empty_like(ref[0])
        run = lambda: fused_train.dense_gn_silu_bwd(*args, g_res=g_res,  # noqa: E731
                                                    g_out=g_out, dh=dh_b)
        variants.append(dict(shape=label, max_abs_err=e_dh, tol=tol_dh, errs_g_dgamma_dbeta=e_g,
                             tols_g_dgamma_dbeta=tol_g, ms=graph_ms(run), eager_ms=eager_ms(run),
                             plain_ms=graph_ms(lambda: plain_b(*args, g_res)),
                             bound_ms=bms, bound_by=by))
    # the library's backward of one layer: its forward + backward less its forward
    lib = {v["shape"].split()[0]: v for v in rows[0]["variants"]}
    check(set(lib) >= {"pre", "block", "block+residual"}, f"K10 variants {sorted(lib)}")
    for v, k10 in zip(variants, ("pre", "block", "block+residual")):
        v["library_ms"] = max(0.0, lib[k10]["library_fwd_bwd_ms"] - lib[k10]["library_ms"])
    main_v = variants[2]
    rows.append(dict(name="dense_gn_silu_bwd", route="cuda", source=f"{CSRC}/dense_gn_silu_bwd.cu",
                     replaces=TPU_TRAIN_KERNEL,
                     replaces_part="fused_train.py:151-166 stack_bwd with the mm(., W^T) hops "
                                   "of :193-206",
                     max_abs_err=max(v["max_abs_err"] for v in variants),
                     tol="dh 1e-2*|ref|max (a bf16 ulp); g, dgamma, dbeta 1e-3*|ref|max; "
                         f"dh, g, dgamma, dbeta bit-identical over {REPEATS} repeated calls",
                     **{k: main_v[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by")},
                     library="autograd's backward of the bf16 matmul + group_norm + silu + "
                             "dropout layer: its forward + backward's device time (profiler) "
                             "less its forward's (graph replay)",
                     variants=variants))
    for r in rows:
        kernel_row_line(r)
    return rows


def grad_agreement(grads, ref):
    """Per leaf ``(cosine, relative error)``; leaves the loss does not reach
    (zero in both) are skipped."""
    out = {}
    for n, g in grads.items():
        r = ref.get(n)
        if r is None or float(r.norm()) == 0.0:
            continue
        a, b = g.flatten().double(), r.flatten().double()
        out[n] = (float(a @ b / (a.norm() * b.norm() + 1e-30)),
                  float((a - b).norm() / (b.norm() + 1e-30)))
    return out


def route_agreement(model, dev):
    """The kernel route's loss and gradient leaves against the fp32 autograd
    route's on one batch of 1,280 poses with the same t and z, dropout 0 (the
    routes' dropout streams differ), and the kernel step's K10 and K12 routes."""
    m0 = copy.deepcopy(model).train()
    m0.dropout.p = 0.0
    batch, t, z, _ = train_operands(m0, dev)
    sde = SubVPSDE(N=1000)
    fused_em.reset_launch_counts()
    loss_k, grads_k = fused_train.get_cuda_train_loss_and_grad(sde, m0, reduce_mean=True)(
        batch, t=t, z=z, dropout_seed=1)
    torch.cuda.synchronize()
    # one step's routes: K10's four K = 1024 layers from the stash, the pre
    # layer from fp32 A; K12's five hops on the Hopper loop
    routes = {k: v for k, v in fused_em.route_counts().items()
              if k in ("dense_gn_silu_train", "dense_gn_silu_bwd")}
    check(routes == {"dense_gn_silu_train": {"wgmma": 4, "register": 1},
                     "dense_gn_silu_bwd": {"wgmma": 5}}, f"train step routes {routes}")
    named = [(n, p) for n, p in m0.named_parameters() if p.requires_grad]
    loss_r = tlosses.get_sde_loss_fn(sde, True, tlosses.make_model_apply(m0), reduce_mean=True)(
        tlosses.params_of(m0), batch, t=t, z=z)
    grads_r = torch.autograd.grad(loss_r, [p for _, p in named], allow_unused=True)
    ref = {n: g for (n, _), g in zip(named, grads_r) if g is not None}
    torch.cuda.synchronize()
    agree = grad_agreement(grads_k, ref)
    return dict(loss_kernel=float(loss_k), loss_fp32=float(loss_r.detach()), step_routes=routes,
                loss_rel_err=abs(float(loss_k) / float(loss_r.detach()) - 1.0),
                worst_cosine=min(agree.items(), key=lambda kv: kv[1][0]),
                worst_rel=max(agree.items(), key=lambda kv: kv[1][1]), leaves=agree)


def phase_train_parity(model, dev):
    """The kernel route against the fp32 autograd route at flagship width and
    batch 1,280 on a seeded init, as the JAX package holds its bf16 train
    kernel (an untrained net): loss to 3e-3 relative, each leaf at cosine >
    0.995 and relative error < 0.12. On the pinned trained weights the same
    comparison is reported, not gated: there a leaf whose gradient is a sum
    that cancels (a bias, a GroupNorm shift) is bf16 rounding noise."""
    torch.manual_seed(0)
    init = create_score_model(get_config()).to(dev)
    out = {}
    for name, m in (("seeded_init", init), ("pinned", model)):
        r = route_agreement(m, dev)
        print(f"[train parity] {name}: kernel route vs fp32 autograd at [1280, 1024]: loss "
              f"{r['loss_kernel']:.6f} vs {r['loss_fp32']:.6f} (rel {r['loss_rel_err']:.2e}), "
              f"worst cosine {r['worst_cosine'][1][0]:.6f} ({r['worst_cosine'][0]}), worst "
              f"relative error {r['worst_rel'][1][1]:.4f} ({r['worst_rel'][0]}); a step's "
              f"routes {r['step_routes']}")
        out[name] = r
    r = out["seeded_init"]
    check(r["loss_rel_err"] <= 3e-3, f"train parity: loss relative error {r['loss_rel_err']}")
    bad = {n: v for n, v in r["leaves"].items() if not (v[0] > 0.995 and v[1] < 0.12)}
    check(not bad, f"train parity: leaves outside cosine > 0.995, rel < 0.12: {bad}")
    return out


TRAIN_CONFIG = """
from dposer_tpu_torch.config import get_config as _base


def get_config():
    c = _base()
    c.OUTPUT_DIR = {out!r}
    c.training.n_iters, c.training.log_freq = {n_iters}, 100
    c.training.eval_freq, c.training.save_freq = 10 ** 9, {save_freq}
    return c
"""


MH_CONFIG = """
from dposer_tpu_torch.config import get_config as _base


def get_config():
    c = _base()
    c.OUTPUT_DIR = {out!r}
    c.training.n_iters, c.training.log_freq = {n_iters}, 1
    c.training.eval_freq, c.training.save_freq = {eval_freq}, 10 ** 9
    return c
"""


def device_kernel_us(prof):
    """``(total, {name: total})`` µs of the device kernels in a profiler
    trace; user annotations (their spans cover other kernels) are left out."""
    total, by_name = 0.0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        us = e.time_range.end - e.time_range.start
        total += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    return total, by_name


def profiled_ms(fn, n=20):
    """Device time of one ``fn()`` from a profiler trace of ``n`` calls (the
    kernels alone, the host's gaps not counted): for callables that a CUDA
    graph cannot capture, such as an autograd backward."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, _ = device_kernel_us(prof)
    check(total > 0, "the profiler recorded no device time")
    return total / 1e3 / n


def profile_train_steps(state, data, dev, n=20):
    """Device busy share of ``n`` kernel-route steps from a torch.profiler
    trace: the sum of the kernels' device time over the wall. None where the
    profiler records no device time."""
    step_fn = fused_train.get_cuda_step_fn(SubVPSDE(N=1000), state.model, reduce_mean=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    idx = [torch.randint(0, data.shape[0], (BT,), generator=gen, device=dev) for _ in range(n)]
    for i in range(3):
        step_fn(state, data[idx[i]], generator=gen, dropout_seed=i)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step_fn(state, data[idx[i]], generator=gen, dropout_seed=100 + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us, by_name = device_kernel_us(prof)
    if dev_us == 0.0:
        return dict(wall_ms_per_step=wall * 1e3 / n, device_ms_per_step=None,
                    note="the profiler recorded no device time")
    top = sorted(((k, v / n) for k, v in by_name.items()), key=lambda kv: -kv[1])[:16]
    return dict(wall_ms_per_step_profiled=wall * 1e3 / n, device_ms_per_step=dev_us / 1e3 / n,
                kernels_per_step=sum(1 for e in prof.events() if e.device_type ==
                                     torch.autograd.DeviceType.CUDA
                                     and not e.is_user_annotation) / n,
                top_kernels_us_per_step=top)


def phase_train_protocols(dev):
    """The trainer CLI's entry point (``dposer_tpu_torch.train.main``) on a
    synthetic AMASS layout (``benchmarks/gen_synth_amass.py --seed 0``, 200,000
    train rows): (a) a 500-step fine-tune of the pinned checkpoint, batch 1,280,
    kernel route, loss and APD in their bands; (b) 1,000 steps from one seeded
    init through each route on the same batches; (c) 200 steps against 100 and
    a resume of 100. Checkpoints and data are deleted after; the logs stay."""
    os.makedirs(OUT, exist_ok=True)
    os.environ["DPOSER_TENSORBOARD"] = "0"
    work = tempfile.mkdtemp(prefix="train_", dir=OUT)
    by_run, res = {}, {}
    try:
        data_root = os.path.join(work, "amass")
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.join(REPO, "benchmarks", "gen_synth_amass.py"),
                            "--seed", "0", "--train-n", "200000", "--test-n", "1000",
                            "--root", data_root, "--version", "v1"], capture_output=True,
                           text=True, timeout=300)
        check(p.returncode == 0, f"gen_synth_amass failed: {p.stderr[-2000:]}")
        res["data_s"] = time.perf_counter() - t0

        def run(name, n_iters, *extra, save_freq=10 ** 9):
            cfg = os.path.join(work, f"{name}.py")
            with open(cfg, "w") as f:
                f.write(TRAIN_CONFIG.format(out=os.path.join(work, "out"), n_iters=n_iters,
                                            save_freq=save_freq))
            fused_em.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = train_cli.main(["--config", cfg, "--dataset-folder", data_root, "--version", "v1",
                                "--bodymodel-path", "", "--name", name, "--device",
                                TRAIN_DEVICE, "--steps-per-dispatch", str(FT_STEPS // 5),
                                *extra])
            torch.cuda.synchronize()
            r["wall_s"] = time.perf_counter() - t0
            by_run[f"train_{name}"] = fused_em.launch_counts()
            shutil.copy(os.path.join(r["output_dir"], "train.log"),
                        os.path.join(OUT, f"train_{name}.log"))
            # the first window warms up, where there is more than one
            ms = [1e3 * s / k for k, s in (r["windows"][1:] or r["windows"])]
            r["ms_per_step_best"], r["ms_per_step_median"] = min(ms), float(np.median(ms))
            r["ms_per_step_windows"] = ms
            return r

        # (a) fine-tune the pinned checkpoint, 500 kernel steps
        a = run("finetune", 400000 + FT_STEPS, "--restore-dir", CKPT)
        check(a["route"].startswith("kernel step: K10/K11/K12 on CUDA"), f"route {a['route']}")
        last = float(np.mean(a["losses"][-100:]))
        check(a["step"] == 400000 + FT_STEPS and 0.10 <= last <= 0.50,
              f"fine-tune: step {a['step']}, last-100 mean loss {last} outside [0.10, 0.50]")
        data_dev = torch.as_tensor(np.load(os.path.join(data_root, "v1", "train",
                                                         "pose_body.npy")), device=dev)
        prof = profile_train_steps(a["state"], data_dev, dev)
        if prof["device_ms_per_step"] is not None:  # against the unprofiled best step
            prof["device_busy_share"] = prof["device_ms_per_step"] / a["ms_per_step_best"]
        # APD of 500 samples of the fine-tuned EMA through the kernel EM sampler
        config = get_config()
        model = create_score_model(config).to(dev).eval()
        sd = a["state"].model.state_dict()
        names = [n for n, q in a["state"].model.named_parameters() if q.requires_grad]
        sd.update(zip(names, a["state"].ema.shadow_params))
        model.load_state_dict(sd)
        normalizer = PoseNormalizer(os.path.join(data_root, "v1", "train"),
                                    normalize=config.data.normalize, min_max=config.data.min_max,
                                    rot_rep=config.data.rot_rep, device=dev)
        fused_em.reset_launch_counts()
        with torch.no_grad():
            sampler = demo.build_sampler(config, SubVPSDE(N=1000), model, demo.METRICS_SAMPLE_NUM,
                                         demo.METRICS_EPS, "langevin", dev)
            gen = torch.Generator(device=dev).manual_seed(42)
            samples = normalizer.offline_denormalize(sampler(gen), to_axis=True)
            smpl, _ = make_synthetic_body_model(os.path.join(work, "smpl.npz"), "smpl")
            body = BodyModel(smpl, num_betas=10, model_type="smpl", device=dev)
            pose = torch.cat([samples, torch.zeros(len(samples), 6, device=dev)], 1)
            apd = float(average_pairwise_distance(body(pose_body=pose).Jtr[:, :22]))
        torch.cuda.synchronize()
        by_run["train_finetune_apd"] = fused_em.launch_counts()
        check(APD_BAND[0] <= apd <= APD_BAND[1], f"fine-tune APD {apd} outside {APD_BAND}")
        res["finetune"] = dict(steps=FT_STEPS, batch=BT, route=a["route"], last100_loss=last,
                               apd=apd, wall_s=a["wall_s"],
                               ms_per_step_best=a["ms_per_step_best"],
                               ms_per_step_median=a["ms_per_step_median"],
                               ms_per_step_windows=a["ms_per_step_windows"],
                               steps_per_s_best=1e3 / a["ms_per_step_best"], profile=prof,
                               loss_first10=a["losses"][:10], launches=by_run["train_finetune"])
        print(f"[train] (a) fine-tune 500 x {BT}: {a['ms_per_step_best']:.3f} ms/step best "
              f"({1e3 / a['ms_per_step_best']:.1f} steps/s; windows "
              f"{['%.3f' % m for m in a['ms_per_step_windows']]}), last-100 loss {last:.4f}, "
              f"APD {apd:.4f}; profiler {prof.get('device_ms_per_step')} ms of device time "
              f"a step, busy {prof.get('device_busy_share')}")

        # (b) 1,000 steps from one seeded init through each route
        routes = {}
        for route in ("on", "off"):
            r = run(f"scratch_{route}", SCRATCH_STEPS, "--train-kernel", route)
            routes[route] = dict(route=r["route"], last100_loss=float(np.mean(r["losses"][-100:])),
                                 loss_at=[r["losses"][i - 1] for i in (50, 100, 500, 1000)
                                          if i <= SCRATCH_STEPS],
                                 ms_per_step_best=r["ms_per_step_best"],
                                 ms_per_step_median=r["ms_per_step_median"], wall_s=r["wall_s"],
                                 launches=by_run[f"train_scratch_{route}"])
        lk, la = routes["on"]["last100_loss"], routes["off"]["last100_loss"]
        gap = abs(lk - la) / max(lk, la)
        check(lk < 40 and la < 40 and gap <= 0.25,
              f"from scratch: last-100 losses kernel {lk}, autograd {la} (gap {gap})")
        res["scratch"] = dict(routes=routes, gap=gap)
        print(f"[train] (b) 1,000 steps from scratch: last-100 loss kernel {lk:.3f}, fp32 "
              f"autograd {la:.3f} (gap {100 * gap:.1f}%); ms/step best kernel "
              f"{routes['on']['ms_per_step_best']:.3f}, autograd {routes['off']['ms_per_step_best']:.3f}")

        # (c) 200 steps against 100 and a resume of 100
        half = RESUME_STEPS // 2
        whole = run("resume_whole", RESUME_STEPS, "--train-kernel", "on", save_freq=half)
        first = next(p for p in whole["checkpoints"] if p.endswith(f"checkpoint-step{half}.pth"))
        resumed = run("resume_tail", RESUME_STEPS, "--train-kernel", "on", "--restore-dir", first)
        diffs = [float((a_ - b_).abs().max()) for a_, b_ in
                 zip(whole["state"].model.parameters(), resumed["state"].model.parameters())]
        ema_d = [float((a_ - b_).abs().max()) for a_, b_ in
                 zip(whole["state"].ema.shadow_params, resumed["state"].ema.shadow_params)]
        check(resumed["step"] == RESUME_STEPS and max(diffs) <= 1e-6 and max(ema_d) <= 1e-6,
              f"resume: parameters differ by {max(diffs)}, EMA by {max(ema_d)}")
        res["resume"] = dict(max_param_diff=max(diffs), max_ema_diff=max(ema_d))
        print(f"[train] (c) 200 steps against 100 + a resume of 100: parameters differ by "
              f"{max(diffs):.3g}, EMA by {max(ema_d):.3g}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(results=res, by_run=by_run)


# ---------------------------------------------------------------------------
# (q) data-parallel training: K10 and K12 at a row offset, two ranks on the
# card, the trainer's --multihost and its eval graphs, sharded fitting
# ---------------------------------------------------------------------------

def row_offset_checks(model, dev):
    """(q)(i) K10 (both routes) and K12 on rows ROW_OFFSET:1280 of the train
    step's shapes at ``row_offset=ROW_OFFSET`` against rows ROW_OFFSET:1280
    of the full launch, bit for bit (K10's out, stash, xhat and rstd; K12's
    dh and g); K12's dgamma and dbeta of the two halves summed against the
    full launch's within DP_SUM_TOL x max(1, |full|max) (the halves' row
    blocks are added in another order); each half launch against its plain
    version at the offset with ``phase_train_kernels``' tolerances; and the
    device time of each at 640 rows beside 1,280."""
    _, _, _, op = train_operands(model, dev)
    keep, seed, h = op["keep"], 20261017, ROW_OFFSET
    W, Wb, P, gw, gb = op["w_fwd"], op["w_bwd"], op["proj"], op["gn_w"], op["gn_b"]
    plain_f, plain_b = fused_train.dense_gn_silu_train_plain, fused_train.dense_gn_silu_bwd_plain
    fwd = [plain_f(op["x_pert"], W[0], P[0], gw[0], gb[0], seed, 0, keep)]
    for j in range(1, 5):
        fwd.append(plain_f(fwd[-1][0], W[j], P[j], gw[j], gb[j], seed, j, keep,
                           fwd[j - 2][0] if j % 2 == 0 else None))
    sl = slice(h, BT)

    def rows(x):
        return None if x is None else x[sl]

    out = {}
    for label, j, route in (("K10 pre (register)", 0, "register"),
                            ("K10 block+residual (Hopper)", 2, "wgmma")):
        a = op["x_pert"] if j == 0 else fwd[j - 1][0]
        a_b = fwd[j - 1][1] if route == "wgmma" else None
        a_in = None if a_b is not None else a
        res = fwd[j - 2][0] if j == 2 else None

        def launch(sel=slice(0, BT), off=0, a_in=a_in, a_b=a_b, res=res, j=j):
            return fused_train.dense_gn_silu_train(
                None if a_in is None else a_in[sel], W[j], P[j][sel], gw[j], gb[j], seed, j,
                keep, residual=None if res is None else res[sel],
                a_b=None if a_b is None else a_b[sel], row_offset=off)

        fused_em.reset_launch_counts()
        full, half = launch(), launch(sl, h)
        torch.cuda.synchronize()
        check(fused_em.route_counts()["dense_gn_silu_train"][route] == 2,
              f"{label}: not on the {route} route")
        check(all(torch.equal(x, y[sl]) for x, y in zip(half, full)),
              f"{label}: rows {h}:{BT} at row_offset={h} are not the full launch's rows")
        ref = plain_f(rows(a), W[j], P[j][sl], gw[j], gb[j], seed, j, keep, rows(res),
                      row_offset=h)
        e_out, tol = err(half[0], ref[0]), 1e-3 * max(1.0, float(ref[0].abs().max()))
        e_bf = [err(g.float(), r.float()) for g, r in zip(half[1:3], ref[1:3])]
        tol_bf = [1e-2 * max(1.0, float(r.float().abs().max())) for r in ref[1:3]]
        e_rs = float(((half[3] - ref[3]).abs() / ref[3]).max())
        check(e_out <= tol and all(x <= y for x, y in zip(e_bf, tol_bf)) and e_rs <= 1e-3,
              f"{label} at row_offset={h}: out {e_out} (tol {tol}), stash/xhat {e_bf} "
              f"(tol {tol_bf}), rstd rel {e_rs}")
        dropped = ~fused_train.dropout_keep(seed, j, BT - h, H, keep, dev, row_offset=h)
        base = torch.zeros(BT - h, H, device=dev) if res is None else res[sl]
        check(torch.equal(half[0][dropped], base[dropped]),
              f"{label} at row_offset={h}: another dropout mask than the plain version's")
        K, rows_h = (a if a_b is None else a_b).shape[1], BT - h
        n_bytes = ((4 if a_b is None else 2) * rows_h * K + 2 * K * H + 2 * rows_h * H + 8 * H
                   + 4 * rows_h * H + 4 * rows_h * H + 4 * rows_h * 32
                   + (4 * rows_h * H if res is not None else 0))
        bms, by = bound(n_bytes, 2 * rows_h * K * H, 40 * rows_h * H)
        out[label] = dict(rows_bit_equal=True, max_abs_err=e_out, tol=tol,
                          errs_stash_xhat=e_bf, rstd_rel_err=e_rs, bound_ms_640=bms,
                          bound_by=by, ms_1280=graph_ms(launch),
                          ms_640=graph_ms(lambda: launch(sl, h)))
    # K12: the hop into a block's second layer with the carried gradient, and
    # the hop into its first layer
    head = fused_train.head_dsm_plain(fwd[4][0], op["wpost_k"], op["bpost"], op["coefs"], op["z"])
    dpad = torch.zeros(BT, score_net.HEAD_COLS, dtype=torch.bfloat16, device=dev)
    dpad[:, :D] = head[1]
    chain = {4: plain_b(dpad, op["wpost_t"], fwd[4][2], fwd[4][3], gw[4], gb[4], seed, 4, keep)}
    chain[3] = plain_b(chain[4][0], Wb[3], fwd[3][2], fwd[3][3], gw[3], gb[3], seed, 3, keep)
    for label, j, A, Wt, g_res in (("K12 hidden+g_res", 2, chain[3][0], Wb[2], chain[4][1]),
                                   ("K12 hidden", 3, chain[4][0], Wb[3], None)):
        with_out = j % 2 == 0

        def launch(sel=slice(0, BT), off=0, A=A, Wt=Wt, g_res=g_res, j=j, with_out=with_out):
            g_out = torch.empty(sel.stop - sel.start, H, device=dev) if with_out else None
            return fused_train.dense_gn_silu_bwd(
                A[sel], Wt, fwd[j][2][sel], fwd[j][3][sel], gw[j], gb[j], seed, j, keep,
                g_res=None if g_res is None else g_res[sel], g_out=g_out, row_offset=off)

        full = [None if t is None else t.clone() for t in launch()]
        halves = [[None if t is None else t.clone() for t in launch(part, part.start)]
                  for part in (slice(0, h), sl)]
        torch.cuda.synchronize()
        check(torch.equal(halves[1][0], full[0][sl])
              and (not with_out or torch.equal(halves[1][1], full[1][sl])),
              f"{label}: rows {h}:{BT} at row_offset={h} are not the full launch's rows")
        sums = [halves[0][k] + halves[1][k] for k in (2, 3)]
        e_sum = [err(a_, b_) for a_, b_ in zip(sums, full[2:])]
        tol_sum = [DP_SUM_TOL * max(1.0, float(b_.abs().max())) for b_ in full[2:]]
        check(all(e <= t for e, t in zip(e_sum, tol_sum)),
              f"{label}: the halves' dgamma/dbeta sum {e_sum} from the full launch's "
              f"(tol {tol_sum})")
        ref = plain_b(A[sl], Wt, fwd[j][2][sl], fwd[j][3][sl], gw[j], gb[j], seed, j, keep,
                      None if g_res is None else g_res[sl], row_offset=h)
        got = halves[1]
        e_dh = err(got[0].float(), ref[0].float())
        tol_dh = 1e-2 * float(ref[0].float().abs().max())
        e_g = ([err(got[1], ref[1]) if with_out else 0.0]
               + [err(a_, b_) for a_, b_ in zip(got[2:], ref[2:])])
        tol_g = [1e-3 * float(r.abs().max()) for r in ref[1:]]
        check(e_dh <= tol_dh and all(x <= y for x, y in zip(e_g, tol_g)),
              f"{label} at row_offset={h}: dh {e_dh} (tol {tol_dh}), g/dgamma/dbeta {e_g} "
              f"(tol {tol_g})")
        K, rows_h = A.shape[1], BT - h
        n_bytes = (2 * rows_h * K + 2 * K * H + 2 * rows_h * H + 4 * rows_h * 32 + 8 * H
                   + 2 * rows_h * H + (4 * rows_h * H if g_res is not None else 0)
                   + (4 * rows_h * H if with_out else 0) + 8 * H)
        bms, by = bound(n_bytes, 2 * rows_h * K * H, 40 * rows_h * H)
        out[label] = dict(rows_bit_equal=True, halves_sum_err=e_sum, halves_sum_tol=tol_sum,
                          max_abs_err=e_dh, tol=tol_dh, errs_g_dgamma_dbeta=e_g,
                          bound_ms_640=bms, bound_by=by, ms_1280=graph_ms(launch),
                          ms_640=graph_ms(lambda: launch(sl, h)))
    for label, r in out.items():
        print(f"[data-parallel] (i) {label}: rows {h}:{BT} at row_offset={h} bit-equal to the "
              f"full launch's; against the plain version at the offset {r['max_abs_err']:.3g} "
              f"(tol {r['tol']:.3g}); {r['ms_640'] * 1e3:.2f} us at {BT - h} rows (bound "
              f"{r['bound_ms_640'] * 1e3:.2f}, {r['bound_by']}), {r['ms_1280'] * 1e3:.2f} us at "
              f"{BT}"
              + (f"; the halves' dgamma/dbeta sums within {max(r['halves_sum_err']):.3g} "
                 f"(tol {max(r['halves_sum_tol']):.3g})" if "halves_sum_err" in r else ""))
    return out


RANK_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
import chip_smoke
chip_smoke.{fn}(*{args!r})
"""


def start_ranks(fn, args_by_rank):
    """``chip_smoke.<fn>(*args)`` in one process a rank, all started at once
    from the repository; ``join_ranks`` waits for them."""
    return [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT.format(
        repo=REPO, fn=fn, args=tuple(a))], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for a in args_by_rank]


def join_ranks(procs, what):
    """Each of ``procs`` joined within DP_TIMEOUT_S of this call (a hang or a
    non-zero exit fails the phase; every process is stopped)."""
    try:
        for r, proc in enumerate(procs):
            try:
                out, _ = proc.communicate(timeout=DP_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise PhaseError(f"{what} rank {r}: no end within {DP_TIMEOUT_S} s")
            check(proc.returncode == 0,
                  f"{what} rank {r} exited {proc.returncode}:\n{out[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def train_mh_rank_main(argv, out_path):
    """(q)(iii) one rank of ``python -m dposer_tpu_torch.train --multihost``
    (``train.main``), then a sampler built fresh on the run's final EMA
    weights and drawn from the last eval firing's sample generator; writes
    the firings' capture and tensor-map counts, whether the fresh samples
    equal the firing's bit for bit, the losses and the state's digest."""
    torch.backends.cuda.matmul.allow_tf32 = False
    r = train_cli.main(argv)
    dev = r["device"]
    config = train_cli.load_config(argv[argv.index("--config") + 1])
    sde = train_cli.build_sde(config)
    model = create_score_model(config).to(dev).eval()
    sd = r["state"].model.state_dict()
    names = [n for n, q in r["state"].model.named_parameters() if q.requires_grad]
    sd.update(zip(names, r["state"].ema.shadow_params))
    model.load_state_dict(sd)
    last, eb = r["last_eval"], config.eval.batch_size
    fresh = fused_em.get_cuda_em_sampler(sde, model, (eb, D),
                                         **train_cli.eval_sampler_kwargs(config, sde, dev))
    gen = torch.Generator(device=dev).manual_seed(
        train_cli.sample_seed(train_cli.parse_args(argv).seed, last["step"]))
    with torch.no_grad():
        again = torch.cat([fresh(gen) for _ in range(last["samples"].shape[0] // eb)])
    with open(os.path.join(r["output_dir"], "train.log")) as f:
        log = f.read()
    firings = [(int(a), int(b)) for a, b in re.findall(
        r"validating completed: (\d+) graph\(s\) captured, (\d+) tensor map\(s\) encoded", log)]
    with open(out_path, "w") as f:
        json.dump(dict(firings=firings, fresh_equal=bool(torch.equal(again, last["samples"])),
                       eval_step=last["step"], losses=r["losses"], route=r["route"],
                       digest=data_parallel.state_digest(r["state"]), world=r["world"],
                       dp_line=[ln for ln in log.splitlines() if "data-parallel:" in ln]), f)


def hypo_params_check(model, dev):
    """(q)(iii) the trainer's hypothesis sampler in its ``_params`` form
    (``multi_hypothesis_imputation_sampler_params`` over
    ``get_cuda_em_hypo_sampler`` with the eval's keywords, eval batch x
    ``train.HYPO_NUM`` rows) on cuda:0: built once and run on the pinned
    weights (that call captures), then on a second model's weights (the
    pinned ones, each scaled by 1 + 0.01 N(0, 1)): its samples bit-equal to
    a sampler built fresh on the second weights from the same generator, and
    the second call captures no graph and encodes no tensor map. The eval of
    (iii)'s trainer has no body model, so it never runs this sampler."""
    config = get_config()
    sde = train_cli.build_sde(config)
    kw = train_cli.eval_sampler_kwargs(config, sde, dev)
    eb, hn = config.eval.batch_size, train_cli.HYPO_NUM
    first = copy.deepcopy(model).eval()
    second = copy.deepcopy(model).eval()
    g = torch.Generator(device=dev).manual_seed(7)
    poses = normalized_synthetic_poses(eb, dev)
    with torch.no_grad():
        for q in second.parameters():
            q.mul_(1.0 + 0.01 * torch.randn(q.shape, generator=g, device=dev, dtype=q.dtype))
        mask, obs = create_mask(poses, part=PART, generator=g)

        def gen():
            return torch.Generator(device=dev).manual_seed(11)

        run = parallel.sharding.multi_hypothesis_imputation_sampler_params(
            fused_em.get_cuda_em_hypo_sampler(sde, first, (eb, D), hn, **kw))
        t0 = time.perf_counter()
        on_first = run(first, gen(), obs, mask)
        captures, encodes = GraphLoop.captures, build.tma_encodes("dense_gn_silu")
        on_second = run(second, gen(), obs, mask)
        torch.cuda.synchronize(dev)
        new = (GraphLoop.captures - captures, build.tma_encodes("dense_gn_silu") - encodes)
        fresh = fused_em.get_cuda_em_hypo_sampler(sde, second, (eb, D), hn, **kw)(gen(), obs,
                                                                                   mask)
    check(on_second.shape == (eb, hn, D) and torch.isfinite(on_second).all().item(),
          f"hypothesis sampler _params form: shape {tuple(on_second.shape)} or non-finite")
    check(new == (0, 0) and torch.equal(on_second, fresh)
          and not torch.equal(on_second, on_first),
          f"hypothesis sampler _params form on a second model's weights: (graphs captured, "
          f"tensor maps encoded) {new}, bit-equal to a fresh sampler: "
          f"{bool(torch.equal(on_second, fresh))}, differs from the first weights' samples: "
          f"{not torch.equal(on_second, on_first)}")
    wall = time.perf_counter() - t0
    print(f"[data-parallel] (iii) the hypothesis sampler's _params form, {eb} x {hn} rows on "
          f"cuda:0: on a second model's weights 0 graphs captured and 0 tensor maps encoded, "
          f"its samples bit-equal to a fresh sampler's; {wall:.1f} s")
    return dict(rows=eb * hn, second_call=dict(graphs=new[0], tensor_maps=new[1]),
                equals_fresh=True, wall_s=wall)


def fitting_on_shards(dev, fi):
    """(q)(iv) 5m's 8 fragments and 5n's 8 images on a mesh of SHARDS shards
    on cuda:0 over DP_FIT_STEPS steps, against the unsharded batch."""
    mesh = parallel.Mesh([dev] * SHARDS)
    cut = dict(fi["sched"], iterations=1, steps_per_iter=DP_FIT_STEPS)
    tasks = {name: MotionDenoise(fi["sde"], fi["score_fn"], fi["body"], fi["normalizer"],
                                 batch_size=60, mesh=m)
             for name, m in (("unsharded", None), ("sharded", mesh))}
    walls, poses = {}, {}
    for name, md in tasks.items():
        gens = [sequence_generator(0, i, dev) for i in range(8)]
        poses[name], walls[f"motion_{name}"] = timed(lambda: md.optimize_batch(
            fi["noisy"], time_strategy="3", generators=gens, **cut))
    e_pose = float((poses["sharded"] - poses["unsharded"]).abs().max())
    over = 0.0  # the metrics' excess over 1e-4 + 1e-3 |ref| (cm)
    for i in range(8):
        a_, b_ = (tasks["unsharded"].metrics(poses[k][i], fi["noisy"][i], fi["gts"][i])
                  for k in ("sharded", "unsharded"))
        over = max(over, max(float(np.max(np.abs(a_[k] - b_[k]) - 1e-4 - 1e-3 * np.abs(b_[k])))
                             for k in a_))
    check(e_pose <= 1e-5 and over <= 0.0,
          f"motion denoising on {SHARDS} shards: poses {e_pose} rad from the unsharded batch "
          f"(tol 1e-5), metrics {over} cm over 1e-4 + 1e-3 |ref|")
    fits = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        fitter = SMPLify(fi["smpl"], pose_prior=fi["prior"], step_size=1e-2, cam_step_size=1e-2,
                         batch_size=N_IMG, num_iters=DP_FIT_STEPS // 5,
                         focal_length=fi["focal"], sde_N=fi["sde"].N, mesh=m)
        gen = torch.Generator(device=dev).manual_seed(42)
        fits[name], walls[f"smplify_{name}"] = timed(lambda: fitter(
            *fi["init"], fi["cc"], fi["keypoints"], generator=gen))
    e_fit = [float((a_ - b_).abs().max()) / max(1.0, float(b_.abs().max()))
             for a_, b_ in zip(fits["sharded"][:3], fits["unsharded"][:3])]
    rp_a, rp_b = fits["sharded"][3], fits["unsharded"][3]
    rp_over = float(((rp_a - rp_b).abs() - 1e-4 - 1e-3 * rp_b.abs()).max())
    check(max(e_fit) <= 2e-5 and rp_over <= 0.0,
          f"SMPLify on {SHARDS} shards: pose/betas/camera {e_fit} x max(1, |ref|) from the "
          f"unsharded fit (tol 2e-5), reprojection {rp_over} over 1e-4 + 1e-3 |ref|")
    print(f"[data-parallel] (iv) {SHARDS} shards on cuda:0, {DP_FIT_STEPS} steps: motion "
          f"denoising's poses within {e_pose:.3g} rad of the unsharded batch's, SMPLify's fit "
          f"within {max(e_fit):.3g} x max(1, |ref|); walls "
          f"{ {k: round(v, 3) for k, v in walls.items()} } s")
    return dict(shards=SHARDS, steps=DP_FIT_STEPS, motion_pose_max_abs=e_pose,
                motion_metrics_over=over, smplify_max_rel=e_fit, reprojection_over=rp_over,
                walls_s=walls)


def dp_two_ranks(model, dev):
    """(q)(ii): ``benchmarks.data_parallel.run`` with two ranks on cuda:0
    over gloo against one process here, and its gates."""
    by_run = {}
    poses = normalized_synthetic_poses(DP_POOL, dev)
    idx = torch.randint(0, DP_POOL, (DP_STEPS, BT),
                        generator=torch.Generator().manual_seed(5)).to(dev)
    try:
        out = data_parallel.run(model, dev, poses, idx, [dev] * 2, "gloo", CKPT, DP_TIMEOUT_S)
    except RuntimeError as e:
        raise PhaseError(str(e))
    one, ranks = out["one"], out["ranks"]
    by_run["train_data_parallel_one_process"] = one["counts"]
    for r, rk in enumerate(ranks):
        check(rk["world"] == 2 and rk["backend"] == "gloo",
              f"rank {r}: {rk['world']} processes over {rk['backend']}")
        by_run[f"train_data_parallel_rank{r}"] = rk["counts"]
    res = data_parallel.summary(out)
    per_step = res["launches_per_step"]
    check(per_step == {"dense_gn_silu_train": 5, "head_dsm": 1, "dense_gn_silu_bwd": 5}
          and res["k10_routes"] == {"wgmma": 4 * DP_STEPS, "register": DP_STEPS},
          f"data-parallel: a rank's launches a step {per_step}, K10's routes "
          f"{res['k10_routes']}")
    check(res["ranks_bit_equal"], "data-parallel: the ranks' parameters, EMA or losses differ")
    tail = res["last50_means"]
    tail_rel = abs(tail[0] / tail[1] - 1.0)
    check(res["first_losses_max_rel"] <= DP_LOSS_RTOL and tail_rel <= DP_TAIL_RTOL,
          f"data-parallel against one process: the first {DP_CHECK_STEPS} losses up to "
          f"{res['first_losses_max_rel']:.3g} relative (tol {DP_LOSS_RTOL}), last-50 means "
          f"{tail} ({tail_rel:.3g}, tol {DP_TAIL_RTOL})")
    ms, ar = float(np.mean(res["ms_per_step"])), float(np.mean(res["allreduce_in_step_ms"]))
    share = float(np.mean(res["allreduce_share"]))
    res.update(steps=DP_STEPS, global_batch=BT, last50_rel=tail_rel,
               first_losses=ranks[0]["losses"][:DP_CHECK_STEPS],
               one_process_first_losses=one["losses"][:DP_CHECK_STEPS])
    print(f"[data-parallel] (ii) 2 ranks on cuda:0 over gloo, {DP_STEPS} kernel steps at "
          f"{BT} rows (640 a rank): {ms:.3f} ms a step (one process "
          f"{res['one_process_ms_per_step']:.3f}), the all-reduce {ar:.3f} ms inside a step "
          f"({100 * share:.0f}% of a step's wall; alone "
          f"{float(np.mean(res['allreduce_alone_ms'])):.3f} ms) of "
          f"{res['grad_bytes'] / 2 ** 20:.2f} MiB of "
          f"gradients; the first {DP_CHECK_STEPS} losses within "
          f"{res['first_losses_max_rel']:.2e} of one process's, last-50 mean {tail[0]:.5f} vs "
          f"{tail[1]:.5f} ({tail_rel:.2e}); ranks bit-equal; a step {per_step}; "
          f"{res['wall_s']:.1f} s for both processes")
    return res, by_run


def start_trainer_ranks(work):
    """(q)(iii): ``train_mh_rank_main`` as two ranks on a synthetic AMASS
    layout under ``work``, started; ``(processes, their JSON files)``."""
    root = os.path.join(work, "amass")
    for subset, n in (("train", DP_POOL), ("test", 100)):
        os.makedirs(os.path.join(root, "v1", subset))
        np.save(os.path.join(root, "v1", subset, "pose_body.npy"), synthetic_poses(n))
    train_cli.AMASSDataset(root, version="v1", subset="train")  # its stats, cached once
    cfg = os.path.join(work, "mh.py")
    with open(cfg, "w") as f:
        f.write(MH_CONFIG.format(out=os.path.join(work, "out"), n_iters=MH_STEPS,
                                 eval_freq=MH_STEPS // 2))
    url = f"tcp://127.0.0.1:{free_port()}"
    outs = [os.path.join(work, f"mh{r}.json") for r in range(2)]
    argv = ["--config", cfg, "--dataset-folder", root, "--version", "v1",
            "--bodymodel-path", "", "--device", "cuda", "--multihost", "--coordinator", url,
            "--num-processes", "2"]
    return start_ranks("train_mh_rank_main", [(argv + ["--process-id", str(r)], outs[r])
                                              for r in range(2)]), outs


def check_trainer_ranks(outs, wall):
    """(q)(iii)'s gates on the ranks' JSON files."""
    mh = []
    for p in outs:
        with open(p) as f:
            mh.append(json.load(f))
    for r, m in enumerate(mh):
        check(m["world"] == 2 and m["route"].startswith("kernel step: K10/K11/K12 on CUDA"),
              f"train --multihost rank {r}: {m['world']} processes, route {m['route']}")
        check(len(m["firings"]) == 2 and m["firings"][0][0] >= 1
              and m["firings"][1] == [0, 0] and m["fresh_equal"],
              f"train --multihost rank {r}: firings (graphs captured, tensor maps encoded) "
              f"{m['firings']}, the last firing's samples equal a fresh sampler's: "
              f"{m['fresh_equal']}")
    check(mh[0]["digest"] == mh[1]["digest"] and mh[0]["losses"] == mh[1]["losses"],
          "train --multihost: the ranks' states or losses differ")
    print(f"[data-parallel] (iii) train --multihost, 2 processes on cuda:0, {MH_STEPS} steps "
          f"at {BT}: eval firings (graphs captured, tensor maps encoded) {mh[0]['firings']} "
          f"on each rank, the last firing's samples bit-equal to a fresh sampler's on the same "
          f"EMA weights; the ranks equal; {wall:.1f} s with (iv) beside them")
    return dict(steps=MH_STEPS, firings=mh[0]["firings"], last_firing_equals_fresh=True,
                losses=mh[0]["losses"], dp_line=mh[0]["dp_line"], wall_s=wall)


def phase_data_parallel(model, dev, fit_inputs):
    """(q) data-parallel training (``parallel.sharding``'s training half):
    (i) ``row_offset_checks``; (ii) two processes on cuda:0 over gloo run the
    kernel step at a global batch of 1,280 (640 rows a rank) from the pinned
    checkpoint for DP_STEPS steps, against the same steps in this process:
    each of the first DP_CHECK_STEPS losses within DP_LOSS_RTOL relative and
    the last 50 steps' mean within DP_TAIL_RTOL, the ranks' parameters and
    EMA bit-equal (digests), a rank's step K10 x5 (4 Hopper, 1 register),
    K11 x1 and K12 x5; ms a step, the all-reduce's share of it (timed inside
    the step) and the gradient bytes a step; (iii) ``python -m dposer_tpu_torch.train
    --multihost`` as two processes on cuda:0 (flagship widths, batch 1,280,
    MH_STEPS steps, an eval firing at half of them and at the end): the
    first firing captures its sampler's graph, the second captures none and
    encodes no tensor map, and its samples are bit-equal to a sampler built
    fresh on the same EMA weights and generator; the ranks' losses and
    states equal; and ``hypo_params_check``, the hypothesis sampler the
    trainer's eval runs with a body model; (iv) ``fitting_on_shards``: the poses within 1e-5 rad,
    the fits within 2e-5 x max(1, |ref|), the metrics within 1e-3 relative,
    1e-4 absolute (the CPU tests' bounds). (iii) runs beside (iv), whose
    walls are then not a measurement; (i) and (ii) run alone."""
    t_phase = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    res, by_run = {}, {}
    res["row_offset"] = row_offset_checks(model, dev)
    res["hypo_params"] = hypo_params_check(model, dev)
    work = tempfile.mkdtemp(prefix="train_mh_", dir=OUT)
    try:
        t0 = time.perf_counter()
        procs, outs = start_trainer_ranks(work)
        try:
            res["fitting"] = fitting_on_shards(dev, fit_inputs)
        finally:
            join_ranks(procs, "train --multihost")
        res["trainer_multihost"] = check_trainer_ranks(outs, time.perf_counter() - t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["training"], by_run = dp_two_ranks(model, dev)
    res["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[data-parallel] (q) in {res['phase_wall_s']:.1f} s")
    return dict(results=res, by_run=by_run)


GP_ROWS, GP_STEPS = 3, range(9, 1000, 10)  # (r)(ii): generation_process's rows and frames
GP_CHECK_STEPS = (9, 499, 999)  # its frames held to step_range calls
RENDER_SHAPE = (512, 384, 3)  # the demo's canvas
RASTER_AGREE = 0.97  # native against plain masks (tests/test_native.py:108)
PROFILE_CONFIG = MH_CONFIG  # (r)(iii): the trainer's config, evaluated at its last step
PROFILE_STEPS = 20
TM_TOL = 1e-4  # (r)(iv): TimeMLPs' plain samplers on the card against the CPU, x max(1, |ref|)
# (r)(iv): VP's beta_1 at N = 20 (at 20 the last DDPM beta is 1 and the
# ancestral update divides by sqrt(1 - beta) = 0)
TM_BETA_1 = 10.0


def raster_check(body):
    """(r)(i) the native rasterizer built with g++ here, against its plain
    numpy version at the demo's 512 x 384 in the six views, on the
    10,475-vertex synthetic SMPL-X body ``body`` (tests/fixtures.py) and on
    the smooth 7,056-vertex SMPL body of ``benchmarks/gen_synth_body.py``
    (a closed mesh of small faces): the masks agree on RASTER_AGREE of the
    pixels; ms per render of both versions, with the host CPU. Returns the
    results and the smooth body."""
    t0 = time.perf_counter()
    lib_path = native.build_lib()
    native.load()
    build_s = time.perf_counter() - t0
    smooth = load_benchmark("gen_synth_body").make_smooth_smpl_body(
        os.path.join(OUT, "smooth_smpl_render.npz"))
    bodies = dict(smplx_fixture=body, smooth_smpl=BodyModel(
        smooth, num_betas=10, model_type="smpl", device=body.v_template.device))
    cam = dict(focal=demo.FOCAL, princpt=demo.PRINCPT)
    h, w = RENDER_SHAPE[:2]
    cpu = host_cpu()
    res = dict(build_s=build_s, host_cpu=cpu)
    pose_dims = dict(smplx_fixture=D, smooth_smpl=D + 6)  # SMPL: the hand joints padded
    for name, bm in bodies.items():
        with torch.no_grad():
            out = bm(pose_body=torch.zeros(1, pose_dims[name], device=bm.v_template.device))
        verts, faces = out.v[0].cpu().numpy(), out.f.cpu().numpy()
        agree, ms, plain_ms = {}, [], []
        for view in sorted(visual.VIEW_ANGLES):
            v = visual.view_vertices(verts, view)
            t0 = time.perf_counter()
            _, mask = visual.rasterize_mesh(v, faces, h, w, cam["focal"], cam["princpt"])
            t1 = time.perf_counter()
            _, mask_p = visual.rasterize_mesh_plain(v, faces, h, w, cam["focal"],
                                                    cam["princpt"])
            t2 = time.perf_counter()
            ms.append((t1 - t0) * 1e3)
            plain_ms.append((t2 - t1) * 1e3)
            agree[view] = float((mask == mask_p).mean())
            check(mask.sum() > 100, f"rasterizer: {name}'s {view} view drew {int(mask.sum())} "
                                    f"pixels")
            check(agree[view] >= RASTER_AGREE,
                  f"rasterizer: {name}'s {view} view agrees with the plain version on "
                  f"{agree[view]:.4f} of the pixels (< {RASTER_AGREE})")
        res[name] = dict(vertices=len(verts), faces=len(faces), mask_agree=agree,
                         ms_per_render=ms, plain_ms_per_render=plain_ms)
        print(f"[render] (r)(i) {name}: {len(verts)} vertices, {len(faces)} faces at {w} x {h} "
              f"in six views: masks agree with the plain version on {min(agree.values()):.4f}+ "
              f"of the pixels; {np.median(ms):.2f} ms a render native, "
              f"{np.median(plain_ms):.1f} ms plain (numpy)")
    print(f"[render] (r)(i) native rasterizer built with g++ in {build_s:.2f} s "
          f"({os.path.basename(lib_path)}); host CPU {cpu['model']} ({cpu['threads']} threads)")
    return res, bodies["smooth_smpl"]


def generation_process_check(model, dev, smooth):
    """(r)(ii) the demo's generation_process on the kernel sampler's graph:
    GP_ROWS x 1000 flagship steps, in-kernel normals, recording steps 9, 19,
    ..., 999; the final output bit-equal to the sampler without
    trajectory_steps and the frames at GP_CHECK_STEPS bit-equal to eager
    ``step_range=(0, s + 1)`` calls without the denoise, all from one
    generator state; K1 5,000 and K2 1,000 launches a call and one graph
    captured; then the body model and the renders of the 300 frames to
    arrays (front view), with the walls of the three. The frames go through
    ``smooth``, the 13,944-face SMPL body of ``raster_check`` (hand joints
    zero-padded, as the metrics protocol pads them), whose small faces are
    near a real body's render work; the synthetic SMPL-X fixture's 64 faces
    are not."""
    config = get_config()
    sde = SubVPSDE(N=1000)
    eps = sampling_eps_for(sde)
    normalizer = PoseNormalizer(STATS, normalize=config.data.normalize,
                                min_max=config.data.min_max, rot_rep=config.data.rot_rep,
                                device=dev)
    sampler = demo.build_sampler(config, sde, model, GP_ROWS, eps, config.sampling.corrector,
                                 dev, trajectory_steps=GP_STEPS)
    plain = demo.build_sampler(config, sde, model, GP_ROWS, eps, config.sampling.corrector, dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(GRAPH_SEED)

    captures = GraphLoop.captures
    (trajs, x), first_s = timed(lambda: sampler(gen()))
    check(GraphLoop.captures - captures == 1, "generation_process: the first call captured "
                                              f"{GraphLoop.captures - captures} graphs, not 1")
    fused_em.reset_launch_counts()
    (trajs, x), sample_s = timed(lambda: sampler(gen()))
    counts = fused_em.launch_counts()
    check(counts["dense_gn_silu"] == 5000 and counts["head_em"] == 1000,
          f"generation_process: launches a call {counts} (K1 5,000 and K2 1,000 expected)")
    check(trajs.shape == (len(GP_STEPS), GP_ROWS, D) and torch.isfinite(trajs).all().item(),
          f"generation_process: trajectory {tuple(trajs.shape)}")
    check(torch.equal(x, plain(gen())), "generation_process: the final output differs from the "
                                        "sampler's without trajectory_steps")
    for s in GP_CHECK_STEPS:
        head = fused_em.get_cuda_em_sampler(
            sde, model, (GP_ROWS, D), eps=eps, denoise=False, rng_mode="kernel",
            corrector=config.sampling.corrector, predictor=config.sampling.predictor,
            step_range=(0, s + 1), device=dev, loop="eager")
        check(torch.equal(trajs[list(GP_STEPS).index(s)], head(gen())),
              f"generation_process: the frame at step {s} differs from a step_range=(0, {s + 1}) "
              f"call")
    axis = normalizer.offline_denormalize(trajs.reshape(-1, D), to_axis=True)
    (meshes, faces), body_s = timed(lambda: visual.body_meshes(
        torch.cat([axis, torch.zeros(len(axis), 6, device=dev)], 1), None, smooth))
    bg = np.ones(RENDER_SHAPE) * 255
    t0 = time.perf_counter()
    frames = [visual.render_mesh(bg, m, faces, dict(focal=demo.FOCAL, princpt=demo.PRINCPT),
                                 view="front") for m in meshes]
    render_s = time.perf_counter() - t0
    check(len(frames) == len(GP_STEPS) * GP_ROWS and all(np.isfinite(f).all() for f in frames)
          and all((f != bg).any() for f in frames), "generation_process: the renders")
    print(f"[render] (r)(ii) generation_process {GP_ROWS} x 1000 steps on the graph, "
          f"{len(GP_STEPS)} frames recorded: sampling {sample_s * 1e3:.1f} ms a call (first call "
          f"with the capture {first_s * 1e3:.1f} ms), K1 {counts['dense_gn_silu']} and K2 "
          f"{counts['head_em']} launches a call; output bit-equal to the sampler without "
          f"trajectory_steps, frames {GP_CHECK_STEPS} bit-equal to step_range calls; smooth "
          f"SMPL body ({len(faces)} faces) over {len(meshes)} frames {body_s * 1e3:.1f} ms, "
          f"renders {render_s:.2f} s ({render_s * 1e3 / len(frames):.2f} ms a frame)")
    return dict(rows=GP_ROWS, frames=len(GP_STEPS), sample_s=sample_s, first_call_s=first_s,
                body_s=body_s, render_s=render_s, render_faces=len(faces),
                launches=counts), counts


def trainer_profile_check(dev, work):
    """(r)(iii) ``python -m dposer_tpu_torch.train`` (``train.main``) on the
    card from scratch, PROFILE_STEPS kernel steps at the flagship's batch
    1,280 with ``--profile-dir`` and an eval at the last step: the trace
    file holds K10's, K11's and K12's kernels and the ``train_step_<s>``
    spans of local steps 10-20; ``last_samples.npz`` holds ``pose_trajs``
    [10, 5, 63]; and the eval's trajectory and samples are bit-equal to a
    sampler built fresh on the same EMA weights and generator."""
    root = os.path.join(work, "amass")
    for subset, n in (("train", DP_POOL), ("test", 100)):
        os.makedirs(os.path.join(root, "v1", subset))
        np.save(os.path.join(root, "v1", subset, "pose_body.npy"), synthetic_poses(n))
    cfg = os.path.join(work, "prof.py")
    with open(cfg, "w") as f:
        f.write(PROFILE_CONFIG.format(out=os.path.join(work, "out"), n_iters=PROFILE_STEPS,
                                      eval_freq=PROFILE_STEPS))
    prof_dir = os.path.join(work, "trace")
    argv = ["--config", cfg, "--dataset-folder", root, "--version", "v1", "--bodymodel-path",
            "", "--device", "cuda", "--profile-dir", prof_dir]
    fused_em.reset_launch_counts()
    r, wall = timed(lambda: train_cli.main(argv))
    counts = fused_em.launch_counts()
    check(r["route"].startswith("kernel step: K10/K11/K12 on CUDA"), f"trainer route {r['route']}")
    (trace,) = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, trace)) as f:
        events = json.load(f)["traceEvents"]
    kernels = {k: sum(1 for e in events if e.get("cat") == "kernel" and k in e.get("name", ""))
               for k in ("dense_gn_silu_train", "head_dsm", "dense_gn_silu_bwd")}
    spans = sorted(int(e["name"].rsplit("_", 1)[1]) for e in events
                   if re.fullmatch(r"dp\.train_step_\d+", e.get("name", ""))
                   and e.get("ph") == "X" and e.get("cat") == "user_annotation")
    check(all(kernels.values()), f"trainer trace: kernels by name {kernels}")
    check(spans == list(range(11, PROFILE_STEPS + 1)),
          f"trainer trace: the spans of steps {spans}, expected 11-{PROFILE_STEPS}")
    with np.load(os.path.join(r["output_dir"], "last_samples.npz")) as f:
        pose_trajs = f["pose_trajs"]
    check(pose_trajs.shape == (10, 5, D) and np.isfinite(pose_trajs).all(),
          f"last_samples.npz pose_trajs {pose_trajs.shape}")
    config = train_cli.load_config(cfg)
    sde = train_cli.build_sde(config)
    model = create_score_model(config).to(dev).eval()
    sd = r["state"].model.state_dict()
    names = [n for n, q in r["state"].model.named_parameters() if q.requires_grad]
    sd.update(zip(names, r["state"].ema.shadow_params))
    model.load_state_dict(sd)
    last, eb = r["last_eval"], config.eval.batch_size
    fresh = fused_em.get_cuda_em_sampler(sde, model, (eb, D),
                                         trajectory_steps=train_cli.trajectory_steps(sde.N),
                                         **train_cli.eval_sampler_kwargs(config, sde, dev))
    gen = torch.Generator(device=dev).manual_seed(train_cli.sample_seed(42, last["step"]))
    with torch.no_grad():
        trajs, x = fresh(gen)
    check(torch.equal(trajs, last["trajs"]) and torch.equal(x, last["samples"]),
          "trainer eval: the trajectory or samples differ from a fresh sampler's")
    print(f"[render] (r)(iii) train --profile-dir, {PROFILE_STEPS} steps at {BT} with an eval: "
          f"trace {os.path.getsize(os.path.join(prof_dir, trace)) / 2 ** 20:.1f} MiB, kernels "
          f"in it {kernels}, spans of steps {spans[0]}-{spans[-1]}; pose_trajs "
          f"{pose_trajs.shape}; the eval's trajectory bit-equal to a fresh sampler's; "
          f"{wall:.1f} s")
    return dict(steps=PROFILE_STEPS, wall_s=wall, trace_kernels=kernels, spans=spans,
                pose_trajs_shape=list(pose_trajs.shape), launches=counts), counts


def time_mlps_check(dev):
    """(r)(iv) a TimeMLPs model (no kernel covers it) sampled through the
    ancestral predictor and through ald at N = 20 (VP, beta_1
    TM_BETA_1) on injected noise,
    on the card and on the CPU: within TM_TOL x max(1, |ref|)."""
    torch.manual_seed(0)
    tm = TimeMLPs(n_poses=21, pose_dim=3, hidden_dim=64, n_blocks=2, dropout=0.0).eval()
    sde = VPSDE(beta_1=TM_BETA_1, N=20)
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.normal(size=(50, D)).astype(np.float32))
    out = {}
    for pred, corr in (("ancestral_sampling", "none"), ("euler_maruyama", "ald")):
        k = 1 if corr == "none" else 2
        noise = torch.from_numpy(rng.normal(size=(20, k, 50, D)).astype(np.float32))
        res = {}
        for d in ("cpu", dev):
            m = copy.deepcopy(tm).to(d)
            s = tsampling.get_pc_sampler(sde, (50, D), get_score_fn(sde, m), predictor=pred,
                                         corrector=corr, device=d)
            res[str(d)] = s(z=z.to(d), noise=noise.to(d)).cpu()
        ref = res["cpu"]
        e = float((res[str(dev)] - ref).abs().max())
        bound = TM_TOL * max(1.0, float(ref.abs().max()))
        check(torch.isfinite(ref).all().item() and e <= bound,
              f"TimeMLPs {pred}/{corr}: card against CPU {e} (> {bound})")
        out[f"{pred}_{corr}"] = dict(max_abs_err=e, bound=bound)
    print("[render] (r)(iv) TimeMLPs at N = 20 on the plain PC loop, card against CPU: "
          + ", ".join(f"{k} {v['max_abs_err']:.3g}" for k, v in out.items()))
    return out


def demo_fit_check(dev, fi):
    """(r)(iv) ``demo_fit.fit_image`` (the fit of ``python -m
    dposer_tpu_torch.demo_fit`` without its cv2 read and write) of image 0
    of (n)'s synthetic EHF geometry, its keypoints as an OpenPose dict and a
    blank 1600 x 1200 image, on (n)'s 10,475-vertex body: the
    hip-and-shoulder re-projection loss falls."""
    kp = fi["keypoints"][0, :25].cpu().numpy()
    json_data = {"people": [{"pose_keypoints_2d": kp.reshape(-1).tolist()}]}
    img = np.zeros((EHF_H, EHF_W, 3), np.uint8)
    args = demo_fit.parse_args(["--img", "-", "--device", "cuda", "--ckpt-path", CKPT,
                                "--stats-dir", STATS, "--seed", "42"])
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    fused_em.reset_launch_counts()
    fit, wall = timed(lambda: demo_fit.fit_image(args, img, json_data, dev, gen,
                                                 smpl=fi["smpl"]))
    counts = fused_em.launch_counts()
    check(np.isfinite(fit["pose"]).all() and fit["final_reproj"] < fit["init_reproj"],
          f"demo_fit: re-projection loss {fit['init_reproj']} -> {fit['final_reproj']}")
    over, render_s = timed(lambda: demo_fit.overlay(img, fit))
    check((over != img).any(), "demo_fit: the overlay drew nothing")
    print(f"[render] (r)(iv) demo_fit on a synthetic EHF image: hip-and-shoulder re-projection "
          f"loss {fit['init_reproj']:.1f} -> {fit['final_reproj']:.1f} px^2, SMPLify's loss "
          f"{float(fit['loss'].sum()):.1f}; fit {wall:.2f} s, overlay {render_s * 1e3:.1f} ms")
    return dict(init_reproj=fit["init_reproj"], final_reproj=fit["final_reproj"], wall_s=wall,
                overlay_s=render_s), counts


def phase_last_modules(model, dev, fit_inputs):
    """(r) the last modules: (i) ``raster_check``, (ii)
    ``generation_process_check``, (iii) ``trainer_profile_check``, (iv)
    ``demo_fit_check`` and ``time_mlps_check``. Each main path runs with
    the launch counters set to 0 before it and read after it."""
    t_phase = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    res, by_run = {}, {}
    res["rasterizer"], smooth = raster_check(fit_inputs["smpl"].bm)
    with torch.no_grad():
        res["generation_process"], by_run["generation_process"] = generation_process_check(
            model, dev, smooth)
    work = tempfile.mkdtemp(prefix="train_prof_", dir=OUT)
    try:
        res["trainer_profile"], by_run["train_profile"] = trainer_profile_check(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["demo_fit"], by_run["demo_fit"] = demo_fit_check(dev, fit_inputs)
    with torch.no_grad():
        res["time_mlps"] = time_mlps_check(dev)
    res["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[render] (r) in {res['phase_wall_s']:.1f} s")
    return dict(results=res, by_run=by_run)


def main():
    if sys.argv[1:] not in ([], ["--plain-loops"]):
        print("usage: python3 chip_smoke.py [--plain-loops]", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        info = phase_device()
        build_s, wgmma_build = phase_build()
        with torch.no_grad():
            model = load_pinned(dev)
            rows = phase_kernels(model, dev)
            comp_rows, k1_rc = phase_completion_kernels(model, dev,
                                                        wgmma_build["cluster_kernels"])
            rows += comp_rows
            rows += phase_ode_kernels(model, dev)
            t0 = time.perf_counter()
            amax = {scheme: calibrate(model, dev, scheme) for scheme in ("tensor", "channel")}
            calib_s = time.perf_counter() - t0
            print(f"[int8] calibrated per tensor and per channel in {calib_s:.2f} s: "
                  f"{np.round(amax['tensor'], 3)}")
            rows += phase_int8_kernels(model, dev, amax)
            parity = phase_parity(model, dev)
            parity.update(phase_completion_parity(model, dev))
            parity.update(phase_ode_parity(model, dev))
            parity.update(phase_int8_parity(model, dev, amax))
            proto = phase_protocols(model, dev)
            rows += phase_train_kernels(model, dev)
        comp = phase_completion_protocols(model, dev)
        comp_cli = phase_completion_cli(dev)
        with torch.no_grad():
            int8 = phase_int8_protocols(model, dev, amax, proto["metrics"]["apd"],
                                        comp["results"]["completion2_pc"]["mpjpe_mm"])
            micro = phase_microbenchmarks()
            graphs = phase_graphs(model, dev, amax)
        ode = phase_ode_protocols(model, dev)
        sharded = phase_sharded(model, dev, *ode["lik_inputs"],
                                ode["results"]["likelihood"]["bpd_means"]["kernel"])
        fit = phase_fitting_protocols(model, dev)
        parity["train"] = phase_train_parity(model, dev)
        train = phase_train_protocols(dev)
        fit_inputs = fit.pop("inputs")
        dp = phase_data_parallel(model, dev, fit_inputs)
        last = phase_last_modules(model, dev, fit_inputs)
        by_run = {**proto.pop("by_run"), **comp["by_run"], **comp_cli["by_run"],
                  **int8["by_run"], **micro["by_run"], **ode["by_run"], **sharded["by_run"],
                  **fit["by_run"], **train["by_run"], **dp["by_run"], **last["by_run"]}
        for r in rows:
            r["launches_by_run"] = {k: v[r["name"]] for k, v in by_run.items()}
            r["launches"] = sum(r["launches_by_run"].values())
            check(r["launches"] > 0, f"kernel {r['name']} was never launched on a main path")
        bench = bench_line()
    except PhaseError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    ms = {r["name"]: r["ms"] for r in rows}
    # the device's share of a generation call: one step's kernel times (graph
    # replay, so no host gaps) x 1000 steps, over the call's wall time
    k1 = {v["shape"].split()[0]: v["ms"] for v in rows[0]["variants"]}
    step_ms = k1["pre"] + 2 * k1["block"] + 2 * k1["block+residual"] + ms["head_em"]
    gen = proto["generation"]
    gen["device_ms_per_call_est"] = 1000 * step_ms
    gen["device_busy_share_est"] = 1000 * step_ms / (1e3 * gen["wall_s"])
    print(f"[generation] kernels alone: {step_ms * 1e3:.1f} us a step, {1000 * step_ms:.1f} ms "
          f"per call, so the device is busy ~{100 * gen['device_busy_share_est']:.0f}% of the "
          f"best call")
    # a metrics step (500 x 1000, langevin): the corrector's forward, K2 in
    # score mode and K3, then the predictor's forward and K2 in EM mode
    k2_row = next(r for r in rows if r["name"] == "head_em")
    metrics_step = (2 * (step_ms - ms["head_em"]) + ms["head_em"] + k2_row["score_mode_ms"]
                    + ms["langevin_update"])
    met = proto["metrics"]
    met["device_ms_per_sampling_est"] = 1000 * metrics_step
    # over the protocol's wall less its SI seconds (SI runs on the host after
    # the sampling at one chunk)
    met["device_share_of_protocol_wall_est"] = (1000 * metrics_step
                                                / (1e3 * (met["wall_s"] - met["si_wall_s"])))
    print(f"[metrics] kernels alone: {metrics_step * 1e3:.1f} us a step, "
          f"{1000 * metrics_step:.1f} ms for the 500 x 1000 sampling, "
          f"~{100 * met['device_share_of_protocol_wall_est']:.0f}% of the protocol's wall "
          f"less SI (build + sampling + SMPL forward + APD)")
    # the same estimate for a solve at 1000 rows: K5 once, 200 steps of K1 x5,
    # K6's perturbing instantiation at the first 199 and K6 at the last
    fwd_rc = k1_rc["pre"] + 2 * k1_rc["block"] + 2 * k1_rc["block+residual"]
    solve_ms = (ms["comp_perturb"] + 199 * ms["head_adam_perturb"] + ms["head_adam"]
                + 200 * fwd_rc)
    sol = comp["results"]["solver"]
    sol["device_ms_per_call_est"] = solve_ms
    sol["device_busy_share_est"] = solve_ms / (1e3 * sol["wall_s"])
    print(f"[completion] kernels alone: {solve_ms:.1f} ms per solve, so the device is busy "
          f"~{100 * sol['device_busy_share_est']:.0f}% of the best call")
    proto["completion"] = comp["results"]
    proto["completion_cli"] = comp_cli["results"]
    # and for the PF-ODE paths: 4 x 125 stages of K1 x5 and K8 at 500 rows; 4 x 100
    # stages of K7 x5 and K9 at 50 rows
    k7 = {v["key"]: v["ms"]
          for v in next(r for r in rows if r["name"] == "dense_gn_silu_jvp")["variants"]}
    for name, dev_ms in (
            ("ode_sampling", 4 * ODE_STEPS * (step_ms - ms["head_em"] + ms["head_rk4"])),
            ("likelihood", 4 * LIK_STEPS * (k7["pre"] + 2 * k7["block"] + 2 * k7["block+residual"]
                                            + ms["head_rk4_jvp"]))):
        r = ode["results"][name]
        wall_ms = r["ms_per_batch"] if name == "likelihood" else 1e3 * r["wall_s"]
        r["device_ms_per_call_est"] = dev_ms
        r["device_busy_share_est"] = dev_ms / wall_ms
        print(f"[{name}] kernels alone: {dev_ms:.1f} ms per call, so the device is busy "
              f"~{100 * dev_ms / wall_ms:.0f}% of the best call")
    proto.update(ode["results"])
    proto["fitting"] = fit["results"]
    proto["sharded"] = sharded["results"]
    proto["data_parallel"] = dp["results"]
    proto["last_modules"] = last["results"]
    # and for a train step: K10 x5 (the last layer without its fp32 out), K11
    # on the stash and K12 x5 at batch 1,280
    by_name = {r["name"]: r for r in rows}
    k10 = {v["shape"].split()[0]: v["ms"] for v in by_name["dense_gn_silu_train"]["variants"]}
    k12 = {v["shape"].split()[0]: v["ms"] for v in by_name["dense_gn_silu_bwd"]["variants"]}
    step_k = (k10["pre"] + 2 * k10["block"] + k10["block+residual"] + k10["last"] + ms["head_dsm"]
              + k12["hop"] + 2 * k12["hidden"] + 2 * k12["hidden+g_res"])
    ft_res = train["results"]["finetune"]
    ft_res["kernel_ms_per_step"] = step_k
    ft_res["kernel_busy_share_est"] = step_k / ft_res["ms_per_step_best"]
    print(f"[train] K10-K12 alone: {step_k * 1e3:.1f} us a step, {100 * step_k / ft_res['ms_per_step_best']:.0f}% "
          f"of the best fine-tune step")
    proto["train"] = train["results"]
    # the device's share of an int8 generation call: K13 x5 and K2 a step
    k13 = {" ".join(v["shape"].split()[:2]): v["ms"]
           for v in by_name["dense_gn_silu_int8"]["variants"]}
    for scheme in ("tensor", "channel"):
        step13 = (k13[f"pre {scheme}"] + 2 * k13[f"block {scheme}"]
                  + 2 * k13[f"block+residual {scheme}"] + ms["head_em"])
        g = int8["results"][f"generation_int8_{scheme}"]
        g["device_us_per_step_est"] = step13 * 1e3
        g["bf16_device_us_per_step_est"] = step_ms * 1e3
        g["device_ms_per_call_est"] = 1000 * step13
        g["device_busy_share_est"] = 1000 * step13 / (1e3 * g["wall_s"])
        print(f"[int8] generation {scheme}: kernels alone {step13 * 1e3:.1f} us a step (bf16 "
              f"{step_ms * 1e3:.1f} in this run), {1000 * step13:.1f} ms per call, the device "
              f"busy ~{100 * g['device_busy_share_est']:.0f}% of the best call")
    ode_r, lik_r = proto["ode_sampling"], proto["likelihood"]
    for name, r, dev_ms, wall_ms in (
            ("generation 5a", gen, gen["device_ms_per_call_est"], 1e3 * gen["wall_s"]),
            ("solver 5c", sol, solve_ms, 1e3 * sol["wall_s"]),
            ("ode_sampling 5e", ode_r, ode_r["device_ms_per_call_est"], 1e3 * ode_r["wall_s"]),
            ("likelihood 5g", lik_r, lik_r["device_ms_per_call_est"], lik_r["ms_per_batch"])):
        eager_ms_ = 1e3 * r["eager_wall_s"]
        r["graph_device_busy_share_est"] = dev_ms / wall_ms
        r["eager_device_busy_share_est"] = dev_ms / eager_ms_
        lp = r["graph_loops"][0]
        print(f"[graph] {name}: eager {eager_ms_:.1f} ms, graph {wall_ms:.1f} ms best; the "
              f"graph's first call: warm-up {lp['warmup_s'] * 1e3:.1f} ms, capture "
              f"{lp['capture_s'] * 1e3:.1f} ms, instantiate {lp['instantiate_s'] * 1e3:.1f} ms; "
              f"kernels alone {dev_ms:.1f} ms: device busy ~{100 * dev_ms / eager_ms_:.0f}% "
              f"eager, ~{100 * dev_ms / wall_ms:.0f}% graph")
    proto["int8"] = dict(int8["results"], calibration_s=calib_s,
                         act_amax_tensor=[float(a) for a in amax["tensor"]],
                         act_amax_channel_max=[float(np.max(a)) for a in amax["channel"]])
    proto["microbenchmarks"] = micro["results"]
    proto["launches_by_run"] = by_run
    proto["graphs"] = graphs
    proto["bench"] = bench
    summary = dict(device=info, build_s=build_s, wgmma_build=wgmma_build, kernels=rows,
                   dense_gn_silu_ms_at_1000_rows=k1_rc, parity=parity,
                   protocols=proto, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   wall_s=time.perf_counter() - t_start)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[done] {summary['wall_s']:.1f}s; peak memory {summary['peak_mem_gib']:.2f} GiB")
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
