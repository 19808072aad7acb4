#!/usr/bin/env python3
"""Drive the PyTorch port (``dposer_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases; any failure exits non-zero:

1. device: the card's name, count and power limit;
2. build: the CUDA kernels from ``dposer_tpu_torch/ops/cuda/csrc`` with nvcc
   (``-Xptxas -v`` printed);
3. each of the fourteen kernels against its plain PyTorch version at the
   main paths' shapes ([500, .] for generation, imputation and PF-ODE
   sampling, [1000, .] for the completion solver, [50, .] for the
   likelihood, [1280, .] for training, [512, .] for the microbenchmarks), on
   the pinned trained weights, with the in-kernel normals' moments, and its
   device time (CUDA-graph replay, so host overhead is excluded) beside the
   plain version's, a library yardstick's and the bound from bytes and
   operations at the published H100 SXM peaks; K13 on states of a real
   trajectory with the per-tensor and per-channel ranges the demo calibrates;
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
   poses/s; (b) the demo's generation task with ``--metrics`` (50 poses,
   then 500 poses x 1000 steps with the langevin corrector at eps 5e-3,
   through the SMPL body): APD must lie in [0.80, 1.00];
   (c) completion by optimisation, 100 synthetic poses x 10 hypotheses,
   2x100 Adam steps, time strategy '3': solves/s, MPJPE and MPVPE;
   (d) the demo's ``completion`` task and its ``completion2`` task with
   ``--sampler pc``, ``ddim`` and ``hybrid``, 50 poses x 10 hypotheses, left
   leg masked, through the synthetic SMPL-X body: MPJPE must lie in (50, 400)
   mm and MPVPE in (5, 80) mm (an untrained model exceeds 1000 mm);
   (e) PF-ODE sampling, 500 poses x 125 RK4 steps: poses/s; (f) the PF-Euler
   decode, 500 x 1000 deterministic steps at eps 1e-5: poses/s; (g) the exact
   likelihood of 50 synthetic poses, 100 RK4 steps at eps 1e-4: ms per batch,
   and its bits/dim against the fp32 fixed-grid path and the adaptive RK45
   oracle on the same Hutchinson probe (batch means within 0.1); (h) the
   demo's ``interpolation`` task on synthetic poses: the reconstruction error
   and finite frames of shape [5, 60, 63]; (i) the int8 serving mode: 500 x
   1000 generation per tensor, per channel and int8-mixed beside bf16
   (poses/s), the metrics protocol under per-channel int8 (APD in [0.80,
   1.00] and within 0.03 of bf16's), moments at 2,000 rows against the bf16
   kernel route on one host-normal stream (mean within 1e-2, std within 2e-2,
   corr(0, 32) within 5e-2; bf16 against fp32 within 1e-2 in all three),
   completion2 pc under per-channel int8 (MPJPE in
   the band and within 15% of bf16 pc) and the hybrid per channel and per
   tensor; (j) both microbenchmarks (``dposer_tpu_torch.benchmarks``) at 100
   chain steps, the ilp splits bit-identical to the whole run; and the
   trainer's protocols;
6. one ``{"kernels": [...]}`` line, the card's name and power limit, and the
   final ``{"ok": true, ...}`` line.

Needs the repository around it (the port, the pinned checkpoint under
``artifacts/trained_r5``, ``tests/fixtures.py`` for the synthetic SMPL and
SMPL-X bodies and ``benchmarks/gen_synth_amass.py`` for the synthetic
poses); writes only under ``chiprun_out/chip_smoke``.
"""
import copy
import importlib.util
import json
import os
import shutil
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

from dposer_tpu_torch import demo  # noqa: E402
from dposer_tpu_torch import train as train_cli  # noqa: E402
from dposer_tpu_torch.body_model import BodyModel  # noqa: E402
from dposer_tpu_torch.config import get_config  # noqa: E402
from dposer_tpu_torch.data import PoseNormalizer  # noqa: E402
from dposer_tpu_torch.diffusion import fast_sampler as tfs  # noqa: E402
from dposer_tpu_torch.diffusion import likelihood as tlik  # noqa: E402
from dposer_tpu_torch.diffusion import losses as tlosses  # noqa: E402
from dposer_tpu_torch.diffusion.score_fn import get_score_fn  # noqa: E402
from dposer_tpu_torch.diffusion.sde import SubVPSDE  # noqa: E402
from dposer_tpu_torch.benchmarks import ilp_probe, mxu_micro  # noqa: E402
from dposer_tpu_torch.ops.cuda import (build, chain_link, fused_comp, fused_em,  # noqa: E402
                                       fused_lik, fused_ode, fused_train, quant, score_net)
from dposer_tpu_torch.models import create_score_model  # noqa: E402
from dposer_tpu_torch.ops.metrics import Evaler, average_pairwise_distance  # noqa: E402
from dposer_tpu_torch.tasks import DPoserComp  # noqa: E402
from dposer_tpu_torch.utils.masks import create_mask  # noqa: E402
from fixtures import make_synthetic_body_model  # noqa: E402

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

# published H100 SXM peaks (dense), at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
INT8_TC_OPS = 1979e12
FP32_FLOPS = 67e12
APD_BAND = (0.80, 1.00)
MPJPE_BAND, MPVPE_BAND = (50.0, 400.0), (5.0, 80.0)  # mm, tests/test_trained_artifact.py
B, H, D = 500, 1024, 63
RC = 1000  # completion's rows: 100 poses x 10 hypotheses
BL = 50  # the likelihood protocol's batch
BT = 1280  # the train batch (configs/default_amass_configs.py)
FT_STEPS, SCRATCH_STEPS, RESUME_STEPS = 500, 1000, 200  # the training protocols (a)-(c)
TRAIN_DEVICE = "cuda"
ODE_STEPS, LIK_STEPS, LIK_EPS, DECODE_EPS = 125, 100, 1e-4, 1e-5
BPD_LIMIT = 0.1  # bits/dim between two paths' batch means (tests/test_fast_ode.py)
ODE_TOL = 5e-2  # kernel against plain deterministic samplers, times max(1, |ref|max)
PART, HYPO = "left_leg", 10


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


def phase_build():
    t0 = time.perf_counter()
    logs = build.build_all()
    for name, log in logs.items():
        print(f"[build] {name}: {build.library_path(name).name}\n{log.strip()}")
    secs = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernels in {secs:.1f}s")
    return secs


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

    # K1 dense_gn_silu: the three layer shapes one network forward runs
    h = score_net.dense_gn_silu_plain(x, W[0], tp[0], gs[0], gb[0])
    h1 = score_net.dense_gn_silu_plain(h, W[1], tp[1], gs[1], gb[1])
    variants = []
    for label, a, j, res in (("pre [500,63]x[63,1024]", x, 0, None),
                             ("block [500,1024]x[1024,1024]", h, 1, None),
                             ("block+residual [500,1024]x[1024,1024]", h1, 2, h)):
        args = (a, W[j], tp[j], gs[j], gb[j])
        ref = score_net.dense_gn_silu_plain(*args, res)
        out = score_net.dense_gn_silu(*args, residual=res)
        torch.cuda.synchronize()
        e, tol = err(out, ref), 1e-3 * max(1.0, float(ref.abs().max()))
        check(e <= tol, f"dense_gn_silu {label}: max abs err {e} > {tol}")
        K = a.shape[1]
        n_bytes = 4 * B * K + 2 * K * H + 3 * 4 * H + 4 * B * H * (2 if res is not None else 1)
        bms, by = bound(n_bytes, 2 * B * K * H, 14 * B * H)
        o = torch.empty_like(ref)
        a16 = a.to(torch.bfloat16)

        def library():
            y = torch.matmul(a16, W[j]).float() + tp[j]
            return F.silu(F.group_norm(y, 32, gs[j], gb[j], eps=1e-5))

        variants.append(dict(
            shape=label, max_abs_err=e, tol=tol,
            ms=graph_ms(lambda: score_net.dense_gn_silu(*args, residual=res, out=o)),
            eager_ms=eager_ms(lambda: score_net.dense_gn_silu(*args, residual=res, out=o)),
            plain_ms=graph_ms(lambda: score_net.dense_gn_silu_plain(*args, res)),
            library_ms=graph_ms(library), bound_ms=bms, bound_by=by))
    main_v = variants[2]
    rows.append(dict(name="dense_gn_silu", route="cuda", source=f"{CSRC}/dense_gn_silu.cu",
                     replaces=TPU_KERNEL,
                     replaces_part="fused_em.py:58 _make_kernel -> score_net.py:362 fwd "
                                   "(dense, time row, group_norm_vpu, SiLU, h + h2)",
                     max_abs_err=max(v["max_abs_err"] for v in variants),
                     tol="1e-3*max(1,|ref|max)", **{k: main_v[k] for k in (
                         "shape", "ms", "eager_ms", "plain_ms", "library_ms",
                         "bound_ms", "bound_by")}, variants=variants))

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
    # in-kernel normals: with cnoise = 1, x_new - x_mean is the draw
    c1 = coefs.clone()
    c1[:, 2] = 1.0
    draws = []
    for step in range(4):
        xs = x.clone()
        fused_em.head_em(hid, wp, bp, c1, step, "em", x=xs, x_mean=xm, seed=20240917, slab=1)
        draws.append((xs - xm).flatten())
    k2_moments = normal_moments(draws, "head_em")
    xt = x.clone()
    n2 = 4 * B * H + 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS + 2 * 4 * B * D + 32
    bms2, by2 = bound(n2, 2 * B * H * D, 110 * B * D)
    rows.append(dict(
        name="head_em", route="cuda", source=f"{CSRC}/head_em.cu", replaces=TPU_KERNEL,
        replaces_part="fused_em.py:199-206 (fwd's post-dense, EM update, box_muller); "
                      ":178 (the corrector's score)",
        shape="EM mode, in-kernel normals, [500,1024]x[1024,63]",
        max_abs_err=max(e2), tol="1e-3*max(1,|ref|max)", normals_mean_std_n=k2_moments,
        ms=graph_ms(lambda: fused_em.head_em(hid, wp, bp, coefs, i, "em", x=xt, seed=7, slab=1)),
        eager_ms=eager_ms(lambda: fused_em.head_em(hid, wp, bp, coefs, i, "em", x=xt,
                                                   seed=7, slab=1)),
        plain_ms=graph_ms(lambda: fused_em.head_em_plain(hid, wp, bp, coefs, i, "em", D,
                                                         x=x, noise=z)),
        score_mode_ms=graph_ms(lambda: fused_em.head_em(hid, wp, bp, coefs, i, "score",
                                                        score=score, score_sq=sq)),
        library_ms=None, bound_ms=bms2, bound_by=by2))

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
    draws = []
    for step in range(4):
        x0 = torch.zeros_like(x)
        fused_em.langevin_update(x0, score, sq, lc, i - step, 0.16, seed=99, slab=0,
                                 step_out=st)
        draws.append(((x0 - st * score) / torch.sqrt(2 * st)).flatten())
    k3_moments = normal_moments(draws, "langevin_update")
    bms3, by3 = bound(3 * 4 * B * D + 4 * B + 32, 0, 220 * B * D)
    xt = x.clone()
    rows.append(dict(
        name="langevin_update", route="cuda", source=f"{CSRC}/langevin_update.cu",
        replaces=TPU_KERNEL, replaces_part="fused_em.py:176-190 (langevin corrector)",
        shape="[500,63], in-kernel normals", max_abs_err=e3, tol="1e-4*max(1,|ref|max)",
        normals_mean_std_n=k3_moments,
        ms=graph_ms(lambda: fused_em.langevin_update(xt, score, sq, lc, i, 0.16, seed=5)),
        eager_ms=eager_ms(lambda: fused_em.langevin_update(xt, score, sq, lc, i, 0.16,
                                                           seed=5)),
        plain_ms=graph_ms(lambda: fused_em.langevin_update_plain(x, score, sq, lc, i,
                                                                 0.16, z)),
        library_ms=None, bound_ms=bms3, bound_by=by3))
    for r in rows:
        kernel_row_line(r)
    return rows


def phase_completion_kernels(model, dev):
    """K4 (at the imputation sampler's 500 rows), K5 and K6 (at the solver's
    1000 rows) against their plain versions, with timings and bounds; K1's
    three layer shapes timed at 1000 rows too, for the solver's device share."""
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
    rows.append(dict(
        name="masked_renoise", route="cuda", source=f"{CSRC}/pose_elementwise.cu",
        replaces=TPU_KERNEL,
        replaces_part="fused_em.py:192-197, :208-211 (masked re-noise and overwrite "
                      "around the predictor)",
        shape="[500,63], in-kernel normals", max_abs_err=e4, tol="1e-4*max(1,|ref|max)",
        normals_mean_std_n=m4,
        ms=graph_ms(lambda: fused_em.masked_renoise(xt, obs4, mask4, coefs, i, seed=5, slab=2)),
        eager_ms=eager_ms(lambda: fused_em.masked_renoise(xt, obs4, mask4, coefs, i, seed=5,
                                                          slab=2)),
        plain_ms=graph_ms(lambda: fused_em.masked_renoise_plain(x4, obs4, mask4, coefs, i, z4)),
        library_ms=None, bound_ms=bms, bound_by=by))

    # K5 comp_perturb
    ref = fused_comp.comp_perturb_plain(x, coefc, t, z)
    pert = torch.empty_like(x)
    fused_comp.comp_perturb(x, pert, coefc, t, noise=z)
    torch.cuda.synchronize()
    e5, tol5 = err(pert, ref), 1e-4 * max(1.0, float(ref.abs().max()))
    check(e5 <= tol5, f"comp_perturb: max abs err {e5} > {tol5}")
    c1 = coefc.clone()
    c1[:, 0], c1[:, 1] = 0.0, 1.0  # then pert is the draw
    draws = []
    for step in range(2):
        fused_comp.comp_perturb(x, pert, c1, step, seed=32)
        draws.append(pert.clone())
    m5 = normal_moments(draws, "comp_perturb")
    bms, by = bound(2 * 4 * RC * D + 32, 0, 113 * RC * D)
    rows.append(dict(
        name="comp_perturb", route="cuda", source=f"{CSRC}/pose_elementwise.cu",
        replaces=TPU_COMP_KERNEL,
        replaces_part="fused_comp.py:116-117 (box_muller draw and the marginal perturbation)",
        shape="[1000,63], in-kernel normals", max_abs_err=e5, tol="1e-4*max(1,|ref|max)",
        normals_mean_std_n=m5,
        ms=graph_ms(lambda: fused_comp.comp_perturb(x, pert, coefc, t, seed=5)),
        eager_ms=eager_ms(lambda: fused_comp.comp_perturb(x, pert, coefc, t, seed=5)),
        plain_ms=graph_ms(lambda: fused_comp.comp_perturb_plain(x, coefc, t, z)),
        library_ms=None, bound_ms=bms, bound_by=by))

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
    n6 = 4 * RC * H + 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS + 9 * 4 * RC * D + 32
    bms, by = bound(n6, 2 * RC * H * D, 20 * RC * D)
    xt, mt, vt = x.clone(), m1.clone(), v.clone()
    rows.append(dict(
        name="head_adam", route="cuda", source=f"{CSRC}/head_adam.cu",
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
        library_ms=None, bound_ms=bms, bound_by=by))
    for r in rows:
        kernel_row_line(r)

    # K1 at completion's 1000 rows: checked, and timed for the device shares
    tp, W, gs, gb = netc["tp_all"][t], netc["W"], netc["gn_scale"], netc["gn_bias"]
    h0 = score_net.dense_gn_silu_plain(pert, W[0], tp[0], gs[0], gb[0])
    h1 = score_net.dense_gn_silu_plain(h0, W[1], tp[1], gs[1], gb[1])
    k1_ms = {}
    for label, a, j, res in (("pre", pert, 0, None), ("block", h0, 1, None),
                             ("block+residual", h1, 2, h0)):
        args = (a, W[j], tp[j], gs[j], gb[j])
        ref = score_net.dense_gn_silu_plain(*args, res)
        out = score_net.dense_gn_silu(*args, residual=res)
        torch.cuda.synchronize()
        e, tol = err(out, ref), 1e-3 * max(1.0, float(ref.abs().max()))
        check(e <= tol, f"dense_gn_silu {label} at {RC} rows: max abs err {e} > {tol}")
        o = torch.empty_like(ref)
        k1_ms[label] = graph_ms(lambda: score_net.dense_gn_silu(*args, residual=res, out=o))
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


def synthetic_poses(n):
    """``n`` test draws of the synthetic AMASS mixture the pinned checkpoint
    was trained on (benchmarks/gen_synth_amass.py; numpy only)."""
    spec = importlib.util.spec_from_file_location(
        "gen_synth_amass", os.path.join(REPO, "benchmarks", "gen_synth_amass.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
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
        res[name] = dict(mpjpe_mm=r["mpjpe"], mpvpe_mm=r["mpvpe"], task_wall_s=wall,
                         launches=by_run[f"demo_{name}"])
        print(f"[completion] demo {name}: MPJPE {r['mpjpe']:.1f} mm, MPVPE {r['mpvpe']:.1f} mm, "
              f"task wall {wall:.2f} s (load, build, sample, evaluate), launches "
              f"{by_run[f'demo_{name}']}")
    return dict(results=res, by_run=by_run)


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

    # K7 dense_gn_silu_jvp: the three layer shapes one forward-with-tangent runs
    h, dh = score_net.dense_gn_silu_jvp_plain(x, eps, W[0], tp[0], gs[0], gb[0])
    h1, dh1 = score_net.dense_gn_silu_jvp_plain(h, dh, W[1], tp[1], gs[1], gb[1])
    variants = []
    for label, a, da, k, res in (("pre [50,63]x[63,1024]", x, eps, 0, (None, None)),
                                 ("block [50,1024]x[1024,1024]", h, dh, 1, (None, None)),
                                 ("block+residual [50,1024]x[1024,1024]", h1, dh1, 2, (h, dh))):
        args = (a, da, W[k], tp[k], gs[k], gb[k])
        ref = score_net.dense_gn_silu_jvp_plain(*args, *res)
        out = score_net.dense_gn_silu_jvp(*args, residual=res[0], dresidual=res[1])
        torch.cuda.synchronize()
        e = [err(o, r) for o, r in zip(out, ref)]
        tol = [1e-3 * max(1.0, float(r.abs().max())) for r in ref]
        check(all(a_ <= b_ for a_, b_ in zip(e, tol)),
              f"dense_gn_silu_jvp {label}: max abs err (out, dout) {e} > {tol}")
        K, with_res = a.shape[1], res[0] is not None
        n_bytes = (2 * 4 * BL * K + 2 * K * H + 3 * 4 * H
                   + 2 * 4 * BL * H * (2 if with_res else 1))
        bms, by = bound(n_bytes, 2 * 2 * BL * K * H, 40 * BL * H)
        o, do = torch.empty_like(ref[0]), torch.empty_like(ref[0])
        r0, r1 = res if with_res else (torch.zeros_like(o), torch.zeros_like(o))

        def lib_layer(av, rv):
            y = torch.matmul(av.to(torch.bfloat16), W[k]).float() + tp[k]
            return F.silu(F.group_norm(y, 32, gs[k], gb[k], eps=1e-5)) + rv

        def library():
            return torch.func.jvp(lib_layer, (a, r0), (da, r1))

        lib = library()
        torch.cuda.synchronize()
        # the yardstick rounds its matmul output to bf16: same function, fewer digits
        check(err(lib[1], ref[1]) <= 50 * tol[1], f"dense_gn_silu_jvp {label}: the library "
                                                  f"composite computes another tangent")
        run = lambda: score_net.dense_gn_silu_jvp(*args, residual=res[0],  # noqa: E731
                                                  dresidual=res[1], out=o, dout=do)
        variants.append(dict(
            shape=label, max_abs_err=max(e), errs_out_dout=e, tols_out_dout=tol,
            ms=graph_ms(run), eager_ms=eager_ms(run),
            plain_ms=graph_ms(lambda: score_net.dense_gn_silu_jvp_plain(*args, *res)),
            library_ms=graph_ms(library), bound_ms=bms, bound_by=by))
    main_v = variants[2]
    rows.append(dict(name="dense_gn_silu_jvp", route="cuda",
                     source=f"{CSRC}/dense_gn_silu_jvp.cu", replaces=TPU_LIK_KERNEL,
                     replaces_part="fused_lik.py:41 _make_kernel -> score_net.py:388 "
                                   "bind_fwd_jvp (mm, gnorm_jvp, silu_jvp, h + h2 and dh + dh2)",
                     max_abs_err=max(v["max_abs_err"] for v in variants),
                     tol="out 1e-3*max(1,|ref|max); dout 1e-3*max(1,|dref|max)",
                     **{k: main_v[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by")},
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
    n8 = 4 * B * H + 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS + 5 * 4 * B * D + 32
    bms, by = bound(n8, 2 * B * H * D, 12 * B * D)
    st = (xo.clone(), xs.clone(), acc.clone())
    run8 = lambda stage=1: fused_ode.head_rk4(hid, wp, bp, coefo, jo, stage, *st)  # noqa: E731
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
        library_ms=None, bound_ms=bms, bound_by=by))

    # K9 head_rk4_jvp, on the hidden state and tangent of the 50 rows
    bufs = tuple(torch.empty(BL, H, device=dev) for _ in range(4))
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
    n9 = (2 * 4 * BL * H + 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS
          + 6 * 4 * BL * D + 3 * 4 * BL + 32)
    bms, by = bound(n9, 2 * 2 * BL * H * D, 16 * BL * D)
    st9 = tuple(t.clone() for t in (xl, xsl, accl, lp, lacc))
    run9 = lambda: fused_lik.head_rk4_jvp(hl, dhl, wpl, bpl, coefl, j, 1, *st9[:3],  # noqa: E731
                                          eps, *st9[3:])
    rows.append(dict(
        name="head_rk4_jvp", route="cuda", source=f"{CSRC}/head_rk4.cu",
        replaces=TPU_LIK_KERNEL,
        replaces_part="fused_lik.py:75-79 (fwd_jvp's post-dense pair, k_x and k_lp), :91-102 "
                      "(the RK4 step on x and delta_logp)",
        shape="stage 1, [50,1024] pair x [1024,63]", max_abs_err=max(e9),
        tol="1e-3*max(1,|ref|max), stages 0-3, x xs acc lp lacc", errs=e9, tols=tol9,
        ms=graph_ms(run9), eager_ms=eager_ms(run9),
        plain_ms=graph_ms(lambda: fused_lik.head_rk4_jvp_plain(hl, dhl, wpl, bpl, coefl, j, 1,
                                                               xl, xsl, accl, eps, lp, lacc)),
        library_ms=None, bound_ms=bms, bound_by=by))
    for r in rows:
        kernel_row_line(r)
    return rows


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
    res["likelihood"] = dict(
        ms_per_batch=wall * 1e3, walls_s=walls, batch=BL, nfe=nfe, bpd_means=means,
        bpd_mean_gaps=gaps, bpd_limit=BPD_LIMIT,
        bpd_row_max_gap_kernel_vs_adaptive=float((bpd - bpd_ad).abs().max()),
        z_max_abs_err_kernel_vs_adaptive=float((zk - z_ad).abs().max()),
        z_max_abs_err_fp32_vs_adaptive=float((z32 - z_ad).abs().max()), z_abs_max=scale,
        adaptive_nfe=nfe_ad, fp32_rk4_wall_s=t1 - t0, adaptive_wall_s=t2 - t1,
        launches=by_run["likelihood_50x100"])
    print(f"[likelihood] {BL} x {LIK_STEPS} RK4 steps: {wall * 1e3:.1f} ms per batch (calls "
          f"{['%.3f' % w for w in walls]} s); bits/dim means {means}, gaps {gaps}; adaptive "
          f"nfe {nfe_ad}; fp32 RK4 {t1 - t0:.2f} s, adaptive {t2 - t1:.2f} s once each")

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
                                task_wall_s=wall, launches=by_run["demo_interpolation"])
    print(f"[interpolation] demo: reconstruction error {r['recon_err']:.4f} (normalized), "
          f"task wall {wall:.2f} s, launches {by_run['demo_interpolation']}")
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
    walls, dev_ms = [], []
    for _ in range(3):
        fused_em.reset_launch_counts()  # the counts read below are one call's
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        x = sampler(gen)
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        dev_ms.append(a.elapsed_time(b))
    check(x.shape == (B, D) and torch.isfinite(x).all().item(), "generation output")
    gen_counts = fused_em.launch_counts()
    wall = min(walls[1:])  # steady state: the first call is the warm-up
    gen_res = dict(poses_per_s=B / wall, wall_s=wall, walls_s=walls,
                   median_poses_per_s=B / float(np.median(walls[1:])), event_ms=dev_ms,
                   steps=1000, batch=B, launches=gen_counts)
    print(f"[generation] 500 x 1000 steps: {B / wall:.1f} poses/s best, "
          f"{gen_res['median_poses_per_s']:.1f} median "
          f"({wall * 1e3:.1f} ms per call; calls {['%.3f' % w for w in walls]} s)")

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
    print(f"[metrics] APD {apd:.4f} in {APD_BAND}; protocol wall {res['metrics_wall_s']:.2f}s")
    return dict(generation=gen_res, metrics=dict(apd=apd, wall_s=res["metrics_wall_s"],
                                                 launches=demo_counts),
                by_run=dict(generation_500x1000=gen_counts,
                            demo_generation_metrics=demo_counts))


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
    """(i) K13 against its plain version at the sampler's shapes, per-tensor
    and per-channel rows, on states of a real trajectory (the bf16 kernel
    sampler's state after 500 of 1000 steps), with timings, bound, plain and
    library times; (ii) K14 in its four modes at the microbenchmarks'
    [512,1024]x[1024,1024]."""
    sde = SubVPSDE(N=1000)
    gen = torch.Generator(device=dev).manual_seed(11)
    i = 500
    x = fused_em.get_cuda_em_sampler(sde, model, (B, D), denoise=False, step_range=(0, i),
                                     rng_mode="kernel", device=dev)(gen)
    rows, variants = [], []
    for scheme in ("tensor", "channel"):
        net, _ = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", dev,
                                                 quant="int8", act_amax=amax[scheme])
        tp, gs, gb = net["tp_all"][i], net["gn_scale"], net["gn_bias"]
        lw = lambda j: score_net.layer_weights(net, j)  # noqa: E731
        h = score_net.dense_gn_silu_int8_plain(x, *lw(0), tp[0], gs[0], gb[0])
        h1 = score_net.dense_gn_silu_int8_plain(h, *lw(1), tp[1], gs[1], gb[1])
        for label, a, j, res in (("pre [500,63]x[63,1024]", x, 0, None),
                                 ("block [500,1024]x[1024,1024]", h, 1, None),
                                 ("block+residual [500,1024]x[1024,1024]", h1, 2, h)):
            args = (a, *lw(j), tp[j], gs[j], gb[j])
            ref = score_net.dense_gn_silu_int8_plain(*args, res)
            out = score_net.dense_gn_silu_int8(*args, residual=res)
            torch.cuda.synchronize()
            e, tol = err(out, ref), 1e-3 * max(1.0, float(ref.abs().max()))
            check(e <= tol, f"dense_gn_silu_int8 {scheme} {label}: max abs err {e} > {tol}")
            K = a.shape[1]
            n_bytes = (4 * B * K + K * H + 4 * K + 4 * 4 * H
                       + 4 * B * H * (2 if res is not None else 1))
            bms, by = bound(n_bytes, 2 * B * K * H, 14 * B * H, INT8_TC_OPS)
            o = torch.empty_like(ref)
            wq, qinv, qs = lw(j)
            kp = (K + 7) // 8 * 8  # torch._int_mm takes K in multiples of 8
            wq_t = F.pad(wq, (0, kp - K)).t()  # [K, N], column-major as cuBLASLt wants

            def library(a=a, qinv=qinv, qs=qs, j=j, res=res, K=K, kp=kp, wq_t=wq_t):
                aq = torch.clamp(torch.round(a * qinv), -127, 127).to(torch.int8)
                y = torch._int_mm(F.pad(aq, (0, kp - K)), wq_t).float() * qs + tp[j]
                y = F.silu(F.group_norm(y, 32, gs[j], gb[j], eps=1e-5))
                return y if res is None else y + res

            lib_e = float((library() - ref).abs().max())
            run = lambda args=args, res=res, o=o: score_net.dense_gn_silu_int8(  # noqa: E731
                *args, residual=res, out=o)
            variants.append(dict(
                shape=f"{label.split()[0]} {scheme} {label.split()[1]}", max_abs_err=e,
                tol=tol, ms=graph_ms(run), eager_ms=eager_ms(run),
                plain_ms=graph_ms(lambda args=args, res=res:
                                  score_net.dense_gn_silu_int8_plain(*args, res)),
                library_ms=graph_ms(library), library_max_abs_err=lib_e, bound_ms=bms,
                bound_by=by))
    main_v = next(v for v in variants if v["shape"].startswith("block+residual channel"))
    rows.append(dict(name="dense_gn_silu_int8", route="cuda",
                     source=f"{CSRC}/dense_gn_silu_int8.cu", replaces=TPU_KERNEL,
                     replaces_part="fused_em.py:62,104-110 quant_inv -> score_net.py:337-360 "
                                   "quant mm (int8 x int8 -> int32, rescale row), then the "
                                   "time row, group_norm_vpu, SiLU, h + h2",
                     max_abs_err=max(v["max_abs_err"] for v in variants),
                     tol="1e-3*max(1,|ref|max)",
                     **{k: main_v[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by")},
                     library="quantize + torch._int_mm (K padded to 64) + rescale + "
                             "group_norm + silu",
                     variants=variants))

    # (ii) K14 chain_link in its four modes
    a = torch.randn(mxu_micro.B, mxu_micro.H, generator=gen, device=dev)
    _, ws, ws_i8 = mxu_micro.make_inputs(dev, mxu_micro.B, mxu_micro.H)
    int8_rows = chain_link.int8_rows(mxu_micro.H, mxu_micro.H, dev)
    cvariants = []
    for mode in chain_link.MODES:
        w = ws_i8[0] if mode == "int8" else ws[0]
        rk = int8_rows if mode == "int8" else {}
        errs = []
        for update in (False, True):
            xs = torch.randn(a.shape, generator=gen, device=dev)
            ref = chain_link.chain_link_plain_into(a, w, mode, out=xs.clone(), update=update,
                                                   **rk)
            out = chain_link.chain_link(a, w, mode, out=xs, update=update, **rk)
            torch.cuda.synchronize()
            # bf16-out: one flipped rounding is a bf16 ulp, 2^-7 of the value
            tol = (8e-3 if mode == "bf16-out" else 1e-3) * max(1.0, float(ref.abs().max()))
            errs.append(err(out, ref))
            check(errs[-1] <= tol, f"chain_link {mode} update={update}: {errs[-1]} > {tol}")
        bms, by = bound(4 * a.numel() + (1 if mode == "int8" else 2) * w.numel()
                        + 4 * a.numel(), 2 * a.shape[0] * w.numel(),
                        14 * a.numel() if mode == "gn-silu" else 0,
                        INT8_TC_OPS if mode == "int8" else BF16_TC_FLOPS)
        o = torch.empty_like(a)
        a16 = a.to(torch.bfloat16)
        if mode == "int8":
            wt = w.t()
            library = lambda: torch._int_mm(  # noqa: E731
                torch.clamp(torch.round(a * chain_link.INT8_QINV), -127, 127).to(torch.int8),
                wt).float() * chain_link.INT8_SCALE
        elif mode == "gn-silu":
            library = lambda w=w: F.silu(F.group_norm(  # noqa: E731
                torch.matmul(a16, w).float(), 32, eps=1e-5))
        else:
            library = lambda w=w: torch.matmul(a16, w).float()  # noqa: E731
        run = lambda w=w, mode=mode, rk=rk: chain_link.chain_link(a, w, mode, out=o,  # noqa: E731
                                                                   **rk)
        cvariants.append(dict(
            shape=f"{mode} [512,1024]x[1024,1024]", max_abs_err=max(errs), ms=graph_ms(run),
            eager_ms=eager_ms(run),
            plain_ms=graph_ms(lambda w=w, mode=mode, rk=rk:
                              chain_link.chain_link_plain(a, w, mode, **rk)),
            library_ms=graph_ms(library), bound_ms=bms, bound_by=by))
    main_c = cvariants[0]
    rows.append(dict(name="chain_link", route="cuda", source=f"{CSRC}/chain_link.cu",
                     replaces=f"{TPU_MXU_KERNEL}; {TPU_ILP_KERNEL}",
                     replaces_part="mxu_micro.py:36-52 (one of the chain's matmuls, bf16 with "
                                   "fp32 or bf16 accumulation, or int8 with the requant) and "
                                   "ilp_probe.py:37-58 (matmul -> GN32 no affine -> SiLU), "
                                   "with the state update on a chain's last link",
                     max_abs_err=max(v["max_abs_err"] for v in cvariants),
                     tol="1e-3*max(1,|ref|max); bf16-out 8e-3 (one bf16 ulp)",
                     **{k: main_c[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by")},
                     library="torch.matmul bf16 (+ group_norm + silu); torch._int_mm int8",
                     variants=cvariants))
    for r in rows:
        kernel_row_line(r)
        for v in r["variants"]:
            print(f"    {v['shape']}: err {v['max_abs_err']:.3g}, {v['ms'] * 1e3:.2f} us "
                  f"(eager {v['eager_ms'] * 1e3:.2f}), plain {v['plain_ms'] * 1e3:.2f}, "
                  f"library {v['library_ms'] * 1e3:.2f}, bound {v['bound_ms'] * 1e3:.2f} us")
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
    return time.perf_counter() - t0, x, fused_em.launch_counts()


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
    walls = {m: [] for m in modes}
    for _ in range(3):  # the first turn warms up
        for m, s in samplers.items():
            wall, x, counts = timed_generation(s, gen)
            walls[m].append(wall)
            check(x.shape == (B, D) and torch.isfinite(x).all().item(), f"generation {m}")
            by_run[f"generation_500x1000_{m}"] = counts
    for m in modes:
        best = min(walls[m][1:])
        res[f"generation_{m}"] = dict(poses_per_s=B / best, wall_s=best, walls_s=walls[m],
                                      launches=by_run[f"generation_500x1000_{m}"])
        print(f"[int8] generation 500 x 1000 {m}: {B / best:.1f} poses/s best "
              f"(calls {['%.3f' % w for w in walls[m]]} s)")
    check(by_run["generation_500x1000_int8_channel"]["dense_gn_silu_int8"] == 5000 and
          by_run["generation_500x1000_int8_channel"]["dense_gn_silu"] == 0,
          "int8 generation did not run on K13")
    check(by_run["generation_500x1000_int8_mixed"]["dense_gn_silu_int8"] == 4500 and
          by_run["generation_500x1000_int8_mixed"]["dense_gn_silu"] == 500,
          "int8-mixed generation: 900 int8 steps and 100 bf16 steps")

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
                                       launches=by_run["demo_generation_metrics_int8_channel"])
    print(f"[int8] metrics per-channel: APD {apd:.4f} (bf16 {bf16_apd:.4f}), protocol wall "
          f"{r['metrics_wall_s']:.2f} s")

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
    print(f"[micro] both microbenchmarks in {wall:.1f} s, launches {counts['chain_link']}")
    return dict(results=dict(mxu_micro=mxu, ilp_probe=ilp, wall_s=wall),
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


def phase_train_kernels(model, dev):
    """K10, K11 and K12 at the flagship train step's shapes (batch 1,280), with
    dropout 0.1 and the plain version's mask, against their plain versions,
    with timings and bounds. The inputs are a real step's: the plain chain's
    activations on the pinned weights."""
    _, _, _, op = train_operands(model, dev)
    keep, seed = op["keep"], 20261016
    W, Wb, P, gw, gb = op["w_fwd"], op["w_bwd"], op["proj"], op["gn_w"], op["gn_b"]
    plain_f, plain_b = fused_train.dense_gn_silu_train_plain, fused_train.dense_gn_silu_bwd_plain
    fwd = [plain_f(op["x_pert"], W[0], P[0], gw[0], gb[0], seed, 0, keep)]
    for j in range(1, 5):
        a, res = fwd[-1][0], (fwd[j - 2][0] if j % 2 == 0 else None)
        fwd.append(plain_f(a, W[j], P[j], gw[j], gb[j], seed, j, keep, res))
    rows, extra = [], {}

    # K10: the three shapes of a step's forward
    variants = []
    for label, j in (("pre [1280,63]x[63,1024]", 0), ("block [1280,1024]x[1024,1024]", 1),
                     ("block+residual [1280,1024]x[1024,1024]", 2)):
        a = op["x_pert"] if j == 0 else fwd[j - 1][0]
        res = fwd[0][0] if j == 2 else None
        args = (a, W[j], P[j], gw[j], gb[j], seed, j, keep)
        ref = plain_f(*args, res)
        got = fused_train.dense_gn_silu_train(*args, residual=res)
        torch.cuda.synchronize()
        e_out, tol = err(got[0], ref[0]), 1e-3 * max(1.0, float(ref[0].abs().max()))
        e_bf = [err(g.float(), r.float()) for g, r in zip(got[1:3], ref[1:3])]
        tol_bf = [1e-2 * max(1.0, float(r.float().abs().max())) for r in ref[1:3]]
        e_rs = float(((got[3] - ref[3]).abs() / ref[3]).max())
        check(e_out <= tol and all(x <= y for x, y in zip(e_bf, tol_bf)) and e_rs <= 1e-3,
              f"dense_gn_silu_train {label}: out {e_out} (tol {tol}), stash/xhat {e_bf} "
              f"(tol {tol_bf}), rstd rel {e_rs}")
        # the kernel applied the plain version's mask: every dropped element
        # is the residual alone (the kept ones are held by the tolerance)
        dropped = ~fused_train.dropout_keep(seed, j, BT, H, keep, dev)
        base = torch.zeros_like(got[0]) if res is None else res
        check(torch.equal(got[0][dropped], base[dropped]),
              f"dense_gn_silu_train {label}: another dropout mask")
        K = a.shape[1]
        n_bytes = (4 * BT * K + 2 * K * H + 2 * BT * H + 2 * 4 * H + 4 * BT * H
                   + 2 * 2 * BT * H + 4 * BT * 32 + (4 * BT * H if res is not None else 0))
        bms, by = bound(n_bytes, 2 * BT * K * H, 40 * BT * H)
        bufs = [torch.empty_like(x) for x in ref]
        run = lambda: fused_train.dense_gn_silu_train(  # noqa: E731
            *args, residual=res, out=bufs[0], stash=bufs[1], xhat=bufs[2], rstd=bufs[3])
        lib_fwd, lib_fwd_bwd = library_layer(a, W[j], P[j], gw[j], gb[j], res,
                                             torch.randn_like(ref[0]))
        lib_ms = graph_ms(lib_fwd)
        lib_fb_ms = profiled_ms(lib_fwd_bwd)
        variants.append(dict(shape=label, max_abs_err=e_out, tol=tol, errs_stash_xhat=e_bf,
                             rstd_rel_err=e_rs, ms=graph_ms(run), eager_ms=eager_ms(run),
                             plain_ms=graph_ms(lambda: plain_f(*args, res)),
                             library_ms=lib_ms, library_fwd_bwd_ms=lib_fb_ms,
                             bound_ms=bms, bound_by=by))
    main_v = variants[2]
    rows.append(dict(name="dense_gn_silu_train", route="cuda",
                     source=f"{CSRC}/dense_gn_silu_train.cu", replaces=TPU_TRAIN_KERNEL,
                     replaces_part="fused_train.py:80 _make_kernel stack_fwd (:132-149), "
                                   "stash_in (:170-176)",
                     max_abs_err=max(v["max_abs_err"] for v in variants),
                     tol="out 1e-3*max(1,|ref|max); stash, xhat 1e-2*max(1,|ref|max) "
                         "(a bf16 ulp); rstd 1e-3 relative; the same dropout mask",
                     **{k: main_v[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by")},
                     library="bf16 matmul + group_norm + silu + dropout, forward",
                     variants=variants))

    # K11: the head and the loss seed on the last hidden state
    h4 = fwd[4][0]
    args11 = (h4, op["wpost_k"], op["bpost"], op["coefs"], op["z"])
    ref = fused_train.head_dsm_plain(*args11)
    got = fused_train.head_dsm(*args11)
    torch.cuda.synchronize()
    e_loss = float(((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1e-12)).max())
    e_dout, tol_dout = err(got[1], ref[1]), 1e-3 * float(ref[1].abs().max())
    check(e_loss <= 1e-3 and e_dout <= tol_dout,
          f"head_dsm: loss rows rel {e_loss}, dout {e_dout} (tol {tol_dout})")
    n11 = (4 * BT * H + 2 * H * score_net.HEAD_COLS + 4 * score_net.HEAD_COLS + 3 * 4 * BT
           + 2 * 4 * BT * D + 4 * BT)
    bms, by = bound(n11, 2 * BT * H * score_net.HEAD_COLS, 8 * BT * D)
    lr_b, do_b = torch.empty_like(ref[0]), torch.empty_like(ref[1])
    run11 = lambda: fused_train.head_dsm(*args11, loss_rows=lr_b, dout=do_b)  # noqa: E731
    rows.append(dict(
        name="head_dsm", route="cuda", source=f"{CSRC}/head_dsm.cu", replaces=TPU_TRAIN_KERNEL,
        replaces_part="fused_train.py:177-188 (post-dense, the DSM loss rows, dout)",
        shape="[1280,1024]x[1024,63]", max_abs_err=e_dout,
        tol="loss rows 1e-3 relative; dout 1e-3*|ref|max", loss_rows_rel_err=e_loss,
        ms=graph_ms(run11), eager_ms=eager_ms(run11),
        plain_ms=graph_ms(lambda: fused_train.head_dsm_plain(*args11)),
        library_ms=None, bound_ms=bms, bound_by=by))

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
        again = fused_train.dense_gn_silu_bwd(*args, g_res=g_res, g_out=g_out)
        check(all(torch.equal(a, b) for a, b in zip(got[2:], again[2:])),
              f"dense_gn_silu_bwd {label}: dgamma/dbeta differ between two launches")
        K = A.shape[1]
        n_bytes = (2 * BT * K + 2 * K * H + 2 * BT * H + 4 * BT * 32 + 2 * 4 * H + 2 * BT * H
                   + (4 * BT * H if g_res is not None else 0) + (4 * BT * H if with_out else 0)
                   + 2 * 4 * ((BT + 63) // 64) * H)
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
    for v, k10 in zip(variants, ("pre", "block", "block+residual")):
        v["library_ms"] = max(0.0, lib[k10]["library_fwd_bwd_ms"] - lib[k10]["library_ms"])
    main_v = variants[2]
    rows.append(dict(name="dense_gn_silu_bwd", route="cuda", source=f"{CSRC}/dense_gn_silu_bwd.cu",
                     replaces=TPU_TRAIN_KERNEL,
                     replaces_part="fused_train.py:151-166 stack_bwd with the mm(., W^T) hops "
                                   "of :193-206",
                     max_abs_err=max(v["max_abs_err"] for v in variants),
                     tol="dh 1e-2*|ref|max (a bf16 ulp); g, dgamma, dbeta 1e-3*|ref|max; "
                         "dgamma/dbeta equal over two launches",
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
    routes' dropout streams differ)."""
    m0 = copy.deepcopy(model).train()
    m0.dropout.p = 0.0
    batch, t, z, _ = train_operands(m0, dev)
    sde = SubVPSDE(N=1000)
    loss_k, grads_k = fused_train.get_cuda_train_loss_and_grad(sde, m0, reduce_mean=True)(
        batch, t=t, z=z, dropout_seed=1)
    named = [(n, p) for n, p in m0.named_parameters() if p.requires_grad]
    loss_r = tlosses.get_sde_loss_fn(sde, True, tlosses.make_model_apply(m0), reduce_mean=True)(
        tlosses.params_of(m0), batch, t=t, z=z)
    grads_r = torch.autograd.grad(loss_r, [p for _, p in named], allow_unused=True)
    ref = {n: g for (n, _), g in zip(named, grads_r) if g is not None}
    torch.cuda.synchronize()
    agree = grad_agreement(grads_k, ref)
    return dict(loss_kernel=float(loss_k), loss_fp32=float(loss_r.detach()),
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
              f"relative error {r['worst_rel'][1][1]:.4f} ({r['worst_rel'][0]})")
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


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        info = phase_device()
        build_s = phase_build()
        with torch.no_grad():
            model = load_pinned(dev)
            rows = phase_kernels(model, dev)
            comp_rows, k1_rc = phase_completion_kernels(model, dev)
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
        with torch.no_grad():
            int8 = phase_int8_protocols(model, dev, amax, proto["metrics"]["apd"],
                                        comp["results"]["completion2_pc"]["mpjpe_mm"])
            micro = phase_microbenchmarks()
        ode = phase_ode_protocols(model, dev)
        parity["train"] = phase_train_parity(model, dev)
        train = phase_train_protocols(dev)
        by_run = {**proto.pop("by_run"), **comp["by_run"], **int8["by_run"], **micro["by_run"],
                  **ode["by_run"], **train["by_run"]}
        for r in rows:
            r["launches_by_run"] = {k: v[r["name"]] for k, v in by_run.items()}
            r["launches"] = sum(r["launches_by_run"].values())
            check(r["launches"] > 0, f"kernel {r['name']} was never launched on a main path")
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
    print(f"[generation] kernels alone: {1000 * step_ms:.1f} ms per call, so the device "
          f"is busy ~{100 * gen['device_busy_share_est']:.0f}% of the best call")
    # the same estimate for a solve: 200 steps of K5, K1 x5 and K6 at 1000 rows
    fwd_rc = k1_rc["pre"] + 2 * k1_rc["block"] + 2 * k1_rc["block+residual"]
    solve_ms = 200 * (ms["comp_perturb"] + fwd_rc + ms["head_adam"])
    sol = comp["results"]["solver"]
    sol["device_ms_per_call_est"] = solve_ms
    sol["device_busy_share_est"] = solve_ms / (1e3 * sol["wall_s"])
    print(f"[completion] kernels alone: {solve_ms:.1f} ms per solve, so the device is busy "
          f"~{100 * sol['device_busy_share_est']:.0f}% of the best call")
    proto["completion"] = comp["results"]
    # and for the PF-ODE paths: 4 x 125 stages of K1 x5 and K8 at 500 rows; 4 x 100
    # stages of K7 x5 and K9 at 50 rows
    k7 = {v["shape"].split()[0]: v["ms"]
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
    # and for a train step: K10 x5, K11 and K12 x5 at batch 1,280
    by_name = {r["name"]: r for r in rows}
    k10 = {v["shape"].split()[0]: v["ms"] for v in by_name["dense_gn_silu_train"]["variants"]}
    k12 = {v["shape"].split()[0]: v["ms"] for v in by_name["dense_gn_silu_bwd"]["variants"]}
    step_k = (k10["pre"] + 2 * k10["block"] + 2 * k10["block+residual"] + ms["head_dsm"]
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
        g["device_ms_per_call_est"] = 1000 * step13
        g["device_busy_share_est"] = 1000 * step13 / (1e3 * g["wall_s"])
        print(f"[int8] generation {scheme}: kernels alone {1000 * step13:.1f} ms per call, "
              f"the device busy ~{100 * g['device_busy_share_est']:.0f}% of the best call")
    proto["int8"] = dict(int8["results"], calibration_s=calib_s,
                         act_amax_tensor=[float(a) for a in amax["tensor"]],
                         act_amax_channel_max=[float(np.max(a)) for a in amax["channel"]])
    proto["microbenchmarks"] = micro["results"]
    proto["launches_by_run"] = by_run
    summary = dict(device=info, build_s=build_s, kernels=rows,
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
