#!/usr/bin/env python3
"""Drive the PyTorch port (``dposer_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases; any failure exits non-zero:

1. device: the card's name, count and power limit;
2. build: the CUDA kernels from ``dposer_tpu_torch/ops/cuda/csrc`` with nvcc
   (``-Xptxas -v`` printed);
3. each kernel against its plain PyTorch version at the main path's shapes,
   on the pinned trained weights, with the in-kernel normals' moments, and
   its device time (CUDA-graph replay, so host overhead is excluded) beside
   the plain version's, a library yardstick's and the bound from bytes and
   operations at the published H100 SXM peaks;
4. the whole kernel sampler against the same loop on the plain versions,
   N = 20, injected noise, corrector none and langevin: step by step, and
   row by row on the free-running trajectories;
5. the slice's protocols at flagship size with every launch counter read:
   (a) generation, 500 poses x 1000 sub-VP EM steps, in-kernel normals:
   poses/s; (b) the demo's generation task with ``--metrics`` (50 poses,
   then 500 poses x 1000 steps with the langevin corrector at eps 5e-3,
   through the SMPL body): APD must lie in [0.80, 1.00];
6. one ``{"kernels": [...]}`` line, the card's name and power limit, and the
   final ``{"ok": true, ...}`` line.

Needs the repository around it (the port, the pinned checkpoint under
``artifacts/trained_r5`` and ``tests/fixtures.py`` for the synthetic SMPL
body); writes only under ``chiprun_out/chip_smoke``.
"""
import json
import os
import subprocess
import sys
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
from dposer_tpu_torch.config import get_config  # noqa: E402
from dposer_tpu_torch.diffusion import fast_sampler as tfs  # noqa: E402
from dposer_tpu_torch.diffusion.sde import SubVPSDE  # noqa: E402
from dposer_tpu_torch.ops.cuda import build, fused_em, score_net  # noqa: E402
from fixtures import make_synthetic_body_model  # noqa: E402

ART = os.path.join(REPO, "artifacts", "trained_r5")
CKPT = os.path.join(ART, "axis-zscore-400k-synth.pth")
STATS = os.path.join(ART, "stats")
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
TPU_KERNEL = "dposer_tpu/ops/pallas/fused_em.py:467"
CSRC = "dposer_tpu_torch/ops/cuda/csrc"

# published H100 SXM peaks (dense), at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
FP32_FLOPS = 67e12
APD_BAND = (0.80, 1.00)
B, H, D = 500, 1024, 63


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def bound(n_bytes, tc_flops, fp32_ops):
    """(least ms, what bounds it): bytes over the memory rate against the
    operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(tc_flops / BF16_TC_FLOPS, fp32_ops / FP32_FLOPS)
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
    zk = torch.cat(draws)
    k2_moments = (float(zk.mean()), float(zk.std()), zk.numel())
    check(zk.numel() >= 100000 and abs(k2_moments[0]) < 0.01 and abs(k2_moments[1] - 1) < 0.01,
          f"head_em in-kernel normals: mean/std/n {k2_moments}")
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
    zk = torch.cat(draws)
    k3_moments = (float(zk.mean()), float(zk.std()), zk.numel())
    check(abs(k3_moments[0]) < 0.01 and abs(k3_moments[1] - 1) < 0.01,
          f"langevin_update in-kernel normals: mean/std/n {k3_moments}")
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
        print(f"[kernel] {r['name']}: err {r['max_abs_err']:.3g} ({r['tol']}), "
              f"{r['ms'] * 1e3:.2f} us/launch (eager {r['eager_ms'] * 1e3:.2f}), plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']}), library "
              f"{'-' if r['library_ms'] is None else '%.2f us' % (r['library_ms'] * 1e3)}")
    return rows


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
    fused_em.reset_launch_counts()
    # (a) generation: 500 poses x 1000 sub-VP EM steps, in-kernel normals
    config = get_config()
    sde = SubVPSDE(N=1000)
    sampler = demo.build_sampler(config, sde, model, B, 1e-3, "none", dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    walls, dev_ms = [], []
    for _ in range(5):
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
    counts = {k: gen_counts[k] + demo_counts[k] for k in gen_counts}
    for k, v in counts.items():
        check(v > 0, f"kernel {k} was never launched on the main path")
    return dict(generation=gen_res, metrics=dict(apd=apd, wall_s=res["metrics_wall_s"],
                                                 launches=demo_counts),
                launches=counts, by_run=dict(generation_500x1000=gen_counts,
                                             demo_generation_metrics=demo_counts))


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
            parity = phase_parity(model, dev)
            proto = phase_protocols(model, dev)
    except PhaseError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    for r in rows:
        r["launches"] = proto["launches"][r["name"]]
        r["launches_by_run"] = {k: v[r["name"]] for k, v in proto["by_run"].items()}
    # the device's share of a generation call: one step's kernel times (graph
    # replay, so no host gaps) x 1000 steps, over the call's wall time
    k1 = {v["shape"].split()[0]: v["ms"] for v in rows[0]["variants"]}
    step_ms = k1["pre"] + 2 * k1["block"] + 2 * k1["block+residual"] + rows[1]["ms"]
    gen = proto["generation"]
    gen["device_ms_per_call_est"] = 1000 * step_ms
    gen["device_busy_share_est"] = 1000 * step_ms / (1e3 * gen["wall_s"])
    print(f"[generation] kernels alone: {1000 * step_ms:.1f} ms per call, so the device "
          f"is busy ~{100 * gen['device_busy_share_est']:.0f}% of the best call")
    summary = dict(device=info, build_s=build_s, kernels=rows, parity=parity,
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
