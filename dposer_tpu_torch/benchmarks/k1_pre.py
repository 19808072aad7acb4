"""The pre layers of K1 and K13 on their variants, on the card.

The pre layer reads the [B, 63] fp32 state: a 252-byte row stride that TMA
cannot take. ``ops/cuda/csrc/dense_gn_silu.cu``'s pre route (K1) loads a
64-row block of it (one contiguous span) into shared memory, rounds it once
into the swizzled bf16 tile and runs one ``wgmma`` stage;
``dense_gn_silu_int8.cu``'s pre route (K13) does the same with int8
quantization and Wq's 64-row span laid out before the wait. Timed here at
generation's 500 rows and completion's 1,000, by CUDA-graph replay, in
turns. K1: the pre route as shipped (one bulk copy a span where it starts
16-byte aligned; one CTA an SM where the grid fits the SMs once, two beyond,
by the shared memory a launch reserves) and with the source's lines
substituted: two CTAs an SM at every size, no reservation (as many as the
registers allow), the span read by every thread's 16-byte loads. K13: the
pre route as shipped, with two CTAs an SM at every size, and the
register-staged loop (``dense_gemm_int8.cuh``), the route line taken out of
the source.

Each alone (a launch chained to itself) and followed by a block's first
K = 1024 layer reading the copy it wrote (K1's bf16 route, K13's Hopper
int8 loop), as in a sampler's chain; every launch is programmatic
(``csrc/mbarrier.cuh``). Then each variant's build under its sampler calls,
their graphs captured on it: K1 a generation call at 500 rows x 1,000 steps
and a completion solve at 1,000 rows x 200 steps, K13 an int8 (per channel)
generation call at 500 rows x 1,000 steps. Every output is compared bit for
bit with the shipped build's.

    python -m dposer_tpu_torch.benchmarks.k1_pre [--rounds 2] [--kernels k1,k13]

Prints a line per (variant, shape or call) and one JSON line with every time and the
card's name and power limit. Needs the card and nvcc; writes nothing in the
package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops.cuda import build
from .train_rings import graph_us

H, D = 1024, 63
BULK = ("  const int n_bulk = reinterpret_cast<uintptr_t>(span) % 16 == 0 ? n & ~3 : 0;\n")
LOADS = ("  if (tid == 0 && n_bulk > 0) bulk_copy(sm_s + RAW, span, 4 * n_bulk, bar);\n"
         "  for (int i = n_bulk + tid; i < n; i += THREADS) raw[i] = span[i];\n")
CTAS = "inline int ctas_per_sm(bool one_wave) { return one_wave ? 1 : 2; }"
DYN = "  const int dyn = pre::reserve(pre::ctas_per_sm(one_wave));"
# name: [(old, new)] substitutions into dense_gn_silu.cu
VARIANTS = {
    "shipped": [],
    # the grid packs two CTAs an SM where it fits the SMs once too
    "two an SM": [(CTAS, "inline int ctas_per_sm(bool) { return 2; }")],
    # no shared memory reserved: as many CTAs an SM as the registers allow
    "as registers allow": [(DYN, "  const int dyn = 0;")],
    "16-byte loads": [
        (BULK, "  const int n_bulk = 0;\n"
               "  const int n_vec = reinterpret_cast<uintptr_t>(span) % 16 == 0 ? n & ~3 : 0;\n"),
        (LOADS, "  for (int i = tid; i < n_vec / 4; i += THREADS)\n"
                "    reinterpret_cast<float4*>(raw)[i] = reinterpret_cast<const float4*>(span)[i];\n"
                "  for (int i = n_vec + tid; i < n; i += THREADS) raw[i] = span[i];\n")],
}


# K13: the pre route as shipped, with two CTAs an SM at every size, and the
# register-staged loop (the pre route's line taken out)
K13_VARIANTS = {
    "pre route": [],
    "two an SM": [(CTAS, "inline int ctas_per_sm(bool) { return 2; }")],
    "register route": [("  if (a.K <= pre::KMAX) return launch_pre<GS>(a, grid);\n", "")],
}
# library: (its source's variants, the pointers and ints its C entry takes)
KERNELS = {"dense_gn_silu": (VARIANTS, 9, 3), "dense_gn_silu_int8": (K13_VARIANTS, 12, 3)}


def variant_source(variant: str, lib: str = "dense_gn_silu") -> str:
    """``<lib>.cu`` under ``variant``; raises if a substitution no longer
    applies to the shipped source."""
    text = (build.CSRC / f"{lib}.cu").read_text()
    for old, new in KERNELS[lib][0][variant]:
        if old not in text:
            raise ValueError(f"variant {variant!r}: {old!r} not in {lib}.cu")
        text = text.replace(old, new)
    return text


def compile_all(work: Path, lib: str = "dense_gn_silu") -> dict:
    """Every variant of ``lib`` compiled at once into ``work``: ``{variant:
    library}``."""
    variants, n_ptr, n_int = KERNELS[lib]
    procs = {}
    for i, variant in enumerate(variants):
        d = work / f"{lib}_v{i}"
        d.mkdir()
        (d / f"{lib}.cu").write_text(variant_source(variant, lib))
        so = d / f"{lib}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so),
               str(d / f"{lib}.cu")]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True), so)
    libs = {}
    for variant, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant!r}:\n{log}")
        libs[variant] = ctypes.CDLL(str(so))
        fn = getattr(libs[variant], f"dposer_{lib}")
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes, fn.restype = [P] * n_ptr + [I] * n_int + [P], I
    return libs


def operands(dev, B: int) -> dict:
    """The pre layer's operands at ``B`` rows, the next layer's weights, and
    the outputs."""
    g = torch.Generator(device=dev).manual_seed(B)

    def rn(*s, sc=1.0, dt=torch.float32):
        return (sc * torch.randn(*s, generator=g, device=dev)).to(dt)

    return dict(x=rn(B, D), w0=rn(D, H, sc=D ** -0.5, dt=torch.bfloat16),
                w1=rn(H, H, sc=H ** -0.5, dt=torch.bfloat16),
                rows=[rn(H), 1 + rn(H, sc=0.1), rn(H, sc=0.1)],
                h=torch.empty(B, H, device=dev),
                hq=torch.empty(B, H, dtype=torch.bfloat16, device=dev),
                h1q=torch.empty(B, H, dtype=torch.bfloat16, device=dev), B=B)


def launcher(lib, o: dict, chain: bool):
    """A callable that launches the pre layer (and, with ``chain``, a block's
    first layer after it) on the current stream."""
    fn = lib.dposer_dense_gn_silu
    tp, gm, bt = (t.data_ptr() for t in o["rows"])
    B = o["B"]

    def run():
        s = torch.cuda.current_stream().cuda_stream
        err = fn(o["x"].data_ptr(), None, o["w0"].data_ptr(), tp, gm, bt, None,
                 o["h"].data_ptr(), o["hq"].data_ptr(), B, D, H, s)
        if chain and not err:
            err = fn(None, o["hq"].data_ptr(), o["w1"].data_ptr(), tp, gm, bt, None, None,
                     o["h1q"].data_ptr(), B, H, H, s)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return run


def operands_int8(dev, B: int) -> dict:
    """K13's pre layer's operands at ``B`` rows (int8 Wq [H, D], its
    quantization and rescale rows), a block's first layer's, and the outputs
    with their int8 copies."""
    g = torch.Generator(device=dev).manual_seed(B + 1)

    def uni(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=dev)

    def wq(*s):
        return torch.randint(-127, 128, s, generator=g, device=dev, dtype=torch.int8)

    return dict(x=torch.randn(B, D, generator=g, device=dev), wq0=wq(H, D), wq1=wq(H, H),
                qinv=[uni(D, 10, 60), uni(H, 10, 60), uni(H, 10, 60)],
                qs=[uni(H, 1e-5, 1e-4), uni(H, 1e-6, 1e-5)],
                rows=[torch.randn(H, generator=g, device=dev), 1 + uni(H, -0.1, 0.1),
                      uni(H, -0.1, 0.1)],
                h=torch.empty(B, H, device=dev), h1=torch.empty(B, H, device=dev),
                hq=torch.empty(B, H, dtype=torch.int8, device=dev),
                h1q=torch.empty(B, H, dtype=torch.int8, device=dev), B=B)


def launcher_int8(lib, o: dict, chain: bool):
    """A callable that launches K13's pre layer (writing its int8 copy) and,
    with ``chain``, a block's first layer on that copy after it."""
    fn = lib.dposer_dense_gn_silu_int8
    tp, gm, bt = (t.data_ptr() for t in o["rows"])
    q0, q1, q2 = (t.data_ptr() for t in o["qinv"])
    s0, s1 = (t.data_ptr() for t in o["qs"])
    B = o["B"]

    def run():
        s = torch.cuda.current_stream().cuda_stream
        err = fn(o["x"].data_ptr(), None, o["wq0"].data_ptr(), q0, s0, tp, gm, bt, None,
                 o["h"].data_ptr(), q1, o["hq"].data_ptr(), B, D, H, s)
        if chain and not err:
            err = fn(None, o["hq"].data_ptr(), o["wq1"].data_ptr(), q1, s1, tp, gm, bt, None,
                     o["h1"].data_ptr(), q2, o["h1q"].data_ptr(), B, H, H, s)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return run


def sampler_calls(dev) -> dict:
    """``{name: build(lib) -> call(gen)}``: generation at 500 rows x 1,000
    steps and a completion solve at 1,000 rows x 2 x 100 Adam steps (the
    benchmark's shapes, the flagship widths, random weights), each built
    (its graph captured) on K1's library ``lib``."""
    from ..diffusion import sde as tsde
    from ..models import ScoreModelFC
    from ..ops.cuda.fused_comp import get_cuda_comp_solver
    from ..ops.cuda.fused_em import get_cuda_em_sampler
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=H, embed_dim=512, n_blocks=2,
                         dropout=0.0).eval().to(dev)
    sde = tsde.SubVPSDE(N=1000)
    g = torch.Generator(device=dev).manual_seed(62)
    obs = 0.3 * torch.randn(1000, D, generator=g, device=dev)
    mask = torch.ones(1000, D, device=dev)
    mask[:, 0:12] = 0.0

    def generation(lib):
        build._loaded["dense_gn_silu"] = lib
        fn = get_cuda_em_sampler(sde, model, (500, D), rng_mode="kernel", device="cuda")
        return lambda gen: fn(gen)

    def solve(lib):
        build._loaded["dense_gn_silu"] = lib
        fn = get_cuda_comp_solver(sde, model, (1000, D), 100 * D, iterations=2,
                                  steps_per_iter=100, rng_mode="kernel", device="cuda")
        return lambda gen: fn(gen, obs, mask)

    return {"generation 500x1000": generation, "solve 1000x200": solve}


def int8_calls(dev) -> dict:
    """``{name: build(lib) -> call(gen)}``: an int8 (per channel) generation
    call at 500 rows x 1,000 steps (the benchmark's int8 cell's shape, the
    flagship widths, random weights, ranges calibrated on 256 poses), built
    on K13's library ``lib``."""
    from ..diffusion import sde as tsde
    from ..models import ScoreModelFC
    from ..ops.cuda import quant
    from ..ops.cuda.fused_em import get_cuda_em_sampler
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=H, embed_dim=512, n_blocks=2,
                         dropout=0.0).eval().to(dev)
    sde = tsde.SubVPSDE(N=1000)
    amax = quant.calibrate_act_amax_per_channel(sde, model, (256, D),
                                                torch.Generator(device=dev).manual_seed(1),
                                                device=dev)

    def generation(lib):
        build._loaded["dense_gn_silu_int8"] = lib
        fn = get_cuda_em_sampler(sde, model, (500, D), rng_mode="kernel", quant="int8",
                                 act_amax=amax, device="cuda")
        return lambda gen: fn(gen)

    return {"int8 generation 500x1000": generation}


def call_ms(call, dev, n: int) -> float:
    """The median device-clock ms of ``n`` calls (CUDA events around each),
    after two (the first captures the graph)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    for _ in range(2):
        call(gen)
    ms = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        call(gen)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return sorted(ms)[n // 2]


def timed(tag: str, lib: str, libs: dict, ops: dict, launch, calls: dict, rounds: int,
          n_calls: int, dev, times: dict, bits: dict) -> None:
    """Every variant of ``lib`` (``libs``): its outputs at each shape and in
    each call against the first variant's, bit for bit, into ``bits``; then
    ``rounds`` rounds of the layer alone and chained (``launch``) and of the
    calls, each round the variants forth and back, into ``times``."""
    variants = list(libs)
    for B, o in ops.items():  # outputs: each variant's (h, copy) against the first's
        outs = {}
        for variant in variants:
            launch(libs[variant], o, False)()
            torch.cuda.synchronize()
            outs[variant] = (o["h"].clone(), o["hq"].clone())
        ref = outs[variants[0]]
        for variant, (h, hq) in outs.items():
            bits[f"{variant} [{B}]"] = bool(torch.equal(h, ref[0]) and torch.equal(hq, ref[1]))
    try:
        for name, make in calls.items():  # a call's output on each variant, same seed
            ref = None
            for variant in variants:
                out = make(libs[variant])(torch.Generator(device=dev).manual_seed(11))
                ref = out if ref is None else ref
                bits[f"{variant}: {name}"] = bool(torch.equal(out, ref))
        for r in range(rounds):
            for variant in variants + variants[::-1]:
                for B, o in ops.items():
                    for chain in (False, True):
                        us = graph_us(launch(libs[variant], o, chain))
                        key = variant + (" + block layer" if chain else "")
                        times.setdefault(key, {}).setdefault(str(B), []).append(us)
                        print(f"[{tag}] round {r} {key}: [{B}] {us:.2f} us")
            for variant in variants + variants[::-1]:
                for name, make in calls.items():
                    ms = call_ms(make(libs[variant]), dev, n_calls)
                    times.setdefault(variant, {}).setdefault(name, []).append(ms)
                    print(f"[{tag}] round {r} {variant}: {name} {ms:.3f} ms a call")
    finally:  # the samplers built here took the variants' libraries
        build._loaded.pop(lib, None)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--kernels", default="k1,k13", help="k1, k13 or both, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_pre: no CUDA device; this benchmark runs on the card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    kernels = args.kernels.split(",")
    times, bits = {}, {}
    with tempfile.TemporaryDirectory(prefix="k1_pre_") as work:
        if "k1" in kernels:
            timed("k1_pre", "dense_gn_silu", compile_all(Path(work), "dense_gn_silu"),
                  {B: operands(dev, B) for B in (500, 1000)}, launcher, sampler_calls(dev),
                  args.rounds, args.calls, dev, times.setdefault("k1", {}),
                  bits.setdefault("k1", {}))
        if "k13" in kernels:
            timed("k13_pre", "dense_gn_silu_int8", compile_all(Path(work), "dense_gn_silu_int8"),
                  {B: operands_int8(dev, B) for B in (500, 1000)}, launcher_int8,
                  int8_calls(dev), args.rounds, args.calls, dev, times.setdefault("k13", {}),
                  bits.setdefault("k13", {}))
    print(f"[k1_pre] bit-equal to the first variant's build (kernels and calls): {bits}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "us": times,
                      "bit_equal": bits}))
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
