"""K1's pre layer on its load variants, on the card.

The pre layer reads the [B, 63] fp32 state: a 252-byte row stride that TMA
cannot take. ``ops/cuda/csrc/dense_gn_silu.cu``'s pre route loads a 64-row
block of it (one contiguous span) into shared memory, rounds it once into
the swizzled bf16 tile and runs one ``wgmma`` stage. Timed here at
generation's 500 rows and completion's 1,000, by CUDA-graph replay, in
turns: the pre route as shipped (one bulk copy a span where it starts
16-byte aligned; one CTA an SM where the grid fits the SMs once, two beyond,
by the shared memory a launch reserves) and with the source's lines
substituted: two CTAs an SM at every size, no reservation (as many as the
registers allow), the span read by every thread's 16-byte loads.

Each alone (a launch chained to itself) and followed by a block's first
K = 1024 layer on the bf16 route reading the copy it wrote, as in a
sampler's chain; every launch is programmatic (``csrc/mbarrier.cuh``).
Then each variant's build under a generation call at 500 rows x 1,000
steps and a completion solve at 1,000 rows x 200 steps, their graphs
captured on it. Every output is compared bit for bit with the shipped
build's.

    python -m dposer_tpu_torch.benchmarks.k1_pre [--rounds 2]

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


def variant_source(variant: str) -> str:
    """``dense_gn_silu.cu`` under ``variant``; raises if a substitution no
    longer applies to the shipped source."""
    text = (build.CSRC / "dense_gn_silu.cu").read_text()
    for old, new in VARIANTS[variant]:
        if old not in text:
            raise ValueError(f"variant {variant!r}: {old!r} not in dense_gn_silu.cu")
        text = text.replace(old, new)
    return text


def compile_all(work: Path) -> dict:
    """Every variant compiled at once into ``work``: ``{variant: library}``."""
    procs = {}
    for i, variant in enumerate(VARIANTS):
        d = work / f"v{i}"
        d.mkdir()
        (d / "dense_gn_silu.cu").write_text(variant_source(variant))
        lib = d / "dense_gn_silu.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
               str(d / "dense_gn_silu.cu")]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True), lib)
    libs = {}
    for variant, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant!r}:\n{log}")
        libs[variant] = ctypes.CDLL(str(lib))
        fn = libs[variant].dposer_dense_gn_silu
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes, fn.restype = [P] * 9 + [I, I, I, P], I
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_pre: no CUDA device; this benchmark runs on the card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    times, bits = {}, {}
    with tempfile.TemporaryDirectory(prefix="k1_pre_") as work:
        libs = compile_all(Path(work))
        ops = {B: operands(dev, B) for B in (500, 1000)}
        for B, o in ops.items():  # outputs: each variant's (h, hq) against the shipped build's
            outs = {}
            for variant in VARIANTS:
                launcher(libs[variant], o, False)()
                torch.cuda.synchronize()
                outs[variant] = (o["h"].clone(), o["hq"].clone())
            ref = outs["shipped"]
            for variant, (h, hq) in outs.items():
                bits[f"{variant} [{B}]"] = bool(torch.equal(h, ref[0])
                                                and torch.equal(hq, ref[1]))
        calls = sampler_calls(dev)
        try:
            for name, make in calls.items():  # a call's output on each variant, same seed
                ref = None
                for variant in VARIANTS:
                    out = make(libs[variant])(torch.Generator(device=dev).manual_seed(11))
                    ref = out if ref is None else ref
                    bits[f"{variant}: {name}"] = bool(torch.equal(out, ref))
            for r in range(args.rounds):
                for variant in list(VARIANTS) + list(VARIANTS)[::-1]:
                    for B, o in ops.items():
                        for chain in (False, True):
                            us = graph_us(launcher(libs[variant], o, chain))
                            key = variant + (" + block layer" if chain else "")
                            times.setdefault(key, {}).setdefault(str(B), []).append(us)
                            print(f"[k1_pre] round {r} {key}: [{B}] {us:.2f} us")
                for variant in list(VARIANTS) + list(VARIANTS)[::-1]:
                    for name, make in calls.items():
                        ms = call_ms(make(libs[variant]), dev, args.calls)
                        times.setdefault(variant, {}).setdefault(name, []).append(ms)
                        print(f"[k1_pre] round {r} {variant}: {name} {ms:.3f} ms a call")
        finally:  # the samplers built here took the variants' libraries
            build._loaded.pop("dense_gn_silu", None)
    print(f"[k1_pre] bit-equal to the shipped build (kernels and calls): {bits}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "us": times,
                      "bit_equal": bits}))
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
