"""The cluster heads K6 ``head_adam``, K8 ``head_rk4`` and K11 ``head_dsm``
against the shapes their design left out, on the card.

All three run ``ops/cuda/csrc/head_cluster.cuh`` split over clusters of 4 CTAs a
16-row tile, the tile's rows KC + 8 elements apart. Each variant here is the
shipped source with one substitution (clusters of 8 CTAs: half the depth a
CTA, twice the CTAs and the pushes; or rows KC apart, where the A fragment
loads of a warp's eight rows meet in one group of banks), compiled into a
temporary directory, checked against the shipped build's output and timed by
CUDA-graph replay beside it, in turns, at the main paths' shapes: K6's Adam
step (with the paste) at the completion solver's [1000, 1024] x [1024, 63],
K8's RK4 stage 1 at ODE sampling's [500, 1024] x [1024, 63], K11 at the train
step's [1280, 1024] x [1024, 63] on the bf16 stash and on fp32 h.

    python -m dposer_tpu_torch.benchmarks.head_splits [--rounds 2]

Prints a line per (variant, shape) and one JSON line with every time and the
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

B_COMP, B_ODE, B_TRAIN, H, D, COLS = 1000, 500, 1280, 1024, 63, 64
HEADER = "head_cluster.cuh"
# name: {file: (old, new)}: a substitution in a kernel's own source (that
# kernel's variant only) or in the cluster head (both kernels')
VARIANTS = {
    "shipped": {},
    "clusters of 8": {"head_adam.cu": ("using Adam = hc::Tile<4>;", "using Adam = hc::Tile<8>;"),
                      "head_rk4.cu": ("using Rk4 = hc::Tile<4>;", "using Rk4 = hc::Tile<8>;"),
                      "head_dsm.cu": ("constexpr int SPLIT = 4;", "constexpr int SPLIT = 8;")},
    "rows KC apart": {HEADER: ("constexpr int a_ld(int KC) { return KC + 8; }",
                               "constexpr int a_ld(int KC) { return KC; }")},
}
KERNELS = ("head_adam", "head_rk4", "head_dsm")


def variant_sources(kernel: str, variant: str) -> dict:
    """``{file name: text}`` of ``kernel``'s source under ``variant``: the
    kernel's ``.cu`` and, where the variant changes it, the cluster head.
    Raises if a substitution no longer applies to the shipped sources."""
    files = {f"{kernel}.cu": (build.CSRC / f"{kernel}.cu").read_text()}
    for name, (old, new) in VARIANTS[variant].items():
        if name not in (f"{kernel}.cu", HEADER):
            continue
        text = files.get(name) or (build.CSRC / name).read_text()
        if old not in text:
            raise ValueError(f"variant {variant!r}: {old!r} not in {name}")
        files[name] = text.replace(old, new)
    return files


def compile_all(work: Path) -> dict:
    """Every (kernel, variant) compiled at once into ``work``: ``{(kernel,
    variant): library path}``. The variant's files come first on the include
    path, so a changed header shadows the package's."""
    procs = {}
    for kernel in KERNELS:
        for i, variant in enumerate(VARIANTS):
            d = work / f"{kernel}_{i}"
            d.mkdir()
            for name, text in variant_sources(kernel, variant).items():
                (d / name).write_text(text)
            lib = d / f"{kernel}.so"
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d), "-I", str(build.CSRC),
                   "-o", str(lib), str(d / f"{kernel}.cu")]
            procs[kernel, variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib
    return libs


def shapes(dev) -> dict:
    """``{shape: (kernel, call(lib) -> (launch, outputs))}``: the main paths'
    operands and a callable that launches ``lib``'s entry on them."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*s, sc=1.0):
        return sc * torch.randn(*s, generator=g, device=dev)

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    P, I = ctypes.c_void_p, ctypes.c_int
    w_post = torch.zeros(H, COLS, device=dev)
    w_post[:, :D] = rn(H, D, sc=H ** -0.5)
    w_post = w_post.to(torch.bfloat16)
    b_post = torch.zeros(COLS, device=dev)
    b_post[:D] = rn(D)
    out = {}

    h6, coefs6 = rn(B_COMP, H), torch.rand(4, 8, generator=g, device=dev)
    x6, pert6, obs6 = rn(B_COMP, D), rn(B_COMP, D), rn(B_COMP, D)
    mask6 = (torch.rand(B_COMP, D, generator=g, device=dev) < 0.5).float()
    m6, v6 = rn(B_COMP, D, sc=0.1), rn(B_COMP, D, sc=0.01).abs()

    def k6(lib):
        fn = lib.dposer_head_adam
        fn.argtypes, fn.restype = [P, P, P, P, I] + [P] * 6 + [I, I, I, I, P], I
        st = [t.clone() for t in (x6, m6, v6)]
        return (lambda: fn(h6.data_ptr(), w_post.data_ptr(), b_post.data_ptr(), coefs6.data_ptr(),
                           2, st[0].data_ptr(), pert6.data_ptr(), obs6.data_ptr(),
                           mask6.data_ptr(), st[1].data_ptr(), st[2].data_ptr(), 1, B_COMP, H, D,
                           stream())), st
    out["K6 paste [1000,1024]x[1024,63]"] = ("head_adam", k6)

    h8, coefs8 = rn(B_ODE, H), torch.rand(3, 8, generator=g, device=dev)
    x8, xs8, acc8 = rn(B_ODE, D), rn(B_ODE, D), rn(B_ODE, D)

    def k8(lib):
        fn = lib.dposer_head_rk4
        fn.argtypes, fn.restype = [P, P, P, P, I, I, P, P, P, I, I, I, P], I
        st = [t.clone() for t in (x8, xs8, acc8)]
        return (lambda: fn(h8.data_ptr(), w_post.data_ptr(), b_post.data_ptr(), coefs8.data_ptr(),
                           1, 1, *[t.data_ptr() for t in st], B_ODE, H, D, stream())), st
    out["K8 stage 1 [500,1024]x[1024,63]"] = ("head_rk4", k8)

    h11 = rn(B_TRAIN, H)
    coefs11 = torch.stack([-torch.rand(B_TRAIN, generator=g, device=dev) - 0.1,
                           torch.rand(B_TRAIN, generator=g, device=dev) + 0.5,
                           torch.full((B_TRAIN,), 1.0 / (D * B_TRAIN), device=dev)], 1)
    z11 = rn(B_TRAIN, D)
    for label, hh in (("K11 [1280,1024] bf16 stash x[1024,63]", h11.to(torch.bfloat16)),
                      ("K11 [1280,1024] fp32 h x[1024,63]", h11)):
        def k11(lib, hh=hh):
            fn = lib.dposer_head_dsm
            fn.argtypes, fn.restype = [P, I] + [P] * 6 + [I, I, I, P], I
            lr, do = torch.empty(B_TRAIN, device=dev), torch.empty(B_TRAIN, D, device=dev)
            return (lambda: fn(hh.data_ptr(), int(hh.dtype == torch.bfloat16), w_post.data_ptr(),
                               b_post.data_ptr(), coefs11.data_ptr(), z11.data_ptr(),
                               lr.data_ptr(), do.data_ptr(), B_TRAIN, H, D, stream())), [lr, do]
        out[label] = ("head_dsm", k11)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("head_splits: no CUDA device; this benchmark runs on the card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    times, errs = {}, {}
    with tempfile.TemporaryDirectory(prefix="head_splits_") as work:
        libs = {k: ctypes.CDLL(str(p)) for k, p in compile_all(Path(work)).items()}
        cases = shapes(dev)
        # each variant's output after one call against the shipped build's
        for label, (kernel, call) in cases.items():
            ref = None
            for variant in VARIANTS:
                run, outs = call(libs[kernel, variant])
                if run():
                    raise RuntimeError(f"{variant} {label}: launch failed")
                torch.cuda.synchronize()
                if ref is None:
                    ref = outs
                errs.setdefault(variant, {})[label] = max(
                    float((a - b).abs().max() / max(1.0, float(b.abs().max())))
                    for a, b in zip(outs, ref))
                if errs[variant][label] > 1e-3:
                    raise RuntimeError(f"{variant} {label}: relative error "
                                       f"{errs[variant][label]} against the shipped build")
        for r in range(args.rounds):
            for variant in list(VARIANTS) + ["shipped"]:
                for label, (kernel, call) in cases.items():
                    run, _ = call(libs[kernel, variant])
                    us = graph_us(run)
                    times.setdefault(variant, {}).setdefault(label, []).append(us)
                    print(f"[head_splits] round {r} {variant}: {label} {us:.2f} us")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "us": times,
                      "rel_err_vs_shipped": errs}))
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
