"""The train step's layer kernels against the ring shapes their design left
out, on the card.

K10 ``dense_gn_silu_train`` (its Hopper route) and K12 ``dense_gn_silu_bwd``
run the main loop of ``ops/cuda/csrc/dense_wgmma_ss.cuh`` with one consumer
warpgroup, 4 stages and three CTAs an SM; K12 leaves one wgmma group in
flight, K10 waits on each. Each variant here is the shipped source with one
substitution (another ``Ring`` shape, the other pipeline depth, or K12's
last loop unrolled), compiled into a temporary directory, and timed by
CUDA-graph replay beside the shipped build, in turns, at the flagship step's
shapes: K10's block layer with its residual and without its fp32 output
([1280, 1024] x [1024, 1024]), K12's hidden hop with the carried gradient
and its first hop (K = 64).

    python -m dposer_tpu_torch.benchmarks.train_rings [--rounds 2]

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

B, H = 1280, 1024
KEEP = 0.9
RING = "ss::Ring<1, 4, 3"  # WG, STAGES, MIN_BLOCKS; K12 adds IN_FLIGHT = 1
BWD_SUM = """    float s = 0.0f;
    for (int b = 0;"""
BWD_SUM_UNROLLED = """    float s = 0.0f;
#pragma unroll 8
    for (int b = 0;"""
# name: [(file, old, new)]; "cu" is the kernel's own source, any other name
# a file of csrc/ (a kernel's source: the variant is that kernel's only)
VARIANTS = {
    "shipped": [],
    "128-row tiles (two consumer warpgroups, 2 CTAs an SM)": [("cu", RING, "ss::Ring<2, 4, 2")],
    "6 stages, 2 CTAs an SM": [("cu", RING, "ss::Ring<1, 6, 2")],
    "3 stages, 4 CTAs an SM": [("cu", RING, "ss::Ring<1, 3, 4")],
    "K10 with one wgmma group in flight": [("dense_gn_silu_train.cu", "ss::Ring<1, 4, 3>",
                                            "ss::Ring<1, 4, 3, 1>")],
    "K12 waiting on each wgmma group": [("dense_gn_silu_bwd.cu", "ss::Ring<1, 4, 3, 1>",
                                         "ss::Ring<1, 4, 3, 0>")],
    "K12's final sum unrolled by 8": [("dense_gn_silu_bwd.cu", BWD_SUM, BWD_SUM_UNROLLED)],
}
KERNELS = ("dense_gn_silu_train", "dense_gn_silu_bwd")


def applies(kernel: str, variant: str) -> bool:
    """Whether ``variant`` changes nothing but ``kernel``'s source and the
    shared headers."""
    return all(not t.endswith(".cu") or t == f"{kernel}.cu" for t, _, _ in VARIANTS[variant])


def variant_sources(kernel: str, variant: str) -> dict:
    """``{file name: text}`` of ``kernel``'s source under ``variant``: the
    kernel's ``.cu`` and, where the variant changes it, the loop's header.
    Raises if a substitution no longer applies to the shipped sources."""
    files = {f"{kernel}.cu": (build.CSRC / f"{kernel}.cu").read_text()}
    for target, old, new in VARIANTS[variant]:
        name = f"{kernel}.cu" if target == "cu" else target
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
        for i, variant in enumerate(v for v in VARIANTS if applies(kernel, v)):
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
        if "serialized" in log:
            print(f"[train_rings] {key}: ptxas serialized a wgmma")
        libs[key] = lib
    return libs


def graph_us(fn, reps: int = 20, replays: int = 10) -> float:
    """Device µs of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
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
    return 1e3 * a.elapsed_time(b) / (reps * replays)


def _arg_types(n_ptr: int):
    P, I = ctypes.c_void_p, ctypes.c_int
    return [P] * n_ptr + [ctypes.c_uint, I, I, ctypes.c_uint, ctypes.c_float, I, I, I, P]


def shapes(dev) -> dict:
    """``{shape: (kernel, call(lib))}``: the flagship step's operands and a
    callable that launches ``lib``'s entry on them (on the current stream)."""
    from ..ops.cuda.fused_train import keep_threshold
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*s, sc=1.0, dt=torch.float32):
        return (sc * torch.randn(*s, generator=g, device=dev)).to(dt)

    bf = torch.bfloat16
    thresh, inv = keep_threshold(KEEP), float(torch.tensor(1 / KEEP, dtype=torch.float32))
    out = {}
    for label, K, with_res in (("K10 block+residual", 1024, True),
                               ("K10 block, no fp32 out", 1024, False)):
        ab, w = rn(B, K, dt=bf), rn(K, H, sc=K ** -0.5, dt=bf)
        proj, gm, bt = rn(B, H, sc=0.3, dt=bf), 1 + rn(H, sc=0.1), rn(H, sc=0.1)
        res = rn(B, H) if with_res else None
        o = torch.empty(B, H, device=dev) if with_res else None
        st, xh, rs = rn(B, H, dt=bf), rn(B, H, dt=bf), rn(B, 32)

        def k10(lib, ab=ab, w=w, proj=proj, gm=gm, bt=bt, res=res, o=o, st=st, xh=xh, rs=rs, K=K):
            fn = lib.dposer_dense_gn_silu_train
            fn.argtypes, fn.restype = _arg_types(11), ctypes.c_int
            ptr = [None, ab.data_ptr(), w.data_ptr(), proj.data_ptr(), gm.data_ptr(),
                   bt.data_ptr(), None if res is None else res.data_ptr(),
                   None if o is None else o.data_ptr(), st.data_ptr(), xh.data_ptr(),
                   rs.data_ptr()]
            return lambda: fn(*ptr, 7, 1, 0, thresh, inv, B, K, H,
                              torch.cuda.current_stream().cuda_stream)
        out[label] = ("dense_gn_silu_train", k10)
    for label, K, with_res in (("K12 hidden+g_res", 1024, True), ("K12 hop 1", 64, False)):
        a, w = rn(B, K, sc=1e-3, dt=bf), rn(K, H, sc=K ** -0.5, dt=bf)
        xh, rs = rn(B, H, dt=bf), torch.rand(B, 32, device=dev) + 0.5
        gm, bt = 1 + rn(H, sc=0.1), rn(H, sc=0.1)
        gr = rn(B, H, sc=1e-3) if with_res else None
        go = torch.empty(B, H, device=dev) if with_res else None
        dh = torch.empty(B, H, dtype=bf, device=dev)

        def k12(lib, a=a, w=w, xh=xh, rs=rs, gm=gm, bt=bt, gr=gr, go=go, dh=dh, K=K):
            fn, rows = lib.dposer_dense_gn_silu_bwd, lib.dposer_dense_gn_silu_bwd_tile_rows
            fn.argtypes, fn.restype, rows.restype = _arg_types(11), ctypes.c_int, ctypes.c_int
            parts = torch.empty(2, -(-B // rows()), H, device=dev)
            ptr = [a.data_ptr(), w.data_ptr(), None if gr is None else gr.data_ptr(),
                   None if go is None else go.data_ptr(), xh.data_ptr(), rs.data_ptr(),
                   gm.data_ptr(), bt.data_ptr(), dh.data_ptr(), parts[0].data_ptr(),
                   parts[1].data_ptr()]
            return lambda: fn(*ptr, 5, 2, 0, thresh, inv, B, K, H,
                              torch.cuda.current_stream().cuda_stream)
        out[label] = ("dense_gn_silu_bwd", k12)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_rings: no CUDA device; this benchmark runs on the card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    times = {}
    with tempfile.TemporaryDirectory(prefix="train_rings_") as work:
        libs = {k: ctypes.CDLL(str(p)) for k, p in compile_all(Path(work)).items()}
        cases = shapes(dev)
        for r in range(args.rounds):
            for variant in list(VARIANTS) + ["shipped"]:
                for label, (kernel, call) in cases.items():
                    if not applies(kernel, variant):
                        continue
                    run = call(libs[kernel, variant])
                    err = run()
                    torch.cuda.synchronize()
                    if err:
                        raise RuntimeError(f"{variant} {label}: CUDA error {err}")
                    us = graph_us(lambda: run())
                    times.setdefault(variant, {}).setdefault(label, []).append(us)
                    print(f"[train_rings] round {r} {variant}: {label} {us:.2f} us")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "batch": B,
                      "hidden": H, "us": times}))
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
