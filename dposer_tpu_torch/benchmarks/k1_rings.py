"""K1's bf16 route against the ring shapes its design left out, on the card.

K1 ``dense_gn_silu`` reads the bf16 copy of its input that the layer before
wrote through ``ops/cuda/csrc/dense_wgmma_ss.cuh``'s ring (one consumer
warpgroup, 64 K-columns a stage): a grid that fits the SMs once takes the
deep ring (8 stages, one wgmma group left in flight), a larger one the
shallow ring (5 stages, each group waited on, two CTAs an SM at most). Each
variant here is the shipped ``dense_gn_silu.cu`` with its ring lines
substituted, compiled into a
temporary directory, and timed by CUDA-graph replay beside the shipped build,
in turns, at the network's shapes: a block's first layer (the copy alone)
and its second (the residual, the fp32 output and the copy) at generation's
500 rows, and the second at completion's 1,000. Every launch is
programmatic (``csrc/mbarrier.cuh``), so in the replayed graph each launch
starts its prologue under the tail of the one before, as in a
sampler's chain.

    python -m dposer_tpu_torch.benchmarks.k1_rings [--rounds 2]

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

H = 1024
DEEP = "using DeepRing = ss::Ring<1, 8, 1, 1>;"
SHALLOW = "using ShallowRing = ss::Ring<1, 5, 2, 0>;"
# name: [(old, new)] substitutions into dense_gn_silu.cu
VARIANTS = {
    "shipped": [],
    "the other wgmma pipeline depth": [(DEEP, "using DeepRing = ss::Ring<1, 8, 1, 0>;"),
                                       (SHALLOW, "using ShallowRing = ss::Ring<1, 5, 2, 1>;")],
    "12-stage deep ring": [(DEEP, "using DeepRing = ss::Ring<1, 12, 1, 1>;")],
    # 97 KB: two CTAs share an SM, so the next programmatic launch's CTAs find
    # room beside a draining one at 500 rows
    "6-stage ring, two CTAs an SM": [(DEEP, "using DeepRing = ss::Ring<1, 6, 2, 1>;")],
    # 65 KB: three CTAs an SM at 1,000 rows
    "4-stage shallow ring": [(SHALLOW, "using ShallowRing = ss::Ring<1, 4, 2, 0>;")],
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
        if "serialized" in log:
            print(f"[k1_rings] {variant}: ptxas serialized a wgmma")
        libs[variant] = ctypes.CDLL(str(lib))
    return libs


def shapes(dev) -> dict:
    """``{shape: call(lib)}``: the operands of a shape and a callable that
    launches ``lib``'s K1 on them from the bf16 copy on the current
    stream."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*s, sc=1.0, dt=torch.float32):
        return (sc * torch.randn(*s, generator=g, device=dev)).to(dt)

    out = {}
    for label, B, with_res, write_out in (("block first [500,1024]", 500, False, False),
                                          ("block+residual [500,1024]", 500, True, True),
                                          ("block+residual [1000,1024]", 1000, True, True)):
        ab, w = rn(B, H, dt=torch.bfloat16), rn(H, H, sc=H ** -0.5, dt=torch.bfloat16)
        tp, gm, bt = rn(H), 1 + rn(H, sc=0.1), rn(H, sc=0.1)
        res = rn(B, H) if with_res else None
        o = torch.empty(B, H, device=dev) if write_out else None
        ob = torch.empty(B, H, dtype=torch.bfloat16, device=dev)

        def call(lib, ab=ab, w=w, tp=tp, gm=gm, bt=bt, res=res, o=o, ob=ob, B=B):
            fn = lib.dposer_dense_gn_silu
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes, fn.restype = [P] * 9 + [I, I, I, P], I
            ptr = [None, ab.data_ptr(), w.data_ptr(), tp.data_ptr(), gm.data_ptr(),
                   bt.data_ptr(), None if res is None else res.data_ptr(),
                   None if o is None else o.data_ptr(), ob.data_ptr()]
            return lambda: fn(*ptr, B, H, H, torch.cuda.current_stream().cuda_stream)
        out[label] = call
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_rings: no CUDA device; this benchmark runs on the card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    times = {}
    with tempfile.TemporaryDirectory(prefix="k1_rings_") as work:
        libs = compile_all(Path(work))
        cases = shapes(dev)
        for r in range(args.rounds):
            for variant in list(VARIANTS) + list(VARIANTS)[::-1]:
                for label, call in cases.items():
                    run = call(libs[variant])
                    err = run()
                    torch.cuda.synchronize()
                    if err:
                        raise RuntimeError(f"{variant} {label}: CUDA error {err}")
                    us = graph_us(lambda: run())
                    times.setdefault(variant, {}).setdefault(label, []).append(us)
                    print(f"[k1_rings] round {r} {variant}: {label} {us:.2f} us")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "hidden": H,
                      "us": times}))
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
