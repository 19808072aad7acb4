"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (``pose_elementwise``, ``head_rk4`` and ``head_em`` hold two
kernels each), compiled for ``sm_90a`` at first use into ``_build/`` beside
this file (listed in ``.gitignore``). Libraries are named by a hash of the
sources and flags, so an edit rebuilds and a stale library is never loaded.
``build_all`` starts one nvcc per source at once.

    python -m dposer_tpu_torch.ops.cuda.build   # build now, print ptxas -v
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("dense_gn_silu", "head_em", "langevin_update", "pose_elementwise",
           "head_adam", "dense_gn_silu_jvp", "head_rk4", "dense_gn_silu_train", "head_dsm",
           "dense_gn_silu_bwd", "dense_gn_silu_int8", "chain_link")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> Dict[str, str]:
    """Compile every missing library, all nvcc processes at once.

    Returns ``{name: compiler log}`` (``-Xptxas -v``: registers, shared
    memory, spills); an empty log means the library was already built.
    Raises with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        target = library_path(name)
        if not target.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib


def tma_encodes(name: str) -> int:
    """Tensor maps that the library of kernel ``name`` (K1 or K14, whose
    sources include ``csrc/dense_wgmma.cuh``) has encoded since it was
    loaded: the misses of its map cache."""
    fn = load(name).dposer_tma_encodes
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return int(fn())


if __name__ == "__main__":
    for kernel, log in build_all().items():
        print(f"== {kernel}: {library_path(kernel).name}")
        print(log or "(already built)")
    sys.exit(0)
