"""The port's native (C++) helpers: the mesh self-intersection metric and the
software rasterizer. Port of ``dposer_tpu/native/__init__.py``.

``src/`` holds byte-for-byte copies of the JAX package's ``mesh_si.cpp`` and
``tri_tri.h`` (a uniform-grid broad phase and Möller's triangle-triangle
test, threaded over the meshes of a batch) and ``raster.cpp`` (a
flat-shaded z-buffer rasterizer, ``body_model/visual.py``'s renders). They
are built with the host's
``g++`` at first use into ``_build/`` beside this file, and bound with
``ctypes``. The library's name carries a digest of the sources, of
``g++ -dumpfullversion`` and ``-dumpmachine``, of the machine and of the
target options ``-march=native`` resolves to on this CPU (``g++
-march=native -Q --help=target``: the architecture and every instruction
set extension), so a changed source or toolchain builds anew, and a copy of
the tree taken to a CPU with other extensions builds its own library
instead of loading one that may use instructions it lacks. Each process compiles
into a temporary file of its own and renames it into place, so concurrent
first uses (test workers) cannot interleave their writes.

Without ``g++`` on the ``PATH`` the loader raises ``FileNotFoundError``; a
failed compile or load raises ``NativeLibraryError`` with the compiler's or
the loader's message.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("mesh_si.cpp", "tri_tri.h", "raster.cpp")
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


class NativeLibraryError(RuntimeError):
    """The native sources did not compile, or the library did not load."""


def compiler() -> str:
    """The path of ``g++``; ``FileNotFoundError`` if the ``PATH`` has none."""
    path = shutil.which(CXX)
    if path is None:
        raise FileNotFoundError(f"no host C++ compiler: {CXX!r} is not on the PATH, and the "
                                f"native helpers (self-intersection, rasterizer) build "
                                f"{SRC_DIR} with it")
    return path


def native_target(cxx: str) -> str:
    """What ``-march=native`` means on this CPU: ``g++``'s resolved target
    options (the ``-march`` it picks and each extension enabled or not)."""
    return subprocess.run([cxx, "-march=native", "-Q", "--help=target"], capture_output=True,
                          text=True).stdout


def _build_key(cxx: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    for flag in ("-dumpfullversion", "-dumpmachine"):
        h.update(subprocess.run([cxx, flag], capture_output=True, text=True).stdout.encode())
    h.update(platform.machine().encode())
    h.update(native_target(cxx).encode())
    h.update(" ".join(CXXFLAGS).encode())
    return h.hexdigest()[:16]


def build_lib() -> str:
    """Compile the sources unless a library of the same key exists; returns
    its path."""
    cxx = compiler()
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libdposer_native_{_build_key(cxx)}.so")
    if os.path.exists(lib_path):
        return lib_path
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [cxx, *CXXFLAGS, "-o", tmp_path,
           *[os.path.join(SRC_DIR, n) for n in SOURCES if n.endswith(".cpp")]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise NativeLibraryError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp_path, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The built library with its ``ctypes`` signatures (built at the first
    call of the process)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build_lib()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise NativeLibraryError(f"cannot load {path}: {e}") from e
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.self_intersections_percentage.argtypes = [
                f32p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int, f32p]
            lib.self_intersections_percentage.restype = None
            lib.self_intersections_percentage_mt.argtypes = [
                f32p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int, f32p, ctypes.c_int]
            lib.self_intersections_percentage_mt.restype = None
            lib.tri_tri_test.argtypes = [f32p, f32p]
            lib.tri_tri_test.restype = ctypes.c_int
            lib.rasterize.argtypes = [f32p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                      ctypes.c_float, ctypes.c_float, f32p, f32p, f32p, u8p]
            lib.rasterize.restype = None
            _LIB = lib
        return _LIB


def self_intersections_percentage(vertices: np.ndarray, faces: np.ndarray,
                                  n_threads: int = 0) -> np.ndarray:
    """The percentage of faces that intersect a face they share no vertex
    with, per mesh: ``vertices`` [B, V, 3] or [V, 3], ``faces`` [F, 3] ->
    float32 [B]. ``n_threads`` 0 takes every hardware thread (the meshes are
    independent); the library releases the interpreter lock while it runs."""
    lib = load()
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if vertices.ndim == 2:
        vertices = vertices[None]
    if vertices.ndim != 3 or vertices.shape[2] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"vertices [B, V, 3] and faces [F, 3] expected, got "
                         f"{vertices.shape} and {faces.shape}")
    n_batch, n_verts, _ = vertices.shape
    if faces.size and (faces.min() < 0 or faces.max() >= n_verts):
        raise ValueError(f"face indices outside [0, {n_verts})")
    out = np.zeros(n_batch, np.float32)
    lib.self_intersections_percentage_mt(vertices, n_batch, n_verts, faces, len(faces), out,
                                         int(n_threads))
    return out


def tri_tri_test(t1: np.ndarray, t2: np.ndarray) -> bool:
    """Whether two triangles, [3, 3] each, intersect."""
    lib = load()
    return bool(lib.tri_tri_test(np.ascontiguousarray(t1, np.float32).reshape(9),
                                 np.ascontiguousarray(t2, np.float32).reshape(9)))


def rasterize(verts: np.ndarray, faces: np.ndarray, height: int, width: int, fx: float,
              fy: float, cx: float, cy: float, light_dir, base_color) -> tuple:
    """Flat-shaded z-buffer rasterization of ``verts`` [V, 3] (camera space,
    z > 0 forward) and ``faces`` [F, 3] at ``height`` x ``width`` with the
    pinhole ``fx, fy, cx, cy`` -> (rgb [H, W, 3] float64 0-255, mask [H, W]
    bool). The library computes in float32 and releases the interpreter
    lock while it runs."""
    lib = load()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"verts [V, 3] and faces [F, 3] expected, got {verts.shape} and "
                         f"{faces.shape}")
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError(f"face indices outside [0, {len(verts)})")
    rgb = np.zeros((height, width, 3), np.float32)
    mask = np.zeros((height, width), np.uint8)
    lib.rasterize(verts, len(verts), faces, len(faces), int(height), int(width), float(fx),
                  float(fy), float(cx), float(cy), np.ascontiguousarray(light_dir, np.float32),
                  np.ascontiguousarray(base_color, np.float32), rgb, mask)
    return rgb.astype(np.float64), mask.astype(bool)
