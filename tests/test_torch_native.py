"""The port's native loader (``dposer_tpu_torch/native``) and its
self-intersection metric against the JAX package's (CPU): the C++ copies
byte for byte, ``tri_tri_test`` and SI on the cases of
``tests/test_native.py``, SI equal to JAX's on a synthetic SMPL body's
meshes, and the failures (no ``g++``: NaN and one warning; a broken source:
the compiler's error)."""
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from dposer_tpu.ops.metrics import self_intersections_percentage as jax_si
from dposer_tpu_torch import native
from dposer_tpu_torch.body_model import BodyModel
from dposer_tpu_torch.ops import metrics
from dposer_tpu_torch.ops.metrics import self_intersections_percentage

from fixtures import make_synthetic_body_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SRC = os.path.join(REPO, "dposer_tpu", "native", "src")


@pytest.mark.parametrize("name", native.SOURCES)
def test_sources_are_jax_copies(name):
    with open(os.path.join(native.SRC_DIR, name), "rb") as a, \
            open(os.path.join(JAX_SRC, name), "rb") as b:
        assert a.read() == b.read()


def test_tri_tri():
    a = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    b = np.array([[0.2, 0.2, -0.5], [0.4, 0.2, 0.5], [0.2, 0.4, 0.5]], np.float32)
    assert native.tri_tri_test(a, b)  # crossing
    assert not native.tri_tri_test(a, b + np.float32([10, 0, 0]))  # far away
    assert not native.tri_tri_test(a, a + np.float32([0, 0, 1]))  # parallel plane
    assert native.tri_tri_test(a, a + np.float32([0.1, 0.1, 0]))  # coplanar, overlapping
    assert not native.tri_tri_test(a, a + np.float32([5, 0, 0]))  # coplanar, disjoint


CASES = {
    # two disjoint triangles
    "clean": ([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 5], [1, 0, 5], [0, 1, 5]],
              [[0, 1, 2], [3, 4, 5]], 0.0),
    # a crossing pair among 4 faces
    "crossing_pair": ([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.2, 0.2, -0.5], [0.4, 0.2, 0.5],
                       [0.2, 0.4, 0.5], [5, 0, 0], [6, 0, 0], [5, 1, 0], [9, 0, 0],
                       [10, 0, 0], [9, 1, 0]],
                      [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]], 50.0),
    # faces sharing an edge do not count
    "adjacent": ([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], [[0, 1, 2], [1, 3, 2]], 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_si_cases(case):
    verts, faces, expected = CASES[case]
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    np.testing.assert_array_equal(native.self_intersections_percentage(verts[None], faces),
                                  [expected])
    # the metric takes tensors and a single [V, 3] mesh too
    out = self_intersections_percentage(torch.from_numpy(verts), torch.from_numpy(faces))
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, [expected])


def test_si_batch_and_threads():
    rng = np.random.default_rng(5)
    verts = rng.normal(size=(6, 60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, size=(100, 3)).astype(np.int32)
    one = native.self_intersections_percentage(verts, faces, n_threads=1)
    assert one.shape == (6,) and ((one > 0) & (one <= 100)).all()  # a random soup
    np.testing.assert_array_equal(native.self_intersections_percentage(verts, faces,
                                                                       n_threads=4), one)
    np.testing.assert_array_equal(self_intersections_percentage(verts, faces), one)
    with pytest.raises(ValueError, match="face indices"):
        native.self_intersections_percentage(verts, faces + 60)


def test_si_equals_jax_on_a_body(tmp_path):
    """The same vertices of 4 synthetic SMPL meshes give JAX's SI exactly:
    the same C++, the same flags."""
    path, _ = make_synthetic_body_model(tmp_path / "smpl.npz", "smpl")
    body = BodyModel(path, model_type="smpl")
    pose = torch.from_numpy(
        (0.4 * np.random.default_rng(1).normal(size=(4, 69))).astype(np.float32))
    with torch.no_grad():
        out = body(pose_body=pose)
    verts, faces = out.v.numpy(), body.f.numpy()
    ref = jax_si(verts, faces)
    assert ref.shape == (4,) and np.isfinite(ref).all()
    np.testing.assert_array_equal(self_intersections_percentage(out.v, body.f), ref)


@pytest.fixture
def fresh_loader(monkeypatch):
    """The loader as at a process's first use, restored afterwards."""
    monkeypatch.setattr(native, "_LIB", None)
    metrics._warn_no_compiler.cache_clear()
    yield
    metrics._warn_no_compiler.cache_clear()


def test_no_compiler_gives_nan_and_warns_once(monkeypatch, fresh_loader):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(FileNotFoundError, match="g\\+\\+"):
        native.build_lib()
    verts = np.zeros((3, 4, 3), np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    with pytest.warns(RuntimeWarning, match="unavailable"):
        out = self_intersections_percentage(verts, faces)
    assert out.shape == (3,) and np.isnan(out).all()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert np.isnan(self_intersections_percentage(verts[0], faces)).all()


def test_build_key_follows_the_cpu_target(monkeypatch):
    """A library built with -march=native on one CPU is not loaded on a CPU
    whose g++ resolves -march=native to other extensions."""
    cxx = native.compiler()
    target = native.native_target(cxx)
    assert "-march=" in target and "-mavx" in target
    key = native._build_key(cxx)
    assert native._build_key(cxx) == key
    other = target.replace("-mavx", "-mavx-off-on-this-cpu", 1)
    monkeypatch.setattr(native, "native_target", lambda c: other)
    assert native._build_key(cxx) != key


def test_broken_source_raises(tmp_path, monkeypatch, fresh_loader):
    src = tmp_path / "src"
    shutil.copytree(native.SRC_DIR, src)
    with open(src / "mesh_si.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "SRC_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(native.NativeLibraryError, match="error"):
        self_intersections_percentage(np.zeros((1, 3, 3), np.float32),
                                      np.array([[0, 1, 2]], np.int32))
    assert not [n for n in os.listdir(tmp_path / "_build") if n.endswith(".tmp")]
