"""The port's renders (``dposer_tpu_torch/body_model/visual.py`` on the
native rasterizer) against the JAX package's on the same meshes and poses
(CPU, small images): the native ``rasterize`` bit for bit, the plain numpy
rasterizer against JAX's numpy path, ``render_mesh`` in every view,
``save_obj``, ``multiple_render``'s PNGs, ``vis_skeletons`` and
``seq_to_video``; a failed build raises rather than falling back; and
``python -m dposer_tpu_torch.demo_fit`` on a ``benchmarks/gen_synth_ehf.py``
image to its files."""
import importlib.util
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dposer_tpu.native as jax_native
from dposer_tpu.body_model import visual as jvisual
from dposer_tpu.body_model.smplx_jax import BodyModel as JaxBodyModel
from dposer_tpu.data import PoseNormalizer as JaxNormalizer
from dposer_tpu_torch import demo_fit, native
from dposer_tpu_torch.body_model import BodyModel
from dposer_tpu_torch.body_model import visual
from dposer_tpu_torch.data import PoseNormalizer

from fixtures import make_stats_dir, make_synthetic_body_model

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "trained_r5")
H = W = 64
CAM = {"focal": (80.0, 80.0), "princpt": (32.0, 32.0)}
MASK_AGREE, PNG_AGREE = 0.97, 0.995  # tests/test_native.py:108; the PNGs' pixels


def sphere(n=12, r=0.8):
    """A closed UV sphere: [V, 3] float64 and [F, 3] int64."""
    th, ph = np.meshgrid(np.linspace(0.1, np.pi - 0.1, n), np.linspace(0, 2 * np.pi, n,
                                                                          endpoint=False))
    v = r * np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1)
    v = v.reshape(-1, 3) * np.array([1.0, 1.3, 0.7])
    f = []
    for i in range(n):
        for j in range(n - 1):
            a, b = i * n + j, ((i + 1) % n) * n + j
            f += [[a, b, a + 1], [b, b + 1, a + 1]]
    return v, np.array(f, np.int64)


def scene():
    v, f = sphere()
    return v + np.array([0.1, -0.05, 2.4]), f


def jax_numpy_raster(verts, faces, monkeypatch):
    """JAX's ``rasterize_mesh`` on its numpy path, forced as
    tests/test_native.py forces it (a native module that raises)."""
    class _Broken:
        @staticmethod
        def rasterize(*a, **k):
            raise RuntimeError("forced fallback")

    monkeypatch.setattr(jax_native, "raster", _Broken)
    return jvisual.rasterize_mesh(verts, faces, H, W, CAM["focal"], CAM["princpt"])


def test_native_rasterize_bit_equal_to_jax():
    v, f = scene()
    args = (H, W, 80.0, 80.0, 32.0, 32.0, np.array([0.3, 0.3, -1.0], np.float32),
            np.array([0.65, 0.74, 0.86], np.float32))
    rgb_j, mask_j = jax_native.raster.rasterize(v.astype(np.float32), f.astype(np.int32), *args)
    rgb, mask = native.rasterize(v, f, *args)
    assert mask.sum() > 200
    np.testing.assert_array_equal(rgb, rgb_j)
    np.testing.assert_array_equal(mask, mask_j)


def test_plain_rasterizer_matches_jax_numpy_path(monkeypatch):
    v, f = scene()
    rgb_j, mask_j = jax_numpy_raster(v, f, monkeypatch)
    rgb, mask = visual.rasterize_mesh_plain(v, f, H, W, CAM["focal"], CAM["princpt"])
    np.testing.assert_array_equal(mask, mask_j)
    np.testing.assert_allclose(rgb, rgb_j, rtol=0, atol=1e-9)
    # and the library against it: all but sub-pixel edge rounding
    _, mask_n = visual.rasterize_mesh(v, f, H, W, CAM["focal"], CAM["princpt"])
    assert (mask_n == mask).mean() >= MASK_AGREE


@pytest.mark.parametrize("view", sorted(visual.VIEW_ANGLES))
def test_render_mesh_bit_equal_to_jax(view):
    v, f = sphere()
    bg = np.random.default_rng(0).uniform(0, 255, (H, W, 3))
    ref = jvisual.render_mesh(bg, v, f, CAM, view=view)
    out = visual.render_mesh(bg, v, f, CAM, view=view)
    assert (out != bg).any()
    np.testing.assert_array_equal(out, ref)


def test_save_obj_byte_equal(tmp_path):
    v, f = sphere(5)
    jvisual.save_obj(v, f, str(tmp_path / "j.obj"))
    visual.save_obj(v, f, str(tmp_path / "t.obj"))
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()


def test_multiple_render_matches_jax(tmp_path):
    """The PNGs of 4 normalized poses through the normalizer and the
    synthetic SMPL-X body of each framework: at least 99.5% of the pixels
    equal (the body models agree to float32 rounding, which may move an
    edge pixel)."""
    body, _ = make_synthetic_body_model(tmp_path / "smplx.npz", "smplx", template_scale=0.15)
    stats = make_stats_dir(tmp_path / "stats", mean=np.full(63, 0.05), std=np.full(63, 0.2))
    poses = np.random.default_rng(1).normal(size=(4, 63)).astype(np.float32)
    kw = dict(bg_img=np.ones((H, W, 3)) * 255, focal=(160, 160), princpt=(32, 32))
    jvisual.multiple_render(jnp.asarray(poses),
                            JaxNormalizer(stats, normalize=True, min_max=False, rot_rep="axis"),
                            JaxBodyModel(str(body), num_betas=10, batch_size=4,
                                         model_type="smplx"),
                            str(tmp_path / "jax"), **kw)
    visual.multiple_render(torch.from_numpy(poses),
                           PoseNormalizer(stats, normalize=True, min_max=False, rot_rep="axis"),
                           BodyModel(str(body), num_betas=10, model_type="smplx"),
                           str(tmp_path / "torch"), **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) and len(names) == 4
    for n in names:
        a, b = (cv2.imread(str(tmp_path / d / n)) for d in ("jax", "torch"))
        assert (a != 255).any()
        assert (a == b).all(-1).mean() >= PNG_AGREE, n


def test_vis_skeletons_and_seq_to_video_write_what_jax_writes(tmp_path):
    joints = np.random.default_rng(2).normal(size=(2, 22, 3))
    rng = np.random.default_rng(3)
    frames = {p: [rng.integers(0, 255, (32, 24, 3)).astype(np.uint8) for _ in range(3)]
              for p in ("gt", "out")}
    for name, mod in (("jax", jvisual), ("torch", visual)):
        mod.vis_skeletons(joints, str(tmp_path / name / "sk"))
        rdir = tmp_path / name / "renders"
        rdir.mkdir()
        for p, fs in frames.items():
            for i, fr in enumerate(fs):
                cv2.imwrite(str(rdir / f"{p}_{i:04d}.png"), fr)
        mod.seq_to_video(str(rdir), str(tmp_path / name / "merge"),
                         str(tmp_path / name / "v.mp4"), fps=10)
    for sub in ("sk", "merge"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "torch" / sub)) and names
        for n in names:
            np.testing.assert_array_equal(cv2.imread(str(tmp_path / "torch" / sub / n)),
                                          cv2.imread(str(tmp_path / "jax" / sub / n)))
    counts = [int(cv2.VideoCapture(str(tmp_path / d / "v.mp4")).get(cv2.CAP_PROP_FRAME_COUNT))
              for d in ("jax", "torch")]
    assert counts == [3, 3]


@pytest.fixture
def fresh_loader(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)


def test_rasterizer_raises_without_a_compiler(monkeypatch, fresh_loader):
    """No quiet fallback to the numpy loop: no g++ raises."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    v, f = scene()
    with pytest.raises(FileNotFoundError, match="g\\+\\+"):
        visual.render_mesh(np.zeros((H, W, 3)), v, f, CAM)


def test_rasterizer_raises_on_a_broken_source(tmp_path, monkeypatch, fresh_loader):
    src = tmp_path / "src"
    shutil.copytree(native.SRC_DIR, src)
    with open(src / "raster.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "SRC_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    v, f = scene()
    with pytest.raises(native.NativeLibraryError, match="error"):
        visual.rasterize_mesh(v, f, H, W, CAM["focal"], CAM["princpt"])


@pytest.fixture(scope="module")
def ehf_image(tmp_path_factory):
    """One image of ``benchmarks/gen_synth_ehf.py`` on the 10,475-vertex
    human-scale synthetic SMPL-X body (tests/test_torch_fitting.py's)."""
    tmp = tmp_path_factory.mktemp("demo_fit")
    body, _ = make_synthetic_body_model(tmp / "hd.npz", "smplx", n_verts=10475,
                                        template_scale=0.15, seed=0)
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    spec = importlib.util.spec_from_file_location(
        "gen_synth_ehf", os.path.join(REPO, "benchmarks", "gen_synth_ehf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = sys.argv
    sys.argv = ["gen_synth_ehf.py", "--out", str(tmp / "ehf"), "--bodymodel-path", str(body),
                "--n-images", "1", "--pose-scale", "1.0"]
    try:
        mod.main()
    finally:
        sys.argv = argv
    return dict(tmp=tmp, body=str(body), img=str(tmp / "ehf" / "01_img.jpg"),
                json=str(tmp / "ehf" / "01_2Djnt.json"))


def test_demo_fit_cli(ehf_image, capsys):
    """``python -m dposer_tpu_torch.demo_fit``'s ``run`` on the CPU with the
    pinned prior: the hip-and-shoulder re-projection loss falls, and it
    writes ``fit_result.npz`` and the ``mesh_fit.jpg`` overlay."""
    out = ehf_image["tmp"] / "out"
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = demo_fit.run(demo_fit.parse_args([
            "--img", ehf_image["img"], "--openpose", ehf_image["json"], "--device", "cpu",
            "--bodymodel-path", ehf_image["body"],
            "--ckpt-path", os.path.join(ART, "axis-zscore-400k-synth.pth"),
            "--stats-dir", os.path.join(ART, "stats"), "--outdir", str(out)]))
    finally:
        torch.set_num_threads(n)
    printed = capsys.readouterr().out
    assert "initial re-projection loss" in printed and "after re-projection loss" in printed
    assert res["final_reproj"] < res["init_reproj"], res
    with np.load(out / "fit_result.npz") as f:
        assert f["pose"].shape == (1, 66) and f["betas"].shape == (1, 10)
        assert f["cam_t"].shape == (1, 3) and np.isfinite(f["pose"]).all()
    img, over = cv2.imread(ehf_image["img"]), cv2.imread(str(out / "mesh_fit.jpg"))
    assert over.shape == img.shape and (np.abs(over.astype(int) - img).max(-1) > 40).mean() > 1e-3
