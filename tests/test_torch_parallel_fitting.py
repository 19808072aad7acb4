"""The port's fitting tasks sharded over a device mesh (CPU): ``MotionDenoise
(mesh=)`` and ``SMPLify(mesh=)`` on ``Mesh(["cpu"] * n)``, a ragged chunk
included, against the unsharded run on the same generators, and both CLIs
on a mesh of two CPU devices against one device, printing the mesh line.

The sharded runs compute each fragment's or image's rows in a smaller
batch than the unsharded run, so the body model's and the network's
products round otherwise: motion denoising's poses are held to 1e-5 rad
(the batching bound of ``tests/test_torch_motion.py``), SMPLify's fit to
2e-5 x max(1, |ref|) (the bound of ``tests/test_torch_fitting.py``), and
the metrics to 1e-3 relative and 1e-4 absolute, the bounds of
``tests/test_cli_parallel.py``."""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from dposer_tpu_torch import fitting as fit_cli
from dposer_tpu_torch import motion_denoising as motion_cli
from dposer_tpu_torch.body_model import BodyModel
from dposer_tpu_torch.body_model.fitting_losses import perspective_projection
from dposer_tpu_torch.body_model.smplx_fit import SMPLXFit
from dposer_tpu_torch.data import PoseNormalizer
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.score_fn import get_score_fn
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.parallel import Mesh
from dposer_tpu_torch.tasks import DPoser, MotionDenoise, SMPLify

from fixtures import make_stats_dir, make_synthetic_body_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "trained_r5")
T, POSE_ATOL, RTOL, ATOL = 12, 1e-5, 1e-3, 1e-4
SCHED = dict(iterations=2, steps_per_iter=5, sample_trun=4.0, sample_time=490)
NI, FOCAL = 3, 1000.0


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """A 2-block net at hidden 64 with seeded weights, a normalizer and the
    120-vertex synthetic SMPL-X body."""
    tmp = tmp_path_factory.mktemp("parallel_fit")
    path, vids = make_synthetic_body_model(tmp / "m.npz", "smplx", template_scale=0.15)
    rng = np.random.default_rng(0)
    stats = make_stats_dir(tmp / "stats", mean=0.1 * rng.normal(size=63),
                           std=rng.uniform(0.3, 0.6, 63))
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=64, embed_dim=32, n_blocks=2,
                         dropout=0.0, scale_by_sigma=True, num_scales=1000).eval()
    sde = tsde.SubVPSDE(N=500)
    return dict(path=path, vids=vids, sde=sde, score=get_score_fn(sde, model, continuous=True),
                nz=PoseNormalizer(stats, normalize=True, min_max=False, rot_rep="axis"),
                body=BodyModel(path, model_type="smplx", vertex_ids=vids))


def _gens(seed, n):
    return [torch.Generator().manual_seed(seed + i) for i in range(n)]


@pytest.mark.parametrize("shards,frags", [(2, 4), (2, 5), (3, 4)])
@pytest.mark.parametrize("strategy", ["3", "1"])
def test_motion_denoise_mesh_equals_unsharded(parts, shards, frags, strategy):
    """Fragments split over ``shards`` CPU devices (5 over 2 and 4 over 3 are
    ragged: the last fragment pads the last shard) against one batch on the
    same generators: each fragment's poses within 1e-5 rad and its metrics
    within 1e-3 relative, 1e-4 absolute; time strategy '1' draws each
    fragment's times from its own generator."""
    p = parts
    rng = np.random.default_rng(frags)
    with torch.no_grad():
        gt = torch.from_numpy((0.3 * rng.normal(size=(frags, T, 63))).astype(np.float32))
        noisy = p["body"](pose_body=gt.reshape(-1, 63)).Jtr[:, :22].reshape(frags, T, 22, 3)
    noisy = noisy + 0.04 * torch.from_numpy(rng.normal(size=noisy.shape).astype(np.float32))
    sched = dict(SCHED, time_strategy=strategy)
    one = MotionDenoise(p["sde"], p["score"], p["body"], p["nz"], batch_size=T)
    ref = one.optimize_batch(noisy, generators=_gens(7, frags), **sched)
    md = MotionDenoise(p["sde"], p["score"], p["body"], p["nz"], batch_size=T,
                       mesh=Mesh(["cpu"] * shards))
    got = md.optimize_batch(noisy, generators=_gens(7, frags), **sched)
    assert got.shape == ref.shape == (frags, T, 63)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=POSE_ATOL)
    for f in range(frags):
        m_got, m_ref = (md.metrics(x[f], noisy[f], gt[f]) for x in (got, ref))
        for k in m_ref:
            np.testing.assert_allclose(m_got[k], m_ref[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert not torch.allclose(got[0], got[1])


def test_motion_denoise_mesh_off_the_body_device_needs_a_replica(parts):
    p = parts
    md = MotionDenoise(p["sde"], p["score"], p["body"], p["nz"], batch_size=T,
                       mesh=Mesh(["cpu", "meta"]))
    with pytest.raises(ValueError, match="replica="):
        md.task_on("meta")


@pytest.fixture(scope="module")
def fit_parts(parts):
    """Keypoints of three known poses at a known camera, seen from the mean
    pose and another camera."""
    p = parts
    fit = SMPLXFit(p["path"], vertex_ids=p["vids"])
    rng = np.random.default_rng(5)
    n = 3
    gt = torch.from_numpy((0.2 * rng.normal(size=(n, 66))).astype(np.float32))
    cc = torch.full((n, 2), 200.0)
    with torch.no_grad():
        out = fit(betas=torch.zeros(n, 10), body_pose=gt[:, 3:], global_orient=gt[:, :3],
                  transl=torch.tensor([[0.0, 0.0, 5.0]]).expand(n, 3))
        kp = perspective_projection(out.joints, torch.eye(3)[None].expand(n, 3, 3), None,
                                    FOCAL, cc)
    kp = torch.cat([kp, torch.ones(n, 49, 1)], -1)
    init_cam = torch.tensor([[0.2, -0.1, 6.0], [0.1, 0.1, 5.5], [-0.1, 0.0, 5.8]])
    return dict(fit=fit, kp=kp, cc=cc, init_cam=init_cam,
                init_pose=fit.mean_poses[:66].expand(n, 66).clone())


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("strategy", ["3", "1"])
def test_smplify_mesh_equals_unsharded(parts, fit_parts, shards, strategy):
    """Three images over 2 (ragged) and 3 CPU devices with the prior on,
    against the unsharded fit from the same generator state: every step's
    time (strategy '1') and the prior's normals are drawn at the whole
    batch's shape and split, and each shard's loss carries its share of
    the batch, so each image's fit is the unsharded one's to rounding: the
    pose, betas and camera within 2e-5 x max(1, |ref|), the bound
    ``tests/test_torch_fitting.py`` holds the fit to JAX's with (measured
    here up to 2.4e-5 on a pose entry of 3.3), the reprojection within 1e-3
    relative, 1e-4 absolute."""
    p, f = parts, fit_parts
    B = f["kp"].shape[0]
    prior = DPoser(p["sde"], p["score"], p["nz"], batch_size=B)
    kw = dict(pose_prior=prior, num_iters=NI, focal_length=FOCAL, batch_size=B,
              time_strategy=strategy)
    args = (f["init_pose"], torch.zeros(B, 10), f["init_cam"], f["cc"], f["kp"])
    ref = SMPLify(f["fit"], **kw)(*args, generator=torch.Generator().manual_seed(3))
    got = SMPLify(f["fit"], mesh=Mesh(["cpu"] * shards), **kw)(
        *args, generator=torch.Generator().manual_seed(3))
    for name, o, r in zip(("pose", "betas", "camera"), got[:3], ref[:3]):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=0,
                                   atol=2e-5 * max(1.0, float(r.abs().max())), err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), ref[3].numpy(), rtol=RTOL, atol=ATOL)
    assert (got[0] - f["init_pose"]).abs().max() > 1e-3  # the fit moved the pose


@pytest.fixture(scope="module")
def motion_frags(tmp_path_factory):
    """Three 30-frame fragments of ``benchmarks/gen_synth_motion.py`` and the
    human-scale 120-vertex body."""
    tmp = tmp_path_factory.mktemp("parallel_motion_cli")
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    spec = importlib.util.spec_from_file_location(
        "gen_synth_motion", os.path.join(REPO, "benchmarks", "gen_synth_motion.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    centers, w, basis = mod.make_mixture(np.random.default_rng(0))
    rng = np.random.default_rng(99)
    frags = tmp / "frags"
    frags.mkdir()
    for i in range(3):
        np.savez(frags / f"seq{i}.npz",
                 pose_body=mod.sample_sequence(rng, 30, centers, w, basis, 30.0))
    body, _ = make_synthetic_body_model(tmp / "human.npz", "smplx", n_verts=120,
                                        template_scale=0.15, seed=0)
    return dict(tmp=tmp, frags=str(frags), body=body)


def test_motion_cli_mesh_equals_one_device(motion_frags, capsys):
    """``python -m dposer_tpu_torch.motion_denoising`` in directory mode,
    three fragments as one batch over a mesh of two CPU devices (ragged):
    it prints the mesh line, and every average is the one-device run's
    within 1e-3 relative."""
    d = motion_frags

    def args(out):
        return motion_cli.parse_args([
            "--device", "cpu", "--ckpt-path", os.path.join(ART, "axis-zscore-400k-synth.pth"),
            "--stats-dir", os.path.join(ART, "stats"), "--bodymodel-path", d["body"],
            "--data-dir", d["frags"], "--outpath-folder", str(d["tmp"] / out),
            "--batch-fragments", "3", "--iterations", "1", "--steps-per-iter", "10"])

    two = motion_cli.run(args("two"), mesh=Mesh(["cpu"] * 2))
    assert "batched fragments data-parallel over 2 devices" in capsys.readouterr().out
    one = motion_cli.run(args("one"))
    assert "data-parallel" not in capsys.readouterr().out
    assert one["init_MPJPE"] == two["init_MPJPE"]
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=RTOL, err_msg=k)


@pytest.fixture(scope="module")
def ehf_small(tmp_path_factory):
    """Three images of ``benchmarks/gen_synth_ehf.py`` on a 2,000-vertex
    synthetic SMPL-X body."""
    tmp = tmp_path_factory.mktemp("parallel_ehf")
    body, _ = make_synthetic_body_model(tmp / "b.npz", "smplx", n_verts=2000,
                                        template_scale=0.15, seed=0)
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    spec = importlib.util.spec_from_file_location(
        "gen_synth_ehf", os.path.join(REPO, "benchmarks", "gen_synth_ehf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = sys.argv
    sys.argv = ["gen_synth_ehf.py", "--out", str(tmp / "ehf"), "--bodymodel-path", body,
                "--n-images", "3", "--pose-scale", "1.0"]
    try:
        mod.main()
    finally:
        sys.argv = argv
    return dict(tmp=tmp, body=body, data=str(tmp / "ehf"))


def test_fitting_cli_mesh_equals_one_device(ehf_small, capsys):
    """``python -m dposer_tpu_torch.fitting``, three images as one batch over
    a mesh of two CPU devices (ragged), 3 iterations a stage: it prints the
    mesh line, and each image's PA-MPJPE and MPJPE are the one-device run's
    within 1e-3 relative, 1e-4 absolute (mm)."""
    d = ehf_small

    def args(out):
        return fit_cli.parse_args([
            "--data-dir", d["data"], "--device", "cpu", "--bodymodel-path", d["body"],
            "--ckpt-path", os.path.join(ART, "axis-zscore-400k-synth.pth"),
            "--stats-dir", os.path.join(ART, "stats"), "--batch-images", "3",
            "--num-iters", "3", "--time-strategy", "1", "--outdir", str(d["tmp"] / out)])

    two = fit_cli.run(args("two"), mesh=Mesh(["cpu"] * 2))
    assert "batched images data-parallel over 2 devices" in capsys.readouterr().out
    one = fit_cli.run(args("one"))
    assert "data-parallel" not in capsys.readouterr().out
    for k in ("pa_mpjpe_body", "mpjpe_body"):
        assert len(one[k]) == len(two[k]) == 3
        np.testing.assert_allclose(two[k], one[k], rtol=RTOL, atol=ATOL, err_msg=k)
