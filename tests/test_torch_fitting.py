"""The port's mesh-fitting slice against the JAX package on the same inputs
(CPU): the HMR tables, the fitting losses and their gradients, the 49-joint
``SMPLXFit``, ``SMPLify`` against JAX's (the 120-vertex synthetic SMPL-X body,
a 2-block net at hidden 64, 2 images, 4 iterations a stage) with the prior
disabled and with it on injected normals, the PA- and pelvis-aligned MPJPE
and ``eval_EHF`` on the same meshes, the preprocessing, and ``python -m
dposer_tpu_torch.fitting --device cpu`` on an EHF directory written by
``benchmarks/gen_synth_ehf.py`` with the pinned checkpoint."""
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.body_model import constants as jconst
from dposer_tpu.body_model import fitting_losses as jfl
from dposer_tpu.body_model import vertex_ids as jvid
from dposer_tpu.body_model.part_indices import smpl_to_openpose as jax_smpl_to_openpose
from dposer_tpu.body_model.smplx_fit import SMPLXFit as JaxSMPLXFit
from dposer_tpu.data import PoseNormalizer as JaxNormalizer
from dposer_tpu.data import preprocess as jpre
from dposer_tpu.data.mocap import MocapDataset as JaxMocapDataset
from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.diffusion.score_fn import get_score_fn as jax_get_score_fn
from dposer_tpu.ops import metrics as jmet
from dposer_tpu.tasks.smplify import DPoser as JaxDPoser
from dposer_tpu.tasks.smplify import SMPLify as JaxSMPLify
from dposer_tpu_torch import fitting as cli
from dposer_tpu_torch.body_model import constants
from dposer_tpu_torch.body_model import fitting_losses as tfl
from dposer_tpu_torch.body_model import vertex_ids
from dposer_tpu_torch.body_model.part_indices import smpl_to_openpose
from dposer_tpu_torch.body_model.smplx_fit import SMPLXFit
from dposer_tpu_torch.data import MocapDataset, PoseNormalizer
from dposer_tpu_torch.data import preprocess as tpre
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.score_fn import get_score_fn
from dposer_tpu_torch.ops import metrics as tmet
from dposer_tpu_torch.smplify import build_dposer_prior
from dposer_tpu_torch.tasks import DPoser, SMPLify

from fixtures import make_stats_dir, make_synthetic_body_model
from test_torch_model import SMALL, flax_and_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "trained_r5")
B, FOCAL, NI = 2, 1000.0, 4


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Small tensors and thousands of small calls: one thread is the fastest
    way through them, above all beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_tables_match_jax():
    for name in ("JOINT_NAMES", "JOINT_IDS", "JOINT_MAP", "SMPLX_OPENPOSE_MAP", "H36M_TO_J17",
                 "H36M_TO_J14", "J24_TO_J17", "J24_TO_J14", "SMPL_JOINTS_FLIP_PERM",
                 "SMPL_POSE_FLIP_PERM", "J24_FLIP_PERM", "J49_FLIP_PERM", "CROP_IMG_HEIGHT",
                 "CROP_IMG_WIDTH", "CROP_ASPECT_RATIO", "IMG_NORM_MEAN", "IMG_NORM_STD",
                 "FOCAL_LENGTH", "IMG_RES"):
        assert getattr(constants, name) == getattr(jconst, name), name
    for name in ("SMPL_MEAN_PATH", "BEND_POSE_PATH"):
        assert os.path.samefile(getattr(constants, name), getattr(jconst, name)), name
    assert vertex_ids.EXTRA_JOINT_NAMES == jvid.EXTRA_JOINT_NAMES
    assert vertex_ids.VERTEX_IDS == jvid.VERTEX_IDS


@pytest.mark.parametrize("fmt", ["coco25", "coco19"])
@pytest.mark.parametrize("model_type", ["smpl", "smplh", "smplx"])
def test_smpl_to_openpose_matches_jax(fmt, model_type):
    for hands in (False, True):
        for face in (False, True):
            for contour in (False, True):
                out = smpl_to_openpose(model_type, hands, face, contour, fmt)
                ref = jax_smpl_to_openpose(model_type, hands, face, contour, fmt)
                assert out.dtype == ref.dtype
                np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError):
        smpl_to_openpose(model_type, openpose_format="coco18")


def test_perspective_projection_matches_jax_and_ignores_translation():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(size=(3, 7, 2)), rng.uniform(3, 6, (3, 7, 1))],
                         -1).astype(np.float32)
    rot = np.stack([np.eye(3)] * 3).astype(np.float32)
    cc = rng.uniform(100, 300, (3, 2)).astype(np.float32)
    for focal in (500.0, np.array([400.0, 500.0, 600.0], np.float32)):
        ref = jfl.perspective_projection(jnp.asarray(pts), jnp.asarray(rot), jnp.zeros((3, 3)),
                                         jnp.asarray(focal), jnp.asarray(cc))
        out = tfl.perspective_projection(_t(pts), _t(rot), torch.zeros(3, 3),
                                         torch.as_tensor(focal), _t(cc))
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-6, atol=1e-4)
    # the known point and the translation the reference never applies
    p = torch.tensor([[[1.0, -2.0, 5.0]]])
    one = tfl.perspective_projection(p, torch.eye(3)[None], torch.tensor([[5.0, -3.0, 2.0]]),
                                     500.0, torch.tensor([[100.0, 50.0]]))
    np.testing.assert_allclose(_np(one)[0, 0], [200.0, -150.0], atol=1e-4)


def test_gmof_and_angle_prior_match_jax():
    x = np.linspace(-1e4, 1e4, 101).astype(np.float32)
    np.testing.assert_allclose(_np(tfl.gmof(_t(x), 100.0)), np.asarray(jfl.gmof(x, 100.0)),
                               rtol=1e-6)
    pose = (0.5 * np.random.default_rng(1).normal(size=(3, 63))).astype(np.float32)
    out = tfl.angle_prior(_t(pose))
    assert out.shape == (3, 4)
    np.testing.assert_allclose(_np(out), np.asarray(jfl.angle_prior(jnp.asarray(pose))),
                               rtol=1e-6)


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    joints = np.concatenate([rng.normal(size=(B, 49, 2)), rng.uniform(4, 6, (B, 49, 1))],
                            -1).astype(np.float32)
    return dict(body_pose=(0.3 * rng.normal(size=(B, 63))).astype(np.float32),
                betas=rng.normal(size=(B, 10)).astype(np.float32), model_joints=joints,
                camera_t=rng.normal(size=(B, 3)).astype(np.float32),
                camera_center=rng.uniform(150, 250, (B, 2)).astype(np.float32),
                joints_2d=rng.uniform(0, 400, (B, 49, 2)).astype(np.float32),
                joints_conf=rng.uniform(0, 1, (B, 49)).astype(np.float32))


GRAD_ARGS = ("body_pose", "betas", "model_joints", "camera_t")


@pytest.mark.parametrize("output", ["mean", "sum", "reprojection"])
@pytest.mark.parametrize("prior", [None, 0.7])
def test_body_fitting_loss_matches_jax(output, prior):
    """The value and its gradients in the pose, betas, joints and camera."""
    inp = _loss_inputs(2)
    kw = dict(focal_length=FOCAL, pose_prior_weight=20.0, shape_prior_weight=10.0,
              angle_prior_weight=50.0, output=output)

    def jloss(*args):
        d = dict(inp, **dict(zip(GRAD_ARGS, args)))
        return jnp.sum(jfl.body_fitting_loss(*[d[k] for k in inp], prior, **kw))

    ref = jloss(*[jnp.asarray(inp[k]) for k in GRAD_ARGS])
    grads = jax.grad(jloss, argnums=tuple(range(4)))(*[jnp.asarray(inp[k]) for k in GRAD_ARGS])
    targs = {k: _t(v).requires_grad_(k in GRAD_ARGS) for k, v in inp.items()}
    out = tfl.body_fitting_loss(*targs.values(), prior, **kw)
    if output == "reprojection":
        assert out.shape == (B, 49)
    # the camera translation is not applied (and the reprojection reads
    # neither pose nor betas): no gradient there, zeros in JAX
    tg = torch.autograd.grad(out.sum(), [targs[k] for k in GRAD_ARGS], allow_unused=True)
    np.testing.assert_allclose(float(out.detach().sum()), float(ref), rtol=1e-5)
    for k, g, r in zip(GRAD_ARGS, tg, grads):
        r = np.asarray(r)
        if g is None:
            assert not r.any(), k
            continue
        np.testing.assert_allclose(_np(g), r, rtol=1e-4, atol=1e-5 * np.abs(r).max(), err_msg=k)


@pytest.mark.parametrize("valid", [True, False], ids=["openpose", "gt_fallback"])
def test_camera_fitting_loss_matches_jax(valid):
    inp = _loss_inputs(3)
    if not valid:  # a sample without confident OpenPose hips and shoulders
        inp["joints_conf"][0, [9, 12, 2, 5]] = 0.0
    args = ("model_joints", "camera_t", "camera_t_est", "camera_center", "joints_2d",
            "joints_conf")
    inp["camera_t_est"] = inp["camera_t"] + 0.1

    def jloss(mj, ct):
        d = dict(inp, model_joints=mj, camera_t=ct)
        return jfl.camera_fitting_loss(*[d[k] for k in args], focal_length=FOCAL)

    ref = jloss(jnp.asarray(inp["model_joints"]), jnp.asarray(inp["camera_t"]))
    gref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(inp["model_joints"]),
                                           jnp.asarray(inp["camera_t"]))
    t = {k: _t(inp[k]).requires_grad_(k in ("model_joints", "camera_t")) for k in args}
    out = tfl.camera_fitting_loss(*t.values(), focal_length=FOCAL)
    g = torch.autograd.grad(out, [t["model_joints"], t["camera_t"]])
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-5)
    for a, r in zip(g, gref):
        r = np.asarray(r)
        np.testing.assert_allclose(_np(a), r, rtol=1e-4, atol=1e-5 * np.abs(r).max())


@pytest.fixture(scope="module")
def fit_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_fit")
    path, vids = make_synthetic_body_model(tmp / "f.npz", "smplx", template_scale=0.15)
    rng = np.random.default_rng(0)
    stats = make_stats_dir(tmp / "stats", mean=0.1 * rng.normal(size=63),
                           std=rng.uniform(0.3, 0.6, 63))
    fm, params, tm = flax_and_torch(**dict(SMALL, hidden_dim=64, embed_dim=32,
                                           scale_by_sigma=True, num_scales=1000))
    js, ts = jsde.SubVPSDE(N=500), tsde.SubVPSDE(N=500)
    jfit = JaxSMPLXFit(path, vertex_ids=vids)
    # keypoints of a known pose and camera, seen from a start elsewhere
    gt_pose = (0.2 * rng.normal(size=(B, 66))).astype(np.float32)
    out = jfit(betas=jnp.zeros((B, 10)), body_pose=jnp.asarray(gt_pose[:, 3:]),
               global_orient=jnp.asarray(gt_pose[:, :3]),
               transl=jnp.tile(jnp.asarray([[0.0, 0.0, 5.0]]), (B, 1)))
    cc = np.full((B, 2), 200.0, np.float32)
    kp = np.asarray(jfl.perspective_projection(out.joints, jnp.tile(jnp.eye(3)[None], (B, 1, 1)),
                                               None, FOCAL, jnp.asarray(cc)))
    kp = np.concatenate([kp, np.ones((B, 49, 1))], -1).astype(np.float32)
    return dict(
        jfit=jfit, tfit=SMPLXFit(path, vertex_ids=vids), path=path, vids=vids, js=js, ts=ts,
        jnz=JaxNormalizer(stats, normalize=True, min_max=False, rot_rep="axis"),
        tnz=PoseNormalizer(stats, normalize=True, min_max=False, rot_rep="axis"),
        jscore=jax_get_score_fn(js, lambda x, t: fm.apply({"params": params}, x, t),
                                continuous=True),
        tscore=get_score_fn(ts, tm, continuous=True), cc=cc, kp=kp,
        init_pose=np.tile(np.asarray(jfit.mean_poses[:66])[None], (B, 1)).astype(np.float32),
        init_cam=np.array([[0.2, -0.1, 6.0], [0.1, 0.1, 5.5]], np.float32))


def test_smplxfit_49_joints_match_jax(fit_setup):
    s = fit_setup
    rng = np.random.default_rng(4)
    kw = dict(betas=rng.normal(size=(3, 10)), body_pose=0.3 * rng.normal(size=(3, 63)),
              global_orient=rng.normal(size=(3, 3)), transl=rng.normal(size=(3, 3)))
    kw = {k: v.astype(np.float32) for k, v in kw.items()}
    ref = s["jfit"](**{k: jnp.asarray(v) for k, v in kw.items()})
    out = s["tfit"](**{k: _t(v) for k, v in kw.items()})
    assert out.joints.shape == (3, 49, 3)
    np.testing.assert_array_equal(_np(s["tfit"].joint_map), s["jfit"].joint_map)
    np.testing.assert_allclose(_np(out.joints), np.asarray(ref.joints), rtol=0, atol=2e-5)
    np.testing.assert_allclose(_np(out.vertices), np.asarray(ref.vertices), rtol=0, atol=2e-5)
    assert s["tfit"].mean_poses.shape == (72,) and s["tfit"].mean_shape.shape == (10,)
    np.testing.assert_allclose(_np(s["tfit"].mean_poses), np.asarray(s["jfit"].mean_poses),
                               atol=1e-6)
    np.testing.assert_array_equal(_np(s["tfit"].mean_shape), np.asarray(s["jfit"].mean_shape))
    with pytest.raises(ValueError):
        s["tfit"](body_pose=_t(kw["body_pose"]), pose2rot=False)


@pytest.mark.parametrize("use_prior", [False, True], ids=["prior_off", "prior_on"])
def test_smplify_matches_jax(fit_setup, use_prior):
    """Both stages against JAX's. Without the prior the fit is deterministic;
    with it the port takes JAX's normals, ``key, k2 = split(key)`` then
    ``k_prior, _ = split(fold_in(k2, i))`` a step. Measured: the pose and
    betas within 1.5e-6, the camera within 2e-8, the reprojection within
    1e-6 relative; held to 2e-5 and 1e-4 relative."""
    s = fit_setup
    jprior = JaxDPoser(s["js"], s["jscore"], s["jnz"], batch_size=B) if use_prior else None
    tprior = DPoser(s["ts"], s["tscore"], s["tnz"], batch_size=B) if use_prior else None
    key = jax.random.PRNGKey(3)
    ref = JaxSMPLify(s["jfit"], pose_prior=jprior, num_iters=NI, focal_length=FOCAL,
                     batch_size=B)(key, jnp.asarray(s["init_pose"]), jnp.zeros((B, 10)),
                                   jnp.asarray(s["init_cam"]), jnp.asarray(s["cc"]),
                                   jnp.asarray(s["kp"]))
    _, k2 = jax.random.split(key)
    z = np.stack([np.asarray(jax.random.normal(jax.random.split(jax.random.fold_in(k2, i))[0],
                                               (B, 63), jnp.float32)) for i in range(5 * NI)])
    out = SMPLify(s["tfit"], pose_prior=tprior, num_iters=NI, focal_length=FOCAL,
                  batch_size=B)(_t(s["init_pose"]), torch.zeros(B, 10), _t(s["init_cam"]),
                                _t(s["cc"]), _t(s["kp"]), z=_t(z))
    for name, o, r in zip(("pose", "betas", "camera", "reprojection"), out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape, name
        tol = 1e-4 if name == "reprojection" else 2e-5
        np.testing.assert_allclose(_np(o), r, rtol=0, atol=tol * max(1.0, np.abs(r).max()),
                                   err_msg=name)
    # the body stage moved the pose, and the ignored joints carry no reprojection
    assert np.abs(_np(out[0]) - s["init_pose"]).max() > 1e-3
    assert float(out[3][:, SMPLify(s["tfit"]).ign_joints].abs().max()) == 0.0


def test_dposer_prior_matches_jax(fit_setup):
    s = fit_setup
    rng = np.random.default_rng(8)
    poses = (0.3 * rng.normal(size=(B, 63))).astype(np.float32)
    z = rng.normal(size=(B, 63)).astype(np.float32)
    jp = JaxDPoser(s["js"], s["jscore"], s["jnz"], batch_size=B)

    def jloss(p):
        normed = jp.normalizer.offline_normalize(p[:, :63], from_axis=True)
        vec_t = jnp.full((B,), jp.timesteps[437], jnp.float32)
        return jp.prior.loss(None, normed, vec_t, weighted=True, reduction="sum_per_batch",
                             batch_size=B, z=jnp.asarray(z))

    ref, gref = jax.value_and_grad(jloss)(jnp.asarray(poses))
    x = _t(poses).requires_grad_(True)
    out = DPoser(s["ts"], s["tscore"], s["tnz"], batch_size=B)(x, None, 437, z=_t(z))
    (g,) = torch.autograd.grad(out, x)
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=2e-5)
    np.testing.assert_allclose(_np(g), np.asarray(gref), rtol=1e-4,
                               atol=1e-5 * float(np.abs(gref).max()))


def test_pa_and_pelvis_mpjpe_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(3):
        pred, gt = rng.normal(size=(2, 22, 3)).astype(np.float32)
        assert tmet.pa_mpjpe(pred, gt) == jmet.pa_mpjpe(pred, gt)
        assert tmet.pelvis_aligned_mpjpe(pred, gt) == jmet.pelvis_aligned_mpjpe(pred, gt)
    assert tmet.pa_mpjpe(gt, gt) < 1e-9


def _write_ply(path, verts, binary):
    with open(path, "wb") as f:
        f.write(b"ply\nformat " + (b"binary_little_endian" if binary else b"ascii")
                + b" 1.0\nelement vertex %d\nproperty float x\nproperty float y\n"
                  b"property float z\nelement face 0\nproperty list uchar int vertex_indices\n"
                  b"end_header\n" % len(verts))
        if binary:
            f.write(verts.astype("<f4").tobytes())
        else:
            f.write("".join(f"{a:.7f} {b:.7f} {c:.7f}\n" for a, b, c in verts).encode())


def test_eval_ehf_matches_jax(fit_setup, tmp_path):
    """``eval_EHF`` of a fit against a ply scan: the same numbers through both
    packages' body models, from an ascii and a binary ply."""
    s = fit_setup
    rng = np.random.default_rng(6)
    verts = (0.15 * rng.normal(size=(120, 3))).astype(np.float32)
    pred = ((0.2 * rng.normal(size=(1, 66))).astype(np.float32),
            (0.3 * rng.normal(size=(1, 10))).astype(np.float32),
            np.array([[0.1, -0.2, 5.0]], np.float32), None)
    jdb = JaxMocapDataset([], np.zeros((0, 5)), body_model=s["jfit"].bm)
    tdb = MocapDataset([], np.zeros((0, 5)), body_model=s["tfit"].bm)
    np.testing.assert_allclose(tdb.cam_R, jdb.cam_R, atol=1e-6)
    for binary in (False, True):
        ply = str(tmp_path / f"gt{binary}.ply")
        _write_ply(ply, verts, binary)
        np.testing.assert_allclose(tpre.load_ply(ply), jpre.load_ply(ply), rtol=0, atol=0)
        ref, out = jdb.eval_EHF(pred, ply), tdb.eval_EHF(pred, ply)
        for k in ("pa_mpjpe_body", "mpjpe_body"):
            np.testing.assert_allclose(out[k], ref[k], rtol=2e-4, err_msg=k)


def test_preprocess_matches_jax():
    rng = np.random.default_rng(7)
    people = {"people": [{"pose_keypoints_2d": np.concatenate(
        [rng.uniform(50, 150, (25, 2)), (rng.uniform(size=(25, 1)) > 0.2)], 1).ravel().tolist()}
        for _ in range(2)] + [{"pose_keypoints_2d": [0.0] * 75}]}
    bb = tpre.compute_bbox(people)
    np.testing.assert_array_equal(bb, jpre.compute_bbox(people))
    assert bb.shape == (2, 5)
    for box in ([400, 100, 1000, 1200], bb[0, 1:]):
        c, sc = tpre.bbox_from_detector(box)
        jc, jsc = jpre.bbox_from_detector(box)
        np.testing.assert_array_equal(c, jc)
        assert sc == jsc
        for rot in (0, 30):
            np.testing.assert_array_equal(tpre.get_transform(c, sc, (256, 192), rot),
                                          jpre.get_transform(c, sc, (256, 192), rot))
            np.testing.assert_array_equal(tpre.transform([10, 20], c, sc, (256, 192), 1, rot),
                                          jpre.transform([10, 20], c, sc, (256, 192), 1, rot))
    img = rng.uniform(0, 255, (300, 260, 3)).astype(np.float32)
    out, ref = tpre.process_image(img, bb[0][1:5]), jpre.process_image(img, bb[0][1:5])
    assert out[0].shape == (3, constants.CROP_IMG_HEIGHT, constants.CROP_IMG_WIDTH)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_build_dposer_prior(tmp_path):
    """The library shim: the pinned checkpoint as the prior of SMPLify at
    sde_N 500, on the stats the checkpoint was trained with."""
    from types import SimpleNamespace

    args = SimpleNamespace(config_path=None, ckpt_path=os.path.join(
        ART, "axis-zscore-400k-synth.pth"), sde_N=500, dataset_folder=str(tmp_path),
        version="v", stats_dir=os.path.join(ART, "stats"), device="cpu")
    prior = build_dposer_prior(args, batch_size=3)
    assert isinstance(prior, DPoser) and prior.batch_size == 3
    assert prior.prior.sde.N == 500 and len(prior.timesteps) == 500
    val = prior(torch.zeros(3, 66), None, 450, z=torch.zeros(3, 63))
    assert val.shape == () and torch.isfinite(val)


@pytest.fixture(scope="module")
def ehf_dir(tmp_path_factory):
    """The fitting protocol's data: 8 images of ``benchmarks/gen_synth_ehf.py``
    (in-distribution draws, ``--pose-scale 1.0``) on the ``hd`` synthetic
    SMPL-X body of ``gen_synth_body.py`` (10,475 vertices, so the 21 extra
    keypoints are distinct vertices; template scale 0.15), as
    ``artifacts/protocols_r4/config4_fitting_synth_gt_hd.log`` ran it."""
    tmp = tmp_path_factory.mktemp("torch_ehf")
    body, _ = make_synthetic_body_model(tmp / "hd.npz", "smplx", n_verts=10475,
                                        template_scale=0.15, seed=0)
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    spec = importlib.util.spec_from_file_location(
        "gen_synth_ehf", os.path.join(REPO, "benchmarks", "gen_synth_ehf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = sys.argv
    sys.argv = ["gen_synth_ehf.py", "--out", str(tmp / "ehf"), "--bodymodel-path", body,
                "--n-images", "8", "--pose-scale", "1.0"]
    try:
        mod.main()
    finally:
        sys.argv = argv
    return dict(tmp=tmp, body=body, data=str(tmp / "ehf"))


def test_fitting_cli_on_synthetic_ehf(ehf_dir, capsys):
    """The CLI at the reference's defaults (step 1e-2, 5 x 100 iterations) with
    the pinned prior, the 8 images as one batch: the unfitted init's PA-MPJPE
    and MPJPE are the JAX package's ``init_baseline.json`` (no noise enters
    them), and the fit lands below them, the contract of
    tests/test_smplify.py (the JAX CLI draws other normals, so its fit is
    not comparable pointwise)."""
    torch.set_num_threads(2)  # the 10,475-vertex body's products: ~1 GFLOP a step
    try:
        out = cli.run(cli.parse_args([
            "--data-dir", ehf_dir["data"], "--device", "cpu", "--bodymodel-path",
            ehf_dir["body"], "--ckpt-path", os.path.join(ART, "axis-zscore-400k-synth.pth"),
            "--stats-dir", os.path.join(ART, "stats"), "--report-init-baseline",
            "--batch-images", "8", "--outdir", str(ehf_dir["tmp"] / "out")]))
    finally:
        torch.set_num_threads(1)
    printed = capsys.readouterr().out
    assert "init (unfitted) baseline on whole dataset:" in printed
    assert "results on whole dataset:" in printed
    with open(os.path.join(ehf_dir["data"], "init_baseline.json")) as f:
        base = json.load(f)
    for k in ("pa_mpjpe_body", "mpjpe_body"):
        assert len(out[k]) == 8
        np.testing.assert_allclose(np.mean(out[f"init_{k}"]), base[k], rtol=1e-4, err_msg=k)
        assert np.mean(out[k]) < np.mean(out[f"init_{k}"]), (k, out)
    with np.load(ehf_dir["tmp"] / "out" / "01_img_fit.npz") as f:
        assert f["pose"].shape == (1, 66) and f["betas"].shape == (1, 10)
        assert np.isfinite(f["pose"]).all()
