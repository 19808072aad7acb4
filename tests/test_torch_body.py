"""The port's pose normalizer, SMPL / SMPL-H / SMPL-X body model, APD and
completion ``Evaler`` against the JAX package (CPU)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.body_model.smplx_jax import BodyModel as JaxBodyModel
from dposer_tpu.data import PoseNormalizer as JaxPoseNormalizer
from dposer_tpu.ops.metrics import Evaler as JaxEvaler
from dposer_tpu.ops.metrics import average_pairwise_distance as jax_apd
from dposer_tpu_torch.body_model import BodyModel
from dposer_tpu_torch.data import PoseNormalizer
from dposer_tpu_torch.ops.metrics import Evaler, average_pairwise_distance

from fixtures import make_stats_dir, make_synthetic_body_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED_STATS = os.path.join(REPO, "artifacts", "trained_r5", "stats")


@pytest.mark.parametrize("min_max", [False, True])
def test_normalizer_matches_jax(min_max):
    if not os.path.isdir(PINNED_STATS):
        pytest.skip("pinned normalizer stats not present")
    mine = PoseNormalizer(PINNED_STATS, normalize=True, min_max=min_max, rot_rep="axis")
    ref = JaxPoseNormalizer(PINNED_STATS, normalize=True, min_max=min_max, rot_rep="axis")
    x = np.random.default_rng(0).normal(size=(16, 63)).astype(np.float32)
    for fn in ("offline_normalize", "offline_denormalize"):
        out = getattr(mine, fn)(torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(getattr(ref, fn)(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6, err_msg=fn)
    back = mine.offline_denormalize(mine.offline_normalize(torch.from_numpy(x)))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


def test_normalizer_reads_fixture_stats(tmp_path):
    rng = np.random.default_rng(1)
    mean, std = rng.normal(size=63), rng.uniform(0.5, 2.0, size=63)
    d = make_stats_dir(tmp_path / "stats", mean=mean, std=std)
    norm = PoseNormalizer(d, normalize=True, min_max=False)
    x = torch.zeros(2, 63)
    np.testing.assert_allclose(norm.offline_denormalize(x).numpy()[0], mean, rtol=1e-6)
    assert torch.equal(PoseNormalizer(d, normalize=False).offline_normalize(x), x)
    with pytest.raises(NotImplementedError):
        PoseNormalizer(d, rot_rep="rot6d")


@pytest.fixture(scope="module")
def smpl_file(tmp_path_factory):
    path, _ = make_synthetic_body_model(tmp_path_factory.mktemp("smpl") / "smpl.npz", "smpl")
    return path


def test_smpl_matches_jax(smpl_file):
    rng = np.random.default_rng(2)
    B = 5
    pose = (0.4 * rng.normal(size=(B, 69))).astype(np.float32)
    pose[0] = 0.0  # the theta -> 0 Taylor branch of Rodrigues
    root = (0.3 * rng.normal(size=(B, 3))).astype(np.float32)
    betas = rng.normal(size=(B, 10)).astype(np.float32)
    trans = rng.normal(size=(B, 3)).astype(np.float32)
    ref = JaxBodyModel(smpl_file, model_type="smpl", batch_size=B, num_betas=10)(
        root_orient=jnp.asarray(root), pose_body=jnp.asarray(pose),
        betas=jnp.asarray(betas), trans=jnp.asarray(trans))
    out = BodyModel(smpl_file, num_betas=10, model_type="smpl")(
        root_orient=torch.from_numpy(root), pose_body=torch.from_numpy(pose),
        betas=torch.from_numpy(betas), trans=torch.from_numpy(trans))
    np.testing.assert_allclose(out.v.numpy(), np.asarray(ref.v), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(out.Jtr.numpy(), np.asarray(ref.Jtr), rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(out.f.numpy(), np.asarray(ref.f))


def test_smpl_defaults_and_apd_match_jax(smpl_file):
    """The metrics protocol's call: pose only, zero-padded hand joints."""
    rng = np.random.default_rng(3)
    B = 12
    pose = np.concatenate([0.5 * rng.normal(size=(B, 63)), np.zeros((B, 6))], 1)
    pose = pose.astype(np.float32)
    ref = JaxBodyModel(smpl_file, model_type="smpl", batch_size=B, num_betas=10)(
        pose_body=jnp.asarray(pose))
    out = BodyModel(smpl_file, num_betas=10, model_type="smpl")(
        pose_body=torch.from_numpy(pose))
    np.testing.assert_allclose(out.Jtr.numpy(), np.asarray(ref.Jtr), rtol=1e-5, atol=2e-5)
    apd_ref = float(jax_apd(ref.Jtr[:, :22]))
    apd = float(average_pairwise_distance(out.Jtr[:, :22]))
    np.testing.assert_allclose(apd, apd_ref, rtol=1e-5)
    j = rng.normal(size=(7, 22, 3)).astype(np.float32)
    np.testing.assert_allclose(float(average_pairwise_distance(torch.from_numpy(j))),
                               float(jax_apd(jnp.asarray(j))), rtol=1e-6)


@pytest.mark.parametrize("model_type", ["smplx", "smplh"])
def test_smplx_smplh_match_jax(tmp_path, model_type):
    """21 body joints; hands, jaw, eyes and expression given, and left to
    their zero defaults; the extra keypoints (clamped on the small template)
    and, for SMPL-X, the barycentric face landmarks in ``Jtr``."""
    path, _ = make_synthetic_body_model(tmp_path / f"{model_type}.npz", model_type)
    rng = np.random.default_rng(4)
    B = 4
    parts = dict(root_orient=0.3 * rng.normal(size=(B, 3)), pose_body=0.4 * rng.normal(size=(B, 63)),
                 pose_hand=0.2 * rng.normal(size=(B, 90)), betas=rng.normal(size=(B, 10)),
                 trans=rng.normal(size=(B, 3)))
    if model_type == "smplx":
        parts.update(pose_jaw=0.1 * rng.normal(size=(B, 3)), pose_eye=0.1 * rng.normal(size=(B, 6)),
                     expression=rng.normal(size=(B, 10)))
    parts = {k: v.astype(np.float32) for k, v in parts.items()}
    jbody = JaxBodyModel(path, model_type=model_type, batch_size=B, num_betas=10)
    body = BodyModel(path, num_betas=10, model_type=model_type)
    for given in (parts, dict(pose_body=parts["pose_body"])):
        ref = jbody(**{k: jnp.asarray(v) for k, v in given.items()})
        out = body(**{k: torch.from_numpy(v) for k, v in given.items()})
        n_lbs = {"smplx": 55, "smplh": 52}[model_type]
        assert out.Jtr.shape[1] == n_lbs + 21 + (51 if model_type == "smplx" else 0)
        np.testing.assert_allclose(out.v.numpy(), np.asarray(ref.v), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out.Jtr.numpy(), np.asarray(ref.Jtr), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(out.full_pose.numpy(), np.asarray(ref.full_pose))
        np.testing.assert_array_equal(out.pose_hand.numpy(), np.asarray(ref.pose_hand))
    with pytest.raises(ValueError):
        BodyModel(path, model_type="mano")


@pytest.mark.parametrize("part", ["left_leg", "arms", None])
def test_evaler_matches_jax(tmp_path, part):
    """Min-over-hypotheses MPVPE / MPJPE in mm, to 1e-3 mm. The synthetic
    template is smaller than the SMPL-X segmentation, so both sides score all
    of its vertices."""
    path, _ = make_synthetic_body_model(tmp_path / "smplx.npz", "smplx")
    rng = np.random.default_rng(5)
    gts = (0.4 * rng.normal(size=(5, 63))).astype(np.float32)
    outs = (gts[:, None] + 0.1 * rng.normal(size=(5, 3, 63))).astype(np.float32)
    ref = JaxEvaler(JaxBodyModel(path, model_type="smplx", batch_size=5), part=part)
    mine = Evaler(BodyModel(path, model_type="smplx"), part=part)
    assert isinstance(mine.vert_idx, slice)
    for name, r, o in (("multi", ref.multi_eval_bodys(jnp.asarray(outs), jnp.asarray(gts)),
                        mine.multi_eval_bodys(torch.from_numpy(outs), torch.from_numpy(gts))),
                       ("single", ref.eval_bodys(jnp.asarray(outs[:, 0]), jnp.asarray(gts)),
                        mine.eval_bodys(torch.from_numpy(outs[:, 0]), torch.from_numpy(gts)))):
        for k in ("mpvpe_all", "mpjpe_body"):
            assert o[k].shape == (5,)
            np.testing.assert_allclose(o[k], r[k], rtol=0, atol=1e-3, err_msg=f"{name} {k}")


def test_evaler_vertex_segmentation(tmp_path, capsys):
    """On a template as large as the SMPL-X mesh the part's own vertices are
    scored; a missing segmentation warns and scores all."""
    path, _ = make_synthetic_body_model(tmp_path / "big.npz", "smplx", n_verts=10475)
    body = BodyModel(path, model_type="smplx")
    ev = Evaler(body, part="left_leg")
    seg = JaxEvaler(JaxBodyModel(path, model_type="smplx"), part="left_leg").vert_idx
    np.testing.assert_array_equal(ev.vert_idx.numpy(), np.asarray(seg))
    with pytest.warns(RuntimeWarning, match="ALL vertices"):
        ev = Evaler(body, part="left_leg", seg_json_path=str(tmp_path / "missing.json"))
    assert isinstance(ev.vert_idx, slice)
    Evaler.print_multi_eval_result({"mpvpe_all": np.array([1.0, 2.0]),
                                    "mpjpe_body": np.array([3.0])}, 4)
    assert capsys.readouterr().out == ("multihypo 4 MPVPE (All): 1.50 mm\n"
                                       "multihypo 4 MPJPE (Body): 3.00 mm\n")
