"""The port's pose normalizer, SMPL body model and APD against the JAX
package (CPU)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.body_model.smplx_jax import BodyModel as JaxBodyModel
from dposer_tpu.data import PoseNormalizer as JaxPoseNormalizer
from dposer_tpu.ops.metrics import average_pairwise_distance as jax_apd
from dposer_tpu_torch.body_model import BodyModel
from dposer_tpu_torch.data import PoseNormalizer
from dposer_tpu_torch.ops.metrics import average_pairwise_distance

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
