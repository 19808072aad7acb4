"""The port's AMASSDataset against the JAX package's on a tiny layout (CPU):
the normalized poses, the cached stats files, Denormalize, the eval batches
and the index stream with and without ``skip=``."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.data.amass import AMASSDataset as JaxDataset
from dposer_tpu_torch.data import AMASSDataset

N_TRAIN, N_TEST = 90, 40


def make_layout(root, rng_seed=0):
    """train as ``pose_body.npy``, test as a torch ``pose_body.pt``."""
    rng = np.random.default_rng(rng_seed)
    for subset, n in (("train", N_TRAIN), ("test", N_TEST)):
        d = os.path.join(root, "v1", subset)
        os.makedirs(d, exist_ok=True)
        poses = (0.4 * rng.normal(size=(n, 63)) + 0.1).astype(np.float32)
        if subset == "train":
            np.save(os.path.join(d, "pose_body.npy"), poses)
        else:
            torch.save(torch.from_numpy(poses), os.path.join(d, "pose_body.pt"))
    return root


@pytest.fixture
def layouts(tmp_path):
    """Two copies of one layout, so each package computes its own cache."""
    a = make_layout(str(tmp_path / "a"))
    b = str(tmp_path / "b")
    shutil.copytree(a, b)
    return a, b


@pytest.mark.parametrize("rot_rep", ["axis", "rot6d"])
@pytest.mark.parametrize("min_max", [False, True])
@pytest.mark.parametrize("subset", ["train", "test"])
def test_dataset_matches_jax(layouts, rot_rep, min_max, subset):
    a, b = layouts
    kw = dict(version="v1", rot_rep=rot_rep, normalize=True, min_max=min_max)
    ref = JaxDataset(a, subset=subset, **kw)
    got = AMASSDataset(b, subset=subset, **kw)
    assert got.poses.dtype == np.float32 and got.poses.shape == ref.poses.shape
    np.testing.assert_allclose(got.poses, ref.poses, rtol=1e-5, atol=1e-5)
    # both families of stats cached beside the train split, as .npz
    for suffix in ("_normalize1", "_normalize2"):
        with np.load(os.path.join(a, "v1", "train", rot_rep + suffix + ".npz")) as fa, \
                np.load(os.path.join(b, "v1", "train", rot_rep + suffix + ".npz")) as fb:
            assert sorted(fa.files) == sorted(fb.files)
            for k in fa.files:
                np.testing.assert_allclose(fb[k], fa[k], rtol=1e-5, atol=1e-6, err_msg=k)
    x = ref.poses[:7]
    np.testing.assert_allclose(got.Denormalize(torch.from_numpy(x)).numpy(),
                               np.asarray(ref.Denormalize(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)
    for eb_ref, eb in zip(ref.eval_batches(8), got.eval_batches(8), strict=True):
        np.testing.assert_allclose(eb, eb_ref, rtol=1e-5, atol=1e-5)


def test_std_is_bessel_corrected(tmp_path):
    root = make_layout(str(tmp_path))
    ds = AMASSDataset(root, version="v1", subset="train", rot_rep="axis", min_max=False)
    raw = np.load(os.path.join(root, "v1", "train", "pose_body.npy"))
    np.testing.assert_allclose(ds.std_poses, raw.std(0, ddof=1), rtol=1e-6)


def test_reference_pt_stats_are_read(layouts):
    """A reference ``.pt`` stats cache is used as it is, by both packages."""
    a, b = layouts
    rng = np.random.default_rng(3)
    stats = {"mean_poses": torch.from_numpy(rng.normal(size=63).astype(np.float32)),
             "std_poses": torch.from_numpy(rng.uniform(0.5, 1, 63).astype(np.float32)),
             "mean_shapes": None, "std_shapes": None}
    for root in (a, b):
        torch.save(stats, os.path.join(root, "v1", "train", "axis_normalize2.pt"))
    kw = dict(version="v1", subset="test", rot_rep="axis", min_max=False)
    ref, got = JaxDataset(a, **kw), AMASSDataset(b, **kw)
    np.testing.assert_allclose(got.mean_poses, stats["mean_poses"].numpy())
    np.testing.assert_allclose(got.poses, ref.poses, rtol=1e-6, atol=1e-6)
    assert not os.path.exists(os.path.join(b, "v1", "train", "axis_normalize2.npz"))


@pytest.mark.parametrize("skip", [0, 3, 7, 20])
def test_index_stream_matches_jax(layouts, skip):
    """The same rows, batch for batch (numpy's default_rng permutation), and
    skip=k is the unskipped stream from batch k on (an epoch is 4 batches)."""
    a, b = layouts
    kw = dict(version="v1", subset="train", rot_rep="axis", min_max=False)
    ref, got = JaxDataset(a, **kw), AMASSDataset(b, **kw)
    s_ref = ref.train_index_batches(20, seed=5, skip=skip)
    s_got = got.train_index_batches(20, seed=5, skip=skip)
    full = got.train_index_batches(20, seed=5)
    whole = [next(full) for _ in range(skip + 9)]
    for i in range(9):
        r, g = next(s_ref), next(s_got)
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, whole[skip + i])
    with pytest.raises(ValueError):
        next(got.train_index_batches(N_TRAIN + 1))


@pytest.mark.parametrize("min_max", [False, True])
def test_rot6d_normalizer_matches_jax(layouts, min_max):
    """The port's PoseNormalizer with rot_rep="rot6d" (axis-angle in and out)
    against the JAX package's, on stats the dataset cached."""
    from dposer_tpu.data.amass import PoseNormalizer as JaxNormalizer
    from dposer_tpu_torch.data import PoseNormalizer

    a, _ = layouts
    JaxDataset(a, version="v1", subset="train", rot_rep="rot6d", min_max=min_max)
    stats = os.path.join(a, "v1", "train")
    ref = JaxNormalizer(stats, normalize=True, min_max=min_max, rot_rep="rot6d")
    got = PoseNormalizer(stats, normalize=True, min_max=min_max, rot_rep="rot6d")
    aa = (0.5 * np.random.default_rng(2).normal(size=(3, 5, 63))).astype(np.float32)
    n_ref = np.asarray(ref.offline_normalize(jnp.asarray(aa), from_axis=True))
    n_got = got.offline_normalize(torch.from_numpy(aa), from_axis=True)
    assert n_got.shape == (3, 5, 126)
    np.testing.assert_allclose(n_got.numpy(), n_ref, rtol=1e-4, atol=1e-4)
    back = got.offline_denormalize(n_got, to_axis=True)
    np.testing.assert_allclose(back.numpy(), np.asarray(
        ref.offline_denormalize(jnp.asarray(n_ref), to_axis=True)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), aa, atol=1e-4)
