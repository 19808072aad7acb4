"""The port's AMASS preparation (``dposer_tpu_torch/data/prepare.py``)
against the JAX package's on synthetic raw sequences (CPU): the split
arrays byte for byte, the CLI over all splits, and the dump read back by
the port's ``AMASSDataset`` loader."""
import os

import numpy as np
import pytest
import torch

from dposer_tpu.data import prepare as jprepare
from dposer_tpu_torch.data import prepare
from dposer_tpu_torch.data.amass import _load_tensor_file


def write_raw(root, rng, layout):
    """``layout``: {subset: [(subject, name, frames, suffix)]} raw sequences
    of float64 165-dim SMPL-X poses and 16 betas."""
    for ds, seqs in layout.items():
        for subject, name, frames, suffix in seqs:
            d = root / ds / subject
            d.mkdir(parents=True, exist_ok=True)
            np.savez(d / f"{name}_{suffix}.npz", poses=rng.normal(size=(frames, 165)),
                     betas=rng.normal(size=(16,)))


LAYOUT = {"CMU": [("s1", "walk", 200, "stageii"), ("s2", "run", 57, "stageii")],
          "KIT": [("s1", "jump", 90, "poses")],  # a subset without stageii files
          "SSM": [("s3", "tiny", 3, "stageii")],  # too short to keep a frame
          "Transitions": [("s4", "turn", 120, "stageii")]}


def test_splits_match_jax():
    assert prepare.AMASS_SPLITS == jprepare.AMASS_SPLITS


@pytest.mark.parametrize("save_betas", [False, True], ids=["poses", "betas"])
def test_prepare_split_byte_equal_to_jax(tmp_path, save_betas):
    write_raw(tmp_path / "amass", np.random.default_rng(0), LAYOUT)
    for name, mod in (("jax", jprepare), ("torch", prepare)):
        mod.prepare_split("train", ["CMU", "KIT", "SSM"], str(tmp_path / "amass"),
                          str(tmp_path / name), keep_rate=0.3, save_betas=save_betas, seed=4)
    fields = ["pose_body", "root_orient"] + (["betas"] if save_betas else [])
    assert sorted(os.listdir(tmp_path / "torch" / "train")) == sorted(
        os.listdir(tmp_path / "jax" / "train")) == sorted(
        [f"{k}.{e}" for k in fields for e in ("pt", "npy")])
    for k in fields:
        a = (tmp_path / "torch" / "train" / f"{k}.npy").read_bytes()
        assert a == (tmp_path / "jax" / "train" / f"{k}.npy").read_bytes(), k
        ref = np.load(tmp_path / "jax" / "train" / f"{k}.npy")
        pt = torch.load(tmp_path / "torch" / "train" / f"{k}.pt", weights_only=True)
        assert pt.dtype == torch.float32 and np.array_equal(pt.numpy(), ref)
    # 30% of the middle 80%: 48 of 200, 13 of 57, 21 of 90, none of 3
    assert np.load(tmp_path / "torch" / "train" / "pose_body.npy").shape == (82, 63)


def test_cli_writes_every_split(tmp_path):
    write_raw(tmp_path / "amass", np.random.default_rng(1), LAYOUT)
    out = tmp_path / "version1"
    assert prepare.main(["--amass-dir", str(tmp_path / "amass"), "--output-dir", str(out),
                         "--betas", "--seed", "2"]) == 0
    jprepare.main(type("A", (), dict(amass_dir=str(tmp_path / "amass"),
                                     output_dir=str(tmp_path / "jax"), keep_rate=0.3,
                                     betas=True, seed=2)))
    for split in prepare.AMASS_SPLITS:
        for k in ("pose_body", "root_orient", "betas"):
            assert ((out / split / f"{k}.npy").read_bytes()
                    == (tmp_path / "jax" / split / f"{k}.npy").read_bytes()), (split, k)
    # the valid split has no sequence: empty arrays of the fields' widths
    assert _load_tensor_file(str(out / "valid" / "pose_body.pt")).shape == (0, 63)
    assert _load_tensor_file(str(out / "valid" / "betas.pt")).shape == (0, 10)
    assert _load_tensor_file(str(out / "test" / "pose_body.pt")).shape == (28, 63)
