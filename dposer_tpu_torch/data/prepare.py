"""AMASS preparation (port of ``dposer_tpu/data/prepare.py``; ref
lib/data/prepare_data.py and script.py): the VPoser-style dump of raw mocap
sequences into the split tensors ``AMASSDataset`` reads.

For each split, every ``<amass-dir>/<subset>/*/*_stageii.npz`` sequence (or
``*_poses.npz`` where a subset has no ``stageii`` files) keeps a random 30%
of the frames of its middle 80%, drawn without replacement from one
``numpy.random.default_rng(seed)`` stream over the split; the frames'
``pose_body`` [n, 63], ``root_orient`` [n, 3] and, with ``--betas``, the
sequence's ``betas`` [n, 10] are concatenated and written as
``<output-dir>/<split>/<field>.pt`` (a torch tensor) with a ``.npy`` sibling.

    python -m dposer_tpu_torch.data.prepare --amass-dir <raw AMASS> \\
        --output-dir <processed>/version1 [--betas] [--keep-rate 0.3] [--seed 0]
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

# the AMASS split definition (ref lib/data/script.py:18-23)
AMASS_SPLITS = {
    "train": ["CMU", "PosePrior", "TotalCapture", "Eyes_Japan_Dataset", "KIT",
              "BMLrub", "BMLmovi", "EKUT", "TCDHands", "ACCAD"],
    "valid": ["HumanEva", "HDM05", "SFU", "Mosh"],
    "test": ["Transitions", "SSM"],
}


def _save(path: str, array: np.ndarray):
    """``array`` as ``path`` (.pt) and its ``.npy`` sibling."""
    np.save(os.path.splitext(path)[0] + ".npy", array)
    torch.save(torch.from_numpy(array), path)


def prepare_split(split_name: str, ds_names, amass_dir: str, out_dir: str,
                  keep_rate: float = 0.3, num_betas: int = 10,
                  save_betas: bool = False, seed: int = 0):
    """Write ``<out_dir>/<split_name>/{pose_body,root_orient[,betas]}.pt``
    (and ``.npy``) from the subsets ``ds_names`` under ``amass_dir``."""
    rng = np.random.default_rng(seed)
    fields = {"pose_body": [], "root_orient": []}
    if save_betas:
        fields["betas"] = []

    for ds_name in ds_names:
        fnames = sorted(glob.glob(os.path.join(amass_dir, ds_name, "*/*_stageii.npz")))
        if not fnames:
            fnames = sorted(glob.glob(os.path.join(amass_dir, ds_name, "*/*_poses.npz")))
        print(f"Found {len(fnames)} sequences from {ds_name}.")
        for fname in fnames:
            with np.load(fname, allow_pickle=True) as cdata:
                poses, betas = cdata["poses"], (cdata["betas"] if save_betas else None)
            n = len(poses)
            lo, hi = int(0.1 * n), int(0.9 * n)
            take = int(keep_rate * 0.8 * n)
            if take < 1 or hi <= lo:
                continue
            ids = rng.choice(np.arange(lo, hi), take, replace=False)
            fullpose = poses[ids].astype(np.float32)
            fields["pose_body"].append(fullpose[:, 3:66])
            fields["root_orient"].append(fullpose[:, :3])
            if save_betas:
                fields["betas"].append(
                    np.tile(betas[:num_betas].astype(np.float32), (len(ids), 1)))

    split_dir = os.path.join(out_dir, split_name)
    os.makedirs(split_dir, exist_ok=True)
    empty_width = {"pose_body": 63, "root_orient": 3, "betas": num_betas}
    for k, v in fields.items():
        arr = np.concatenate(v) if v else np.zeros((0, empty_width[k]), np.float32)
        _save(os.path.join(split_dir, f"{k}.pt"), arr)
        print(f"{split_name}/{k}: {arr.shape}")


def parse_args(argv):
    p = argparse.ArgumentParser(description="Prepare AMASS pose tensors.")
    p.add_argument("--amass-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--keep-rate", type=float, default=0.3)
    p.add_argument("--betas", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    for split_name, ds_names in AMASS_SPLITS.items():
        prepare_split(split_name, ds_names, args.amass_dir, args.output_dir,
                      keep_rate=args.keep_rate, save_betas=args.betas, seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
