"""The HumanEva sequence splitter (ref ``lib/dataset/HumanEva.py``): AMASS
npz files sliced into fixed-length pose fragments for the motion-denoising
evaluation. Port of ``dposer_tpu/data/humaneva.py``.

    python -m dposer_tpu_torch.data.humaneva --input-dir ... --output-dir ... [--seq-len 60]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def split_npz(npz_fname: str, output_base_dir: str, seq_len: int = 60):
    """Write ``<output>/<subdir>/<name>_batchNNN.npz`` fragments (``pose_body``
    [seq_len, 63], ``root_orient`` [seq_len, 3]) of one sequence; a file
    without ``poses`` (AMASS's ``*_shape.npz``, ``*_stagei.npz``) is skipped."""
    with np.load(npz_fname, allow_pickle=True) as cdata:
        if "poses" not in cdata:
            print(f"skipping {npz_fname} (no 'poses' key)")
            return
        fullpose = cdata["poses"]
    pose_body = fullpose[:, 3:66]
    root_orient = fullpose[:, :3]
    base_name = os.path.basename(npz_fname).replace(".npz", "")
    output_dir = os.path.join(output_base_dir, os.path.basename(os.path.dirname(npz_fname)))
    os.makedirs(output_dir, exist_ok=True)
    for idx in range(pose_body.shape[0] // seq_len):
        s, e = idx * seq_len, (idx + 1) * seq_len
        np.savez(os.path.join(output_dir, f"{base_name}_batch{str(idx).zfill(3)}.npz"),
                 pose_body=pose_body[s:e], root_orient=root_orient[s:e])


def main(args):
    for root, _, files in os.walk(args.input_dir):
        for file in files:
            if file.endswith(".npz"):
                split_npz(os.path.join(root, file), args.output_dir, args.seq_len)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Preprocess pose and trans data and save as npz files.")
    parser.add_argument("--input-dir", type=str, required=True)
    parser.add_argument("--output-dir", type=str, required=True)
    parser.add_argument("--seq-len", type=int, default=60)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
