"""Pose normalizer over cached train-split stats (ref AMASS.py:187-259).

Reads ``{rot_rep}_normalize1`` (min/max) and ``{rot_rep}_normalize2``
(mean/std) from a stats directory, as ``.npz`` or ``.pt``. With
``rot_rep="rot6d"`` the ``from_axis`` / ``to_axis`` flags convert through
``ops/rotations.py``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.rotations import axis_angle_to_rot6d, rot6d_to_axis_angle


def _load_stats(path_no_ext: str) -> dict:
    if os.path.exists(path_no_ext + ".npz"):
        with np.load(path_no_ext + ".npz", allow_pickle=False) as f:
            return {k: f[k] for k in f.files}
    if os.path.exists(path_no_ext + ".pt"):
        obj = torch.load(path_no_ext + ".pt", map_location="cpu", weights_only=True)
        return {k: (None if v is None else np.asarray(v)) for k, v in obj.items()}
    raise FileNotFoundError(f"no stats file at {path_no_ext}.npz/.pt")


class PoseNormalizer:
    """``offline_normalize`` / ``offline_denormalize`` for [..., D] poses."""

    def __init__(self, data_path: str, normalize: bool = True,
                 min_max: bool = True, rot_rep: str = "axis", device="cpu"):
        if rot_rep not in ("axis", "rot6d"):
            raise ValueError(f"rot_rep must be 'axis' or 'rot6d', got {rot_rep!r}")
        self.normalize = normalize
        self.min_max = min_max
        self.rot_rep = rot_rep

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        p1 = _load_stats(os.path.join(data_path, f"{rot_rep}_normalize1"))
        self.min_poses, self.max_poses = t(p1["min_poses"]), t(p1["max_poses"])
        p2 = _load_stats(os.path.join(data_path, f"{rot_rep}_normalize2"))
        self.mean_poses, self.std_poses = t(p2["mean_poses"]), t(p2["std_poses"])

    def offline_normalize(self, poses: torch.Tensor, from_axis: bool = False) -> torch.Tensor:
        if from_axis and self.rot_rep == "rot6d":
            poses = axis_angle_to_rot6d(poses.reshape(-1, 3)).reshape(*poses.shape[:-1], -1)
        if not self.normalize:
            return poses
        if self.min_max:
            return 2 * (poses - self.min_poses) / (self.max_poses - self.min_poses) - 1
        return (poses - self.mean_poses) / self.std_poses

    def offline_denormalize(self, poses: torch.Tensor, to_axis: bool = False) -> torch.Tensor:
        if not self.normalize:
            out = poses
        elif self.min_max:
            out = 0.5 * ((poses + 1) * (self.max_poses - self.min_poses) + 2 * self.min_poses)
        else:
            out = poses * self.std_poses + self.mean_poses
        if to_axis and self.rot_rep == "rot6d":
            out = rot6d_to_axis_angle(out.reshape(-1, 6)).reshape(*out.shape[:-1], -1)
        return out
