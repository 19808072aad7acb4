"""The AMASS pose dataset (port of ``dposer_tpu/data/amass.py``; ref
lib/dataset/AMASS.py:12-184).

Data layout, as the reference's: ``<root>/<version>/<subset>/pose_body.pt``
(and ``betas.pt``), each also readable as ``.npz`` or ``.npy`` siblings, and
the normalization caches computed on the *train* split beside it:

- ``{rot}_normalize1``: ``{min_poses, max_poses, min_shapes, max_shapes}``
- ``{rot}_normalize2``: ``{mean_poses, std_poses, mean_shapes, std_shapes}``

Poses live on the host as numpy; the trainer uploads them once and gathers
each batch on the device. ``train_index_batches`` is numpy's
``default_rng(seed).permutation`` stream, so it yields the JAX package's
rows exactly, and ``skip=`` fast-forwards it on resume.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops.rotations import axis_angle_to_rot6d

N_POSES = 21  # SMPL-X body joints in the prior (ref AMASS.py:9)


def _load_tensor_file(path: str):
    """A ``.pt`` (``torch.load``) or its ``.npz`` / ``.npy`` sibling, as
    numpy: a dict of arrays or one array."""
    stem = os.path.splitext(path)[0]
    if os.path.exists(path) and path.endswith(".pt"):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict):
            return {k: (None if v is None else np.asarray(v.detach().cpu().numpy()).copy())
                    for k, v in obj.items()}
        return np.asarray(obj.detach().cpu().numpy()).copy()
    if os.path.exists(stem + ".npz"):
        with np.load(stem + ".npz", allow_pickle=True) as f:
            return {k: f[k] for k in f.files}
    if os.path.exists(stem + ".npy"):
        return np.load(stem + ".npy")
    raise FileNotFoundError(f"no tensor file at {path} (.pt/.npz/.npy)")


def _axis_to_rot6d_flat(poses: np.ndarray) -> np.ndarray:
    n = len(poses)
    aa = torch.from_numpy(np.ascontiguousarray(poses).reshape(-1, 3))
    return axis_angle_to_rot6d(aa).numpy().reshape(n, -1)


class AMASSDataset:
    """Flat body poses [N, D], D = 63 (axis) or 126 (rot6d), normalized with
    stats computed on the train split and cached beside the data under the
    reference's file names."""

    def __init__(self, root_path: str, version: str = "version0", subset: str = "train",
                 sample_interval: Optional[int] = None, rot_rep: str = "rot6d",
                 return_shape: bool = False, normalize: bool = True, min_max: bool = True):
        if subset not in ("train", "valid", "test") or rot_rep not in ("axis", "rot6d"):
            raise ValueError(f"subset {subset!r} or rot_rep {rot_rep!r} unknown")
        self.root_path = root_path
        self.version = version
        self.subset = subset
        self.rot_rep = rot_rep
        self.return_shape = return_shape
        self.normalize = normalize
        self.min_max = min_max

        self.poses, self.shapes = self._read_data()
        if sample_interval:
            self.poses = self.poses[::sample_interval]
            if self.shapes is not None:
                self.shapes = self.shapes[::sample_interval]
        if self.normalize:
            self._normalize_in_place()

    def _read_data(self, subset: Optional[str] = None
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        data_path = os.path.join(self.root_path, self.version, subset or self.subset)
        poses = np.asarray(_load_tensor_file(os.path.join(data_path, "pose_body.pt")),
                           np.float32)
        shapes = None
        if self.return_shape:
            shapes = np.asarray(_load_tensor_file(os.path.join(data_path, "betas.pt")),
                                np.float32)
        if self.rot_rep == "rot6d":
            poses = _axis_to_rot6d_flat(poses)
        return poses, shapes

    def _stats_path(self) -> str:
        suffix = "_normalize1" if self.min_max else "_normalize2"
        return os.path.join(self.root_path, self.version, "train", self.rot_rep + suffix + ".pt")

    def _load_or_compute_stats(self) -> Dict[str, Optional[np.ndarray]]:
        """The cached train-split stats, or both families computed from the
        train split (the loaded tensor when this is it, with ``ddof=1`` as
        torch.std) and cached as ``.npz`` where no cache exists."""
        path = self._stats_path()
        keys = (("min_poses", "max_poses", "min_shapes", "max_shapes") if self.min_max
                else ("mean_poses", "std_poses", "mean_shapes", "std_shapes"))
        try:
            raw = _load_tensor_file(path)
        except FileNotFoundError:
            raw = None
        if raw is not None:
            out: Dict[str, Optional[np.ndarray]] = {}
            for k in keys:
                v = raw.get(k)
                # absent keys and 0-d NaN placeholders both mean no shape stats
                out[k] = (None if v is None or (np.ndim(v) == 0 and not np.isfinite(v).all())
                          else np.asarray(v, np.float32))
            return out
        if self.subset == "train":
            poses, shapes = self.poses, self.shapes
        else:
            try:
                poses, shapes = self._read_data("train")
            except FileNotFoundError as e:
                raise FileNotFoundError(
                    f"normalization stats missing at {path} and no train split to compute "
                    f"them from ({e})") from None
        minmax_stats = {
            "min_poses": poses.min(0), "max_poses": poses.max(0),
            "min_shapes": shapes.min(0) if shapes is not None else None,
            "max_shapes": shapes.max(0) if shapes is not None else None,
        }
        zscore_stats = {
            "mean_poses": poses.mean(0),
            "std_poses": poses.std(0, ddof=1),
            "mean_shapes": shapes.mean(0) if shapes is not None else None,
            "std_shapes": shapes.std(0, ddof=1) if shapes is not None else None,
        }
        train_dir = os.path.dirname(path)
        for suffix, st in (("_normalize1", minmax_stats), ("_normalize2", zscore_stats)):
            stem = os.path.join(train_dir, self.rot_rep + suffix)
            if not os.path.exists(stem + ".npz") and not os.path.exists(stem + ".pt"):
                np.savez(stem + ".npz", **{k: v for k, v in st.items() if v is not None})
        return minmax_stats if self.min_max else zscore_stats

    def _normalize_in_place(self):
        stats = self._load_or_compute_stats()
        if self.min_max:
            self.min_poses, self.max_poses = stats["min_poses"], stats["max_poses"]
            self.min_shapes, self.max_shapes = stats.get("min_shapes"), stats.get("max_shapes")
            self.poses = 2 * (self.poses - self.min_poses) / (self.max_poses - self.min_poses) - 1
            if self.return_shape and self.min_shapes is not None:
                self.shapes = (2 * (self.shapes - self.min_shapes)
                               / (self.max_shapes - self.min_shapes) - 1)
        else:
            self.mean_poses, self.std_poses = stats["mean_poses"], stats["std_poses"]
            self.mean_shapes, self.std_shapes = stats.get("mean_shapes"), stats.get("std_shapes")
            self.poses = (self.poses - self.mean_poses) / self.std_poses
            if self.return_shape and self.mean_shapes is not None:
                self.shapes = (self.shapes - self.mean_shapes) / self.std_shapes

    def Denormalize(self, poses, shapes=None):
        """Inverse of the normalization (ref AMASS.py:135-181), on torch
        tensors of any device; the identity with ``normalize=False``."""
        if not self.normalize:
            return poses if shapes is None else (poses, shapes)
        poses = torch.as_tensor(poses)

        def t(a, like):
            return torch.as_tensor(a, dtype=like.dtype, device=like.device)

        if self.min_max:
            mn, mx = t(self.min_poses, poses), t(self.max_poses, poses)
            out = 0.5 * ((poses + 1) * (mx - mn) + 2 * mn)
        else:
            out = poses * t(self.std_poses, poses) + t(self.mean_poses, poses)
        if shapes is None:
            return out
        shapes = torch.as_tensor(shapes)
        if self.min_max and self.min_shapes is not None:
            mn, mx = t(self.min_shapes, shapes), t(self.max_shapes, shapes)
            return out, 0.5 * ((shapes + 1) * (mx - mn) + 2 * mn)
        if not self.min_max and self.mean_shapes is not None:
            return out, shapes * t(self.std_shapes, shapes) + t(self.mean_shapes, shapes)
        return out

    def __len__(self):
        return len(self.poses)

    def train_index_batches(self, batch_size: int, seed: int = 0, drop_last: bool = True,
                            skip: int = 0) -> Iterator[np.ndarray]:
        """An endless shuffled stream of int32 row indices, one epoch's
        permutation after another. ``skip`` fast-forwards by that many
        batches: skipped epochs still draw their permutation, so a resumed
        run trains on the rows an uninterrupted one would."""
        rng = np.random.default_rng(seed)
        n = len(self.poses)
        end = n - (n % batch_size) if drop_last else n
        per_epoch = (end + batch_size - 1) // batch_size
        if per_epoch == 0:
            raise ValueError(f"batch_size {batch_size} > dataset size {n} with drop_last: "
                             f"the stream would yield nothing (reduce the batch or the "
                             f"--sample subsampling)")
        for _ in range(skip // per_epoch):
            rng.permutation(n)
        start = (skip % per_epoch) * batch_size
        while True:
            perm = rng.permutation(n)
            for i in range(start, end, batch_size):
                yield perm[i:i + batch_size].astype(np.int32)
            start = 0

    def eval_batches(self, batch_size: int, drop_last: bool = True) -> Iterator[np.ndarray]:
        n = len(self.poses)
        end = n - (n % batch_size) if drop_last else n
        for i in range(0, end, batch_size):
            yield self.poses[i:i + batch_size]
