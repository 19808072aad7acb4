"""Completion masks over flat pose vectors (ref ``lib/utils/misc.py:27-55``).

Port of ``dposer_tpu/utils/masks.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import N_POSES
from ..body_model.part_indices import BodyPartIndices


def part_mask_indices(part: str, rot_n: int) -> np.ndarray:
    """Flat-dim indices masked out (to be completed) for a body part."""
    joints = np.asarray(getattr(BodyPartIndices, part))
    return (joints[:, None] * rot_n + np.arange(rot_n)[None, :]).reshape(-1)


def create_mask(body_poses: torch.Tensor, part: str = "legs",
                observation_type: str = "noise",
                mean_observation: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                fill: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mask, observation)`` for completion of ``body_poses`` [B, D].

    ``mask == 1`` marks observed dims. The masked (to-complete) dims of the
    observation are filled with N(0, 1) noise drawn from ``generator`` or
    with a supplied mean pose; ``fill`` [B, len(idx)] injects the fill itself.
    """
    if body_poses.ndim != 2 or body_poses.shape[1] % N_POSES:
        raise ValueError(f"body_poses must be [B, {N_POSES}*rot_n], got "
                         f"{tuple(body_poses.shape)}")
    rot_n = body_poses.shape[1] // N_POSES
    if rot_n not in (3, 6):
        raise ValueError(f"rotation width {rot_n} is neither axis-angle nor 6d")
    idx = torch.as_tensor(part_mask_indices(part, rot_n), device=body_poses.device)
    n = body_poses.shape[0]
    if fill is None:
        if observation_type == "noise":
            fill = torch.randn((n, len(idx)), generator=generator,
                               device=body_poses.device, dtype=body_poses.dtype)
        elif observation_type == "mean":
            if mean_observation is None:
                raise ValueError("mean_observation required for observation_type='mean'")
            fill = mean_observation[idx].expand(n, len(idx))
        else:
            raise NotImplementedError(observation_type)
    mask = torch.ones_like(body_poses)
    mask[:, idx] = 0.0
    observation = body_poses.clone()
    observation[:, idx] = fill.to(body_poses.dtype)
    return mask, observation
