"""Sample-quality metrics (ref lib/utils/metric.py)."""
from __future__ import annotations

import torch


def average_pairwise_distance(joints3d: torch.Tensor) -> torch.Tensor:
    """APD over a batch of joint sets [B, J, 3] (ref metric.py:8-37): the
    mean over ordered pairs (i != j) of the mean per-joint euclidean distance."""
    b = joints3d.shape[0]
    diff = joints3d[:, None] - joints3d[None, :]  # [B, B, J, 3]
    d = torch.sqrt(torch.clamp(torch.sum(diff ** 2, dim=-1), min=1e-24))
    pair = d.mean(-1)
    return (pair.sum() - torch.trace(pair)) / (b * (b - 1))
