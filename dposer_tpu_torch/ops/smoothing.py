"""Temporal smoothing and interpolation helpers (ref ``lib/utils/misc.py``).
Port of ``dposer_tpu/ops/smoothing.py``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def add_noise(gts: torch.Tensor, std: float = 0.5, noise_type: str = "gaussian",
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Perturb ground truth with gaussian or uniform noise (ref misc.py:11-24)."""
    if std == 0.0:
        return gts
    if noise_type == "gaussian":
        draw = torch.randn
    elif noise_type == "uniform":
        def draw(*a, **k):
            return torch.rand(*a, **k) - 0.5
    else:
        raise NotImplementedError(noise_type)
    return gts + std * draw(gts.shape, generator=generator, device=gts.device,
                            dtype=gts.dtype)


def linear_interpolation(A: torch.Tensor, B: torch.Tensor, frames: int) -> torch.Tensor:
    """Two equal-shaped tensors -> [frames, ...], a linear blend from A to B."""
    alpha = torch.linspace(0.0, 1.0, frames, device=A.device)[:, None]
    return (1 - alpha) * A + alpha * B


def slerp_interpolation(A: torch.Tensor, B: torch.Tensor, frames: int) -> torch.Tensor:
    """Spherical interpolation between two flat latents -> [frames, D]. For
    (anti)parallel inputs, where sin(omega) = 0 would make the slerp weights
    NaN, it degenerates to the linear blend."""
    cos = (A * B).sum() / (torch.linalg.norm(A) * torch.linalg.norm(B))
    omega = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    so = torch.sin(omega)
    if float(so.abs()) < 1e-7:
        return linear_interpolation(A, B, frames)
    alpha = torch.linspace(0.0, 1.0, frames, device=A.device)[:, None]
    return (torch.sin((1 - alpha) * omega) / so) * A + (torch.sin(alpha * omega) / so) * B


def _conv1d_same(data: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """[T, D] filtered along T by a [K] kernel: cross-correlation with K//2
    zeros padded on both sides (torch ``conv1d``'s ``padding=K//2``), so the
    output keeps length T for odd K."""
    out = F.conv1d(data.T[:, None, :], kernel.to(data.dtype)[None, None, :],
                   padding=kernel.shape[0] // 2)
    return out[:, 0, :].T


def moving_average(data: torch.Tensor, window_size: int) -> torch.Tensor:
    """[T, D] boxcar filter along time (ref misc.py:72-81)."""
    return _conv1d_same(data, torch.ones(window_size, device=data.device) / window_size)


def gaussian_smoothing(data: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """[T, D] gaussian filter along time (ref misc.py:84-95), normalised to
    sum 1; no kernel flip, as torch's and XLA's convolutions correlate."""
    offs = torch.arange(window_size, dtype=torch.float32, device=data.device) - window_size // 2
    kernel = torch.exp(-0.5 * (offs / sigma) ** 2)
    return _conv1d_same(data, kernel / kernel.sum())
