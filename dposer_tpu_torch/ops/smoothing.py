"""Interpolation helpers (ref ``lib/utils/misc.py:58-69``). The temporal
filters of the JAX module are not ported yet."""
from __future__ import annotations

import torch


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
