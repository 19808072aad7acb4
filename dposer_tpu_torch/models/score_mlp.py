"""ScoreModelFC, the flat-pose score MLP (ref lib/algorithms/advanced/model.py:93-196),
and TimeMLPs, the plain baseline (ref model.py:69-90).

Pre-Linear with a per-layer time projection, GroupNorm(32) + activation +
dropout, ``n_blocks`` residual blocks of two such sub-layers with skip
``h = h + h2``, a post-Linear back to the pose dim, and optional
``/sigma(t)`` output scaling from a geometric sigma table.

Modules are registered under the reference's names and in its order
(``torch_parameter_order`` in ``utils/checkpoint.py``), including the dead
``pre_dense_cond`` layer and the ``sigmas`` buffer, so a reference ``.pth``
loads with ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .time_embedding import GaussianFourierProjection, get_timestep_embedding


def get_sigmas(sigma_min: float, sigma_max: float, num_scales: int) -> np.ndarray:
    """Geometric noise ladder, descending (ref model.py:24-34)."""
    return np.exp(np.linspace(math.log(sigma_max), math.log(sigma_min),
                              num_scales)).astype(np.float32)


def get_act(name: str) -> nn.Module:
    name = name.lower()
    if name == "elu":
        return nn.ELU()
    if name == "relu":
        return nn.ReLU()
    if name == "lrelu":
        return nn.LeakyReLU(negative_slope=0.2)
    if name == "swish":
        return nn.SiLU()
    raise NotImplementedError("activation function does not exist!")


class ScoreModelFC(nn.Module):
    """Flat-pose score MLP with per-block time-feature projections."""

    def __init__(self, n_poses: int = 21, pose_dim: int = 6,
                 hidden_dim: int = 1024, embed_dim: int = 512,
                 n_blocks: int = 2, dropout: float = 0.1,
                 act_name: str = "swish", embedding_type: str = "positional",
                 fourier_scale: float = 16.0, scale_by_sigma: bool = True,
                 sigma_min: float = 0.01, sigma_max: float = 50.0,
                 num_scales: int = 1000):
        super().__init__()
        if embedding_type not in ("positional", "fourier"):
            raise ValueError(f"time embedding type {embedding_type} unknown.")
        self.n_poses = n_poses
        self.pose_dim = pose_dim
        self.hidden_dim = hidden_dim
        self.embed_dim = embed_dim
        self.n_blocks = n_blocks
        self.act_name = act_name
        self.embedding_type = embedding_type
        self.scale_by_sigma = scale_by_sigma
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.num_scales = num_scales
        dim = n_poses * pose_dim

        self.act = get_act(act_name)
        if embedding_type == "fourier":
            self.gauss_proj = GaussianFourierProjection(embed_dim, fourier_scale)
        self.register_buffer("sigmas", torch.from_numpy(
            get_sigmas(sigma_min, sigma_max, num_scales)))

        self.pre_dense = nn.Linear(dim, hidden_dim)
        self.pre_dense_t = nn.Linear(embed_dim, hidden_dim)
        self.pre_dense_cond = nn.Linear(hidden_dim, hidden_dim)  # never used (ref model.py:111)
        self.pre_gnorm = nn.GroupNorm(32, hidden_dim, eps=1e-5)
        self.shared_time_embed = nn.Sequential(nn.Linear(embed_dim, embed_dim),
                                               get_act(act_name))
        for idx in range(n_blocks):
            b = f"b{idx + 1}_"
            setattr(self, b + "dense1", nn.Linear(hidden_dim, hidden_dim))
            setattr(self, b + "dense1_t", nn.Linear(embed_dim, hidden_dim))
            setattr(self, b + "gnorm1", nn.GroupNorm(32, hidden_dim, eps=1e-5))
            setattr(self, b + "dense2", nn.Linear(hidden_dim, hidden_dim))
            setattr(self, b + "dense2_t", nn.Linear(embed_dim, hidden_dim))
            setattr(self, b + "gnorm2", nn.GroupNorm(32, hidden_dim, eps=1e-5))
        self.post_dense = nn.Linear(hidden_dim, dim)
        self.dropout = nn.Dropout(dropout)

    def time_features(self, t: torch.Tensor):
        """(temb after the shared projection, the sigmas used for output scaling)."""
        t = torch.atleast_1d(t)
        if self.embedding_type == "fourier":
            used_sigmas = t
            temb = self.gauss_proj(torch.log(t))
        else:
            used_sigmas = self.sigmas[t.long()]
            temb = get_timestep_embedding(t, self.embed_dim)
        return self.shared_time_embed(temb), used_sigmas

    def forward(self, batch: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """batch: [B, n_poses*pose_dim]; t: [B] or a scalar label time.

        For VP/subVP-continuous models ``t`` is the label ``t_cont * 999``;
        for VE it is the noise sigma.
        """
        temb, used_sigmas = self.time_features(t)
        act = self.act

        h = self.pre_dense(batch) + self.pre_dense_t(temb)
        h = self.dropout(act(self.pre_gnorm(h)))
        for idx in range(self.n_blocks):
            b = f"b{idx + 1}_"
            h1 = getattr(self, b + "dense1")(h) + getattr(self, b + "dense1_t")(temb)
            h1 = self.dropout(act(getattr(self, b + "gnorm1")(h1)))
            h2 = getattr(self, b + "dense2")(h1) + getattr(self, b + "dense2_t")(temb)
            h2 = self.dropout(act(getattr(self, b + "gnorm2")(h2)))
            h = h + h2
        res = self.post_dense(h)
        if self.scale_by_sigma:
            res = res / used_sigmas.reshape((-1, 1))
        return res


class TimeMLPs(nn.Module):
    """The plain time-conditioned MLP baseline (ref model.py:69-90): the
    time label appended to the pose as one more input, ``n_blocks`` hidden
    Linear + activation + dropout layers. Its layers sit in a ``Sequential``
    named ``net`` in the reference's layout (Linears at ``net.0``,
    ``net.{2+3b}`` and ``net.{2+3n}``), so a reference ``.pth`` loads as it
    is. No kernel covers it; it samples on the plain samplers."""

    def __init__(self, n_poses: int = 21, pose_dim: int = 6, hidden_dim: int = 64,
                 n_blocks: int = 2, dropout: float = 0.1, act_name: str = "swish"):
        super().__init__()
        self.n_poses = n_poses
        self.pose_dim = pose_dim
        self.hidden_dim = hidden_dim
        self.n_blocks = n_blocks
        self.act_name = act_name
        dim = n_poses * pose_dim
        layers = [nn.Linear(dim + 1, hidden_dim), get_act(act_name)]
        for _ in range(n_blocks):
            layers += [nn.Linear(hidden_dim, hidden_dim), get_act(act_name), nn.Dropout(dropout)]
        layers.append(nn.Linear(hidden_dim, dim))
        self.net = nn.Sequential(*layers)

    def forward(self, batch: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """batch: [B, n_poses*pose_dim]; t: [B] or a scalar label time."""
        t = torch.as_tensor(t, dtype=batch.dtype, device=batch.device)
        t = torch.atleast_1d(t).expand(batch.shape[0])
        return self.net(torch.cat([batch, t[:, None]], dim=1))


def create_score_model(config, n_poses: int = 21) -> nn.Module:
    """Build the score model a config describes (ref run/train.py:154-174):
    ``ScoreModelFC`` or ``TimeMLPs``."""
    m = config.model
    pose_dim = 3 if config.data.rot_rep == "axis" else 6
    if m.type == "TimeMLPs":
        return TimeMLPs(n_poses=n_poses, pose_dim=pose_dim, hidden_dim=m.HIDDEN_DIM,
                        n_blocks=m.N_BLOCKS, dropout=m.dropout, act_name=m.nonlinearity)
    if m.type != "ScoreModelFC":
        raise NotImplementedError(f"unsupported model {m.type!r}")
    return ScoreModelFC(
        n_poses=n_poses,
        pose_dim=pose_dim,
        hidden_dim=m.HIDDEN_DIM, embed_dim=m.EMBED_DIM, n_blocks=m.N_BLOCKS,
        dropout=m.dropout, act_name=m.nonlinearity,
        embedding_type=m.embedding_type,
        fourier_scale=getattr(m, "fourier_scale", 16.0),
        scale_by_sigma=m.scale_by_sigma, sigma_min=m.sigma_min,
        sigma_max=m.sigma_max, num_scales=m.num_scales)
