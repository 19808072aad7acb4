"""The reference train step: continuous sub-VP denoising score matching on
``scorefc.ScoreFC`` with the training kernels' dropout masks, its gradient by
autograd in float32, the global-norm clip, Adam with a linear warm-up and
the EMA, as the published ``losses.py`` and ``ema.py`` define them.

``operand`` rounds every matmul operand, forward and backward, for a
lower-precision stand-in (``fp8``: float8 e4m3 with a per-tensor scale);
``None`` keeps float32.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import dropout
from .scorefc import ScoreFC, SubVP, dense_names


class _RoundFP8(torch.autograd.Function):
    """Round to float8 e4m3 at a per-tensor scale; the gradient rounded the
    same way on its way back."""

    @staticmethod
    def forward(ctx, x):
        return fp8(x)

    @staticmethod
    def backward(ctx, g):
        return fp8(g)


def fp8(x: torch.Tensor) -> torch.Tensor:
    s = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
    return (x * s).to(torch.float8_e4m3fn).float() / s


class Rounded(ScoreFC):
    """ScoreFC whose every product takes rounded operands."""

    def _dense(self, name, h):
        w = self.w[name + ".weight"]
        return _RoundFP8.apply(h) @ _RoundFP8.apply(w).t() + self.w[name + ".bias"]

    def raw(self, x, labels, probe=None, masks=None):
        h = self.hidden(x, labels, probe, masks)
        return _RoundFP8.apply(h) @ _RoundFP8.apply(self.w["post_dense.weight"]).t() \
            + self.w["post_dense.bias"]


def dsm_loss(net: ScoreFC, sde: SubVP, x0, t, z, masks) -> torch.Tensor:
    """Mean over rows of the mean over dims of ``(score * std + z)^2``, the
    score ``-out / std`` at the perturbed pose ``mean(t) x0 + std(t) z``."""
    lm = -0.25 * t * t * (sde.b1 - sde.b0) - 0.5 * t * sde.b0
    std = 1.0 - torch.exp(2.0 * lm)
    x = torch.exp(lm)[:, None] * x0 + std[:, None] * z
    labels = t * 999.0
    out = net.raw(x, labels, masks=masks) * net.out_scale(labels)[:, None]
    return ((z - out) ** 2).mean(1).mean()


class Trainer:
    """The optimizer's state over ``params`` (float32 leaves by name) and one
    ``step(x0, t, z, dropout_seed)`` at a time."""

    def __init__(self, params: Dict[str, torch.Tensor], model_cfg: dict, sde_cfg: dict,
                 train_cfg: dict, operand: Optional[str] = None):
        self.p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.cfg, self.m = train_cfg, model_cfg
        self.sde = SubVP(sde_cfg)
        self.net = (Rounded if operand == "fp8" else ScoreFC)(self.p, model_cfg)
        self.adam_m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.adam_v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.ema = {k: v.detach().clone() for k, v in self.p.items()}
        self.count = 0
        self.clipped: List[Dict[str, torch.Tensor]] = []

    def masks(self, seed: int, rows: int) -> List[torch.Tensor]:
        keep = 1.0 - float(self.m["dropout"])
        h = int(self.m["hidden_dim"])
        dev = self.p["post_dense.weight"].device
        return [dropout.mask(seed, j, rows, h, keep, dev)
                for j in range(len(dense_names(int(self.m["n_blocks"]))))]

    def step(self, x0, t, z, dropout_seed: int) -> float:
        c = self.cfg
        loss = dsm_loss(self.net, self.sde, x0, t, z, self.masks(dropout_seed, x0.shape[0]))
        grads = torch.autograd.grad(loss, list(self.p.values()), allow_unused=True)
        with torch.no_grad():
            g = {k: torch.zeros_like(v) if gr is None else gr
                 for (k, v), gr in zip(self.p.items(), grads)}
            norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
            if norm >= c["grad_clip"]:
                g = {k: x * (c["grad_clip"] / norm) for k, x in g.items()}
            self.clipped.append(g)
            lr = c["lr"] * min(self.count / c["warmup"], 1.0)
            self.count += 1
            b1, b2 = c["beta1"], c["beta2"]
            bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
            num = self.count
            decay = min(c["ema_rate"], (1.0 + num) / (10.0 + num))
            for k, p in self.p.items():
                self.adam_m[k].mul_(b1).add_((1.0 - b1) * g[k])
                self.adam_v[k].mul_(b2).add_((1.0 - b2) * g[k] * g[k])
                p.sub_(lr * (self.adam_m[k] / bc1) / ((self.adam_v[k] / bc2).sqrt() + c["eps"]))
                self.ema[k].sub_((1.0 - decay) * (self.ema[k] - p))
        return float(loss.detach())
