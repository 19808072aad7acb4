"""The plain reference of DPoser's score network and its sub-VP SDE, in float32.

ScoreModelFC as published (moonbow721/DPoser, ``lib/algorithms/advanced/
model.py``; arXiv 2312.05541): a pre-Linear plus a per-layer projection of the
time embedding, GroupNorm(32) and SiLU, ``n_blocks`` residual blocks of two such
layers, a post-Linear back to the pose, and the output divided by
``sigmas[long(t * 999)]`` of a geometric ladder. Dropout is off when sampling.
The sub-VP SDE with its non-square-root "std" as in the published
``sde_lib.py``.

Plain PyTorch only: it imports nothing of the program. It reads the weights
from a dict of float32 tensors under the model's parameter names, which the
harness makes from the seed and hands to both sides. Matrix products run in
float32 with TF32 off (``no_tf32``). ``Quant`` emulates a W8A8 (or W4A4)
forward exactly: SmoothQuant's per-channel fold, per-column weight scales,
static activation ranges, integer sums in float64.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def no_tf32() -> None:
    """float32 products in float32 on the card, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dense_names(n_blocks: int) -> List[str]:
    """The hidden layers in network order: pre, then each block's two."""
    return ["pre_dense"] + [f"b{b + 1}_dense{d}" for b in range(n_blocks) for d in (1, 2)]


def gnorm_names(n_blocks: int) -> List[str]:
    return ["pre_gnorm"] + [f"b{b + 1}_gnorm{d}" for b in range(n_blocks) for d in (1, 2)]


def sigma_ladder(sigma_min: float, sigma_max: float, num_scales: int) -> torch.Tensor:
    """The geometric output-scale ladder, descending, in float64 then float32."""
    return torch.from_numpy(np.exp(np.linspace(math.log(sigma_max), math.log(sigma_min),
                                               num_scales)).astype(np.float32))


def timestep_embedding(labels: torch.Tensor, dim: int, max_positions: int = 10000):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=labels.device)
                      * -(math.log(max_positions) / (half - 1)))
    emb = labels.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)


def group_norm(h: torch.Tensor, gamma, beta, groups: int = 32, eps: float = 1e-5):
    b, c = h.shape
    g = h.reshape(b, groups, c // groups)
    mean = g.mean(-1, keepdim=True)
    var = ((g - mean) ** 2).mean(-1, keepdim=True)
    return ((g - mean) / torch.sqrt(var + eps)).reshape(b, c) * gamma + beta


# ---------------------------------------------------------------------------
# W8A8 / W4A4 emulation
# ---------------------------------------------------------------------------

@dataclass
class Quant:
    """Integer hidden layers: per input channel ``inv`` (the activation
    quantizer's row, after the fold), integer weights ``wq`` [in, out] and the
    rescale row ``deq`` [out]. ``levels`` is 127 for int8, 7 for int4."""
    inv: Dict[str, torch.Tensor]
    wq: Dict[str, torch.Tensor]
    deq: Dict[str, torch.Tensor]
    levels: int

    @classmethod
    def per_channel(cls, w: Weights, amax: List[np.ndarray], n_blocks: int,
                    levels: int = 127, alpha: float = 0.5) -> "Quant":
        """SmoothQuant's fold of each hidden layer's per-channel input range
        ``amax[k]`` into its weight (``s_k = amax_k^a / wmax_k^(1-a)``, geometric
        mean 1), then symmetric per-output-column weights and one per-tensor
        range for the folded input, in float64 as published."""
        inv, wq, deq = {}, {}, {}
        for k, name in enumerate(dense_names(n_blocks)):
            wf = w[name + ".weight"].detach().double().cpu().numpy().T  # [in, out]
            a = np.asarray(amax[k], np.float64)
            wmax = np.abs(wf).max(axis=1)
            ok = (a > 0) & (wmax > 0)
            s = np.ones_like(a)
            s[ok] = a[ok] ** alpha / wmax[ok] ** (1.0 - alpha)
            s /= np.exp(np.log(s[ok]).mean()) if ok.any() else 1.0
            amax_t = float((a / s).max())
            folded = torch.from_numpy((s[:, None] * wf).astype(np.float32))
            col = folded.abs().amax(0) / levels
            q = torch.clamp(torch.round(folded / torch.clamp(col, min=1e-30)), -levels, levels)
            dev = w[name + ".weight"].device
            inv[name] = torch.from_numpy((levels / (s * amax_t)).astype(np.float32)).to(dev)
            wq[name] = q.double().to(dev)
            deq[name] = (col * float(np.float32(amax_t / levels))).to(dev)
        return cls(inv, wq, deq, levels)

    def matmul(self, name: str, h: torch.Tensor) -> torch.Tensor:
        aq = torch.clamp(torch.round(h * self.inv[name]), -self.levels, self.levels)
        return (aq.double() @ self.wq[name]).float() * self.deq[name]


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------

class ScoreFC:
    """``forward(x [B, D], labels [B]) -> out [B, D]``, the output divided by
    its sigma. ``quant`` makes the hidden layers integer; ``probe`` (a list)
    receives every hidden matmul's input and the head's, for calibration."""

    def __init__(self, w: Weights, model_cfg: dict, quant: Optional[Quant] = None):
        self.w = w
        self.n_blocks = int(model_cfg["n_blocks"])
        self.embed_dim = int(model_cfg["embed_dim"])
        self.quant = quant
        dev = w["post_dense.weight"].device
        self.sigmas = sigma_ladder(model_cfg["sigma_min"], model_cfg["sigma_max"],
                                   int(model_cfg["num_scales"])).to(dev)

    def _dense(self, name: str, h: torch.Tensor) -> torch.Tensor:
        if self.quant is not None:
            return self.quant.matmul(name, h) + self.w[name + ".bias"]
        return F.linear(h, self.w[name + ".weight"], self.w[name + ".bias"])

    def time_projections(self, labels: torch.Tensor) -> List[torch.Tensor]:
        w = self.w
        temb = F.silu(F.linear(timestep_embedding(labels, self.embed_dim),
                               w["shared_time_embed.0.weight"], w["shared_time_embed.0.bias"]))
        return [F.linear(temb, w[n + "_t.weight"], w[n + "_t.bias"])
                for n in dense_names(self.n_blocks)]

    def hidden(self, x: torch.Tensor, labels: torch.Tensor, probe: Optional[list] = None,
               masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """The last hidden state. ``masks`` (one [B, H] factor a layer, in
        network order) applies dropout."""
        proj = self.time_projections(labels)
        dn, gn = dense_names(self.n_blocks), gnorm_names(self.n_blocks)

        def layer(j, h):
            if probe is not None:
                probe.append(h)
            out = F.silu(group_norm(self._dense(dn[j], h) + proj[j], self.w[gn[j] + ".weight"],
                                    self.w[gn[j] + ".bias"]))
            return out if masks is None else out * masks[j]

        h = layer(0, x)
        for b in range(self.n_blocks):
            h = h + layer(2 + 2 * b, layer(1 + 2 * b, h))
        if probe is not None:
            probe.append(h)
        return h

    def raw(self, x, labels, probe=None, masks=None) -> torch.Tensor:
        """The post-Linear's output, before the sigma scaling."""
        return F.linear(self.hidden(x, labels, probe, masks), self.w["post_dense.weight"],
                        self.w["post_dense.bias"])

    def out_scale(self, labels: torch.Tensor) -> torch.Tensor:
        return 1.0 / self.sigmas[labels.long()]

    def forward(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return self.raw(x, labels) * self.out_scale(labels)[:, None]


# ---------------------------------------------------------------------------
# The sub-VP SDE
# ---------------------------------------------------------------------------

class SubVP:
    """The sub-VP SDE on t in [0, 1] with ``N`` reverse steps; scalars in
    float64."""

    def __init__(self, sde_cfg: dict):
        self.b0, self.b1 = float(sde_cfg["beta_min"]), float(sde_cfg["beta_max"])
        self.N = int(sde_cfg["num_scales"])

    def grid(self, eps: float) -> torch.Tensor:
        """The reverse time grid ``linspace(1, eps, N)`` in float32, with
        ``jnp.linspace``'s arithmetic (the published grid's values)."""
        div = self.N - 1
        s = torch.arange(div, dtype=torch.float32) / float(div)
        one, e = torch.tensor(1.0), torch.tensor(eps, dtype=torch.float32)
        return torch.cat([one * (1 - s) + e * s, e[None]])

    def log_mean(self, t: float) -> float:
        return -0.25 * t * t * (self.b1 - self.b0) - 0.5 * t * self.b0

    def mean_coef(self, t: float) -> float:
        return math.exp(self.log_mean(t))

    def std(self, t: float) -> float:
        """The published sub-VP "std", ``1 - exp(2 * log_mean)`` (no root)."""
        return 1.0 - math.exp(2.0 * self.log_mean(t))

    def beta(self, t: float) -> float:
        return self.b0 + t * (self.b1 - self.b0)

    def g2(self, t: float) -> float:
        return self.beta(t) * (1.0 - math.exp(-2.0 * self.b0 * t - (self.b1 - self.b0) * t * t))

    def em_step(self, out: torch.Tensor, x: torch.Tensor, t: float, z: torch.Tensor,
                out_scale_twice: float = 1.0):
        """One reverse Euler-Maruyama step from ``x`` given the network's
        output ``out`` (already divided by sigma): ``(x_new, x_mean,
        model_term)``, the model term ``-g^2 score dt`` of x_mean."""
        dt = -1.0 / self.N
        model_term = (self.g2(t) / self.std(t) * dt * out_scale_twice) * out
        x_mean = (1.0 - 0.5 * self.beta(t) * dt) * x + model_term
        x_new = x_mean + math.sqrt(self.g2(t)) * math.sqrt(1.0 / self.N) * z
        return x_new, x_mean, model_term
