"""What the harness makes from ``--seed`` and hands alike to the program and
to the reference: the weights, the poses, and the seeds of each request.

The weights are one normal draw on the device, cut into the model's
parameters (weights and biases at PyTorch's default scale, ``1 / sqrt(3 *
fan_in)``; GroupNorm scales around 1). The poses are a 64-component
correlated mixture over 21 axis-angle joints with mocap-like magnitudes, the
synthetic AMASS that the repository's data generator describes, drawn on the
device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def derive(seed: int, *words: int) -> int:
    """A 63-bit seed for one use of ``seed`` (``words`` name the use)."""
    w = np.random.SeedSequence([int(seed) & (2 ** 64 - 1)] + [int(x) for x in words])
    a, b = (int(v) for v in w.generate_state(2, np.uint32))
    return (a << 31) ^ b


def generator(seed: int, *words: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *words))


def parameter_shapes(m: dict) -> List[Tuple[str, tuple, int]]:
    """``(name, shape, fan_in)`` of every parameter of ScoreModelFC under the
    published parameter names (0 fan-in: a GroupNorm row)."""
    d = int(m["n_poses"]) * int(m["pose_dim"])
    h, e = int(m["hidden_dim"]), int(m["embed_dim"])
    out = []

    def linear(name, fan_in, fan_out):
        out.extend([(name + ".weight", (fan_out, fan_in), fan_in), (name + ".bias", (fan_out,),
                                                                     fan_in)])

    linear("pre_dense", d, h)
    linear("pre_dense_t", e, h)
    linear("pre_dense_cond", h, h)
    out.extend([("pre_gnorm.weight", (h,), 0), ("pre_gnorm.bias", (h,), 0)])
    linear("shared_time_embed.0", e, e)
    for b in range(int(m["n_blocks"])):
        for j in (1, 2):
            linear(f"b{b + 1}_dense{j}", h, h)
            linear(f"b{b + 1}_dense{j}_t", e, h)
            out.extend([(f"b{b + 1}_gnorm{j}.weight", (h,), 0),
                        (f"b{b + 1}_gnorm{j}.bias", (h,), 0)])
    linear("post_dense", h, d)
    return out


@torch.no_grad()
def make_weights(model_cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's float32 parameters from ``seed``: one draw on the device."""
    shapes = parameter_shapes(model_cfg)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=generator(seed, 1, device=device), device=device)
    out, at = {}, 0
    for name, shape, fan_in in shapes:
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        at += n
        if fan_in:
            out[name] = v * (1.0 / math.sqrt(3.0 * fan_in))
        elif name.endswith(".weight"):
            out[name] = 1.0 + 0.1 * v
        else:
            out[name] = 0.1 * v
    return out


@torch.no_grad()
def pose_mixture(seed: int, n: int, dim: int, device, components: int = 64,
                 rank: int = 8) -> torch.Tensor:
    """``n`` poses [n, dim] of the synthetic mixture: 64 centres (0.5 N(0, 1),
    scaled per dim by U(0.2, 1)), Dirichlet(2) weights, a rank-8 correlated
    part (0.12 N(0, 1) basis) and 0.05 isotropic jitter."""
    g = generator(seed, 2, device=device)
    centres = 0.5 * torch.randn(components, dim, generator=g, device=device)
    centres *= 0.2 + 0.8 * torch.rand(1, dim, generator=g, device=device)
    weights = np.random.default_rng(derive(seed, 3)).dirichlet(np.full(components, 2.0))
    comp = torch.multinomial(torch.as_tensor(weights, dtype=torch.float32, device=device), n,
                             replacement=True, generator=g)
    basis = 0.12 * torch.randn(rank, dim, generator=g, device=device)
    lat = torch.randn(n, rank, generator=g, device=device)
    return centres[comp] + lat @ basis + 0.05 * torch.randn(n, dim, generator=g, device=device)


class Reservoir:
    """A uniform sample of ``size`` of the requests a window finished, drawn
    from the seed as they finish (Algorithm R), so the outputs of the rest
    need not be kept."""

    def __init__(self, size: int, seed: int):
        self.size, self.items = size, []
        self.rng = np.random.default_rng(derive(seed, 20))

    def offer(self, i: int, item) -> None:
        if len(self.items) < self.size:
            self.items.append((i, item))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.size:
                self.items[j] = (i, item)
