"""The system under test, built from a configuration: the port's ScoreModelFC
on the harness's weights and its sub-VP SDE. The only module of the harness
besides the drivers that imports the port."""
from __future__ import annotations

from typing import Dict

import torch


def build_model(config: dict, weights: Dict[str, torch.Tensor], device, train: bool = False):
    """The port's ScoreModelFC as ``config["model"]`` states it, its
    parameters copied from ``weights`` (the harness's own tensors stay
    apart from the program's)."""
    from dposer_tpu_torch.models.score_mlp import ScoreModelFC

    m = config["model"]
    with torch.device(device):
        model = ScoreModelFC(n_poses=m["n_poses"], pose_dim=m["pose_dim"],
                             hidden_dim=m["hidden_dim"], embed_dim=m["embed_dim"],
                             n_blocks=m["n_blocks"], dropout=m["dropout"],
                             act_name=m["nonlinearity"], embedding_type=m["embedding_type"],
                             scale_by_sigma=m["scale_by_sigma"], sigma_min=m["sigma_min"],
                             sigma_max=m["sigma_max"], num_scales=m["num_scales"])
    model.to(device)  # the sigma ladder is built on the host
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if unexpected or set(missing) != {"sigmas"}:
        raise ValueError(f"the weights do not fit the model: missing {missing}, "
                         f"unexpected {unexpected}")
    return model.train(train)


def build_sde(config: dict):
    from dposer_tpu_torch.diffusion.sde import SubVPSDE

    s = config["sde"]
    if s["type"] != "subvpsde":
        raise NotImplementedError(f"sde {s['type']!r}")
    return SubVPSDE(beta_0=s["beta_min"], beta_1=s["beta_max"], N=s["num_scales"])


def draw_seed_value(generator: torch.Generator) -> int:
    """The one-element Philox seed a kernel loop draws from its generator at a
    call's start, as that loop draws it: ``randint(0, 2**62, (1,))``."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
