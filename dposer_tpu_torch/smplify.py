"""SMPLify's library entry (ref ``run/smplify.py``): the engines live in
``dposer_tpu_torch.tasks.smplify``; this module builds the DPoser prior from
CLI-style arguments and holds the fitting CLIs' shared set-up. Port of
``run/smplify.py`` and the parts of ``run/common.py`` the fitting CLIs use.

    from dposer_tpu_torch.smplify import DPoser, SMPLify, build_dposer_prior
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .config import load_config
from .data import PoseNormalizer
from .demo import load_model
from .diffusion.score_fn import get_score_fn
from .diffusion.sde import build_sde
from .tasks.smplify import DPoser, SMPLify

__all__ = ["DPoser", "SMPLify", "build_dposer_prior", "build_normalizer", "cli_device",
           "load_model_for_inference", "sequence_generator"]


def cli_device(name: str) -> torch.device:
    """``--device``: the card unless the caller asks for the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device


def sequence_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of sequence (or batch) ``index``, keyed by (``seed``,
    ``index``): its draws do not depend on which others run beside it."""
    s = int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


def load_model_for_inference(config, ckpt_path: str, sde_N=None, device="cuda"):
    """``(model, sde, score_fn)``: the checkpoint's EMA weights in the
    config's fp32 ScoreModelFC in eval mode, the config's SDE at ``sde_N``
    steps, and the score function over the model (ref run/common.py)."""
    model, step = load_model(config, ckpt_path, device)
    print(f"=> loaded checkpoint '{ckpt_path}' (step {step})")
    sde = build_sde(config, N=sde_N)
    return model, sde, get_score_fn(sde, model, continuous=config.training.continuous)


def build_normalizer(config, dataset_folder: str, version: str, stats_dir=None,
                     device="cuda") -> PoseNormalizer:
    """The normalizer over ``stats_dir``, by default the train split's stats
    ``<dataset_folder>/<version>/train``."""
    return PoseNormalizer(stats_dir or os.path.join(dataset_folder, version, "train"),
                          normalize=config.data.normalize, min_max=config.data.min_max,
                          rot_rep=config.data.rot_rep, device=device)


def build_dposer_prior(args, batch_size: int = 1, device=None) -> DPoser:
    """The DPoser prior from ``args`` (``config_path``, ``ckpt_path``,
    ``sde_N``, ``dataset_folder``, ``version``, ``stats_dir``, ``device``),
    as ref run/smplify.py:17-67 builds it, on ``device`` when given (a
    shard's); ``config_path`` None is the flagship config."""
    device = cli_device(args.device) if device is None else torch.device(device)
    config = load_config(args.config_path)
    _, sde, score_fn = load_model_for_inference(config, args.ckpt_path, args.sde_N, device)
    normalizer = build_normalizer(config, args.dataset_folder, args.version,
                                  getattr(args, "stats_dir", None), device)
    return DPoser(sde, score_fn, normalizer, batch_size=batch_size, device=device)
