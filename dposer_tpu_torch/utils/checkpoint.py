"""Reference-schema checkpoints for the torch ScoreModelFC and TimeMLPs.

A reference ``.pth`` is ``{model_state_dict, optimizer_state_dict, epoch,
step, ema: {decay, num_updates, shadow_params}}`` (ref run/train.py:395-401).
The port's module uses the reference's parameter names, so the state dict
loads as it is; the EMA ``shadow_params`` list is aligned by
``torch_parameter_order`` (``time_mlps_parameter_order`` for a TimeMLPs
checkpoint, whose keys start with ``net.``). ``state_dict_from_flax`` maps a JAX parameter
pytree (as numpy) into the same state dict, for cross-framework tests.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..models.score_mlp import get_sigmas


def torch_parameter_order(n_blocks: int = 2) -> List[str]:
    """ScoreModelFC parameter names in ``model.parameters()`` order,
    ``requires_grad`` only — the alignment of EMA ``shadow_params``.
    A Fourier model's ``gauss_proj.W`` takes no gradient and is not listed."""
    prefixes = ["pre_dense", "pre_dense_t", "pre_dense_cond", "pre_gnorm",
                "shared_time_embed.0"]
    for idx in range(n_blocks):
        prefixes += [f"b{idx + 1}_{sub}" for sub in
                     ("dense1", "dense1_t", "gnorm1", "dense2", "dense2_t", "gnorm2")]
    prefixes.append("post_dense")
    return [f"{p}.{leaf}" for p in prefixes for leaf in ("weight", "bias")]


def time_mlps_parameter_order(n_blocks: int = 2) -> List[str]:
    """TimeMLPs parameter names in ``model.parameters()`` order: the
    Linears of its ``net`` at 0, 2 + 3b and 2 + 3n (ref model.py:69-90)."""
    idx = [0] + [2 + 3 * b for b in range(n_blocks)] + [2 + 3 * n_blocks]
    return [f"net.{i}.{leaf}" for i in idx for leaf in ("weight", "bias")]


def _n_blocks(state_dict: Dict[str, Any]) -> int:
    return sum(1 for k in state_dict if re.fullmatch(r"b\d+_dense1\.weight", k))


def _parameter_order(state_dict: Dict[str, Any]) -> List[str]:
    """The EMA shadow's alignment for the model whose state dict this is."""
    if "net.0.weight" in state_dict:
        linears = sum(1 for k in state_dict if re.fullmatch(r"net\.\d+\.weight", k))
        return time_mlps_parameter_order(linears - 2)
    return torch_parameter_order(_n_blocks(state_dict))


def load_params_for_inference(path: str, use_ema: bool = True
                              ) -> Tuple[Dict[str, torch.Tensor], int]:
    """(state dict, training step) of a reference ``.pth``: the EMA shadow
    params when present and ``use_ema`` (ref run/demo.py:114-118)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = dict(ckpt["model_state_dict"])
    ema = ckpt.get("ema")
    if use_ema and ema is not None:
        order = _parameter_order(state_dict)
        shadow = ema["shadow_params"]
        if len(shadow) != len(order):
            raise ValueError(f"EMA shadow length {len(shadow)} != expected "
                             f"{len(order)}")
        for name, tensor in zip(order, shadow):
            if tuple(tensor.shape) != tuple(state_dict[name].shape):
                raise ValueError(f"EMA shadow for {name} has shape "
                                 f"{tuple(tensor.shape)}, model has "
                                 f"{tuple(state_dict[name].shape)}")
            state_dict[name] = tensor
    return state_dict, int(ckpt.get("step", 0))


def state_dict_from_flax(params: Dict[str, Any], sigma_min: float = 0.01,
                         sigma_max: float = 50.0, num_scales: int = 1000
                         ) -> Dict[str, torch.Tensor]:
    """JAX ScoreModelFC or TimeMLPs params (numpy leaves) -> the port's full
    state dict.

    Dense ``kernel`` [in, out] becomes ``weight`` [out, in]; GroupNorm
    ``scale`` becomes ``weight``. The dead ``pre_dense_cond`` layer is
    zero-filled and the ``sigmas`` buffer recomputed, so the result loads
    with ``strict=True``. TimeMLPs' ``dense_in``, ``dense_{b}`` and
    ``dense_out`` become ``net.0``, ``net.{2+3b}`` and ``net.{2+3n}``.
    """
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))

    if "dense_in" in params:
        n_blocks = len(params) - 2
        names = (["dense_in"] + [f"dense_{b}" for b in range(n_blocks)] + ["dense_out"])
        for name, key in zip(names, time_mlps_parameter_order(n_blocks)[::2]):
            prefix = key.rsplit(".", 1)[0]
            put(f"{prefix}.weight", np.asarray(params[name]["kernel"]).T)
            put(f"{prefix}.bias", params[name]["bias"])
        return sd

    for name, leaves in params.items():
        prefix = "shared_time_embed.0" if name == "shared_time_embed_0" else name
        if name == "gauss_proj":
            put("gauss_proj.W", leaves["W"])
        elif "gnorm" in name:
            put(f"{prefix}.weight", leaves["scale"])
            put(f"{prefix}.bias", leaves["bias"])
        else:
            put(f"{prefix}.weight", np.asarray(leaves["kernel"]).T)
            put(f"{prefix}.bias", leaves["bias"])
    hidden = sd["pre_dense.weight"].shape[0]
    sd["pre_dense_cond.weight"] = torch.zeros(hidden, hidden)
    sd["pre_dense_cond.bias"] = torch.zeros(hidden)
    sd["sigmas"] = torch.from_numpy(get_sigmas(sigma_min, sigma_max, num_scales))
    return sd


# ---------------------------------------------------------------------------
# Training checkpoints
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, state, epoch: int = 0) -> None:
    """Write a train state (``diffusion.losses.TrainState``) as a reference
    ``.pth``: ``{model_state_dict, optimizer_state_dict, epoch, step, ema:
    {decay, num_updates, shadow_params}}`` (ref run/train.py:395-401), on the
    CPU. A disabled EMA counter (negative) is stored as None, as the
    reference stores ``use_num_updates=False``."""
    def cpu(obj):
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu().clone()
        if isinstance(obj, dict):
            return {k: cpu(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(cpu(v) for v in obj)
        return obj

    ema = state.ema
    torch.save({
        "model_state_dict": cpu(state.model.state_dict()),
        "optimizer_state_dict": cpu(state.tx.state_dict()),
        "epoch": int(epoch),
        "step": int(state.step),
        "ema": {"decay": float(ema.decay),
                "num_updates": None if ema.num_updates < 0 else int(ema.num_updates),
                "shadow_params": [cpu(s) for s in ema.shadow_params]},
    }, path)


def restore_train_state(path: str, state) -> Dict[str, Any]:
    """Load a ``.pth`` into ``state`` in place and return what it held.

    A checkpoint this package wrote comes back whole: parameters, Adam's
    moments and count, the EMA and the step. A reference or JAX-exported
    ``.pth`` has no optimizer state: then the parameters, the EMA and the
    step are taken and Adam starts fresh (ref run/train.py:179-192), and a
    ``None`` EMA counter becomes -1 (the warm-up stays off)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model = state.model
    model.load_state_dict(ckpt["model_state_dict"])
    state.step = int(ckpt.get("step", 0))
    ema = ckpt.get("ema")
    if ema is not None:
        shadow = ema["shadow_params"]
        if len(shadow) != len(state.ema.shadow_params):
            raise ValueError(f"EMA shadow length {len(shadow)} != "
                             f"{len(state.ema.shadow_params)} trainable parameters")
        for dst, src in zip(state.ema.shadow_params, shadow):
            dst.copy_(src)
        state.ema.num_updates = -1 if ema["num_updates"] is None else int(ema["num_updates"])
        state.ema.decay = float(ema["decay"])
    else:
        for dst, p in zip(state.ema.shadow_params, state.tx.params):
            dst.copy_(p.detach())
    opt = ckpt.get("optimizer_state_dict")
    if opt is not None:
        state.tx.load_state_dict(opt)
    return dict(step=state.step, optimizer_restored=opt is not None,
                ema_restored=ema is not None)
