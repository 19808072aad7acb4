"""The torch port's ScoreModelFC, checkpoint loader and config against the
JAX package, on the same weights and inputs (CPU)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.models import ScoreModelFC as FlaxScoreModelFC
from dposer_tpu.utils.checkpoint import load_params_for_inference as jax_load_params
from dposer_tpu_torch import N_POSES
from dposer_tpu_torch.config import get_config as torch_get_config
from dposer_tpu_torch.models import ScoreModelFC, create_score_model
from dposer_tpu_torch.models.time_embedding import get_timestep_embedding
from dposer_tpu_torch.utils.checkpoint import (load_params_for_inference,
                                               state_dict_from_flax,
                                               torch_parameter_order)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "trained_r5", "axis-zscore-400k-synth.pth")

SMALL = dict(n_poses=21, pose_dim=3, hidden_dim=128, embed_dim=64, n_blocks=2,
             dropout=0.0)


def flax_and_torch(seed=0, **kw):
    """A flax ScoreModelFC with random params and the port's model holding
    the same weights (via state_dict_from_flax)."""
    fm = FlaxScoreModelFC(**kw)
    dim = kw["n_poses"] * kw["pose_dim"]
    params = fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, dim)),
                     jnp.ones((1,)))["params"]
    params = jax.tree.map(np.asarray, params)
    tm = ScoreModelFC(**kw).eval()
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return fm, params, tm


@pytest.mark.parametrize("embedding_type", ["positional", "fourier"])
@pytest.mark.parametrize("scale_by_sigma", [False, True])
def test_forward_matches_flax(embedding_type, scale_by_sigma):
    kw = dict(SMALL, embedding_type=embedding_type, scale_by_sigma=scale_by_sigma)
    fm, params, tm = flax_and_torch(**kw)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 63)).astype(np.float32)
    if embedding_type == "positional":
        t = rng.uniform(0, 999, size=(8,)).astype(np.float32)
    else:
        t = rng.uniform(0.01, 50.0, size=(8,)).astype(np.float32)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    # Fourier features are sin/cos of log(t)*W*2pi with |arg| up to ~800 at
    # scale 16: a 1-ulp difference between XLA's and torch's fp32 log moves
    # the argument by ~1e-4, which the network carries to its output.
    tol = 1e-5 if embedding_type == "positional" else 5e-4
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * np.abs(ref).max())


def test_scalar_time_broadcasts():
    fm, params, tm = flax_and_torch(**SMALL)
    x = np.random.default_rng(2).normal(size=(4, 63)).astype(np.float32)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x), jnp.float32(500.0)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.tensor(500.0)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_timestep_embedding_matches_jax():
    from dposer_tpu.models.time_embedding import get_timestep_embedding as jax_emb

    t = np.linspace(0, 999, 37).astype(np.float32)
    for dim in (64, 65):
        ref = np.asarray(jax_emb(jnp.asarray(t), dim))
        out = get_timestep_embedding(torch.from_numpy(t), dim).numpy()
        # a 1-ulp difference in the fp32 exp of the frequency table (6e-8),
        # times t up to 999, moves the sin/cos argument by up to ~6e-5
        np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.fixture(scope="module")
def pinned():
    if not os.path.exists(CKPT):
        pytest.skip("pinned trained checkpoint not present")
    sd, step = load_params_for_inference(CKPT)
    jparams, jstep = jax_load_params(CKPT)
    return sd, step, jax.tree.map(np.asarray, jparams), jstep


def test_pinned_checkpoint_loads_strict_and_matches_flax(pinned):
    sd, step, jparams, jstep = pinned
    assert step == jstep == 400000
    model = create_score_model(torch_get_config(), n_poses=N_POSES).eval()
    model.load_state_dict(sd, strict=True)
    # the EMA shadow, not the raw weights, went in (ref run/demo.py:114-118)
    np.testing.assert_array_equal(model.pre_dense.weight.detach().numpy(),
                                  jparams["pre_dense"]["kernel"].T)
    fm = FlaxScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=1024,
                          embed_dim=512, n_blocks=2, dropout=0.1)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 63)).astype(np.float32)
    t = rng.uniform(0, 999, size=(8,)).astype(np.float32)
    ref = np.asarray(fm.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_state_dict_from_flax_roundtrips_the_pinned_weights(pinned):
    sd, _, jparams, _ = pinned
    conv = state_dict_from_flax(jparams)
    for name in torch_parameter_order(2):
        if name.startswith("pre_dense_cond"):
            continue
        np.testing.assert_array_equal(conv[name].numpy(), sd[name].numpy(), err_msg=name)
    np.testing.assert_allclose(conv["sigmas"].numpy(), sd["sigmas"].numpy(), rtol=1e-6)


def test_ema_shadow_order_matches_parameters():
    """The shadow list aligns with model.parameters() registration order."""
    model = ScoreModelFC(**dict(SMALL, n_blocks=3))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    assert names == torch_parameter_order(3)


def test_config_matches_ml_collections_config():
    from configs.subvp.amass_scorefc_continuous import get_config

    ref = get_config()
    port = torch_get_config()
    for section, fields in vars(port).items():
        if not hasattr(fields, "__dict__"):  # a top-level value: OUTPUT_DIR, seed
            assert ref[section] == fields, section
            continue
        for field, value in vars(fields).items():
            assert ref[section][field] == value, f"{section}.{field}"
    # every field training reads is in the copy
    for section, names in (("training", ("batch_size", "n_iters", "log_freq", "eval_freq",
                                         "save_freq", "auxiliary_loss", "denoise_steps",
                                         "likelihood_weighting", "reduce_mean")),
                           ("optim", tuple(ref.optim.keys())),
                           ("eval", ("batch_size", "num_samples")),
                           ("DATASET", tuple(ref.DATASET.keys()))):
        assert set(names) <= set(vars(getattr(port, section))), section
    assert (port.training.batch_size, port.training.n_iters, port.eval.batch_size,
            port.training.reduce_mean) == (1280, 400001, 50, True)


def test_import_leaves_jax_out():
    prog = ("import sys; import dposer_tpu_torch.demo, dposer_tpu_torch.ops.cuda.fused_em, "
            "dposer_tpu_torch.ops.cuda.fused_ode, dposer_tpu_torch.ops.cuda.fused_lik, "
            "dposer_tpu_torch.diffusion.likelihood, dposer_tpu_torch.diffusion.ode, "
            "dposer_tpu_torch.ops.smoothing, dposer_tpu_torch.train, "
            "dposer_tpu_torch.ops.cuda.fused_train; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('dposer_tpu.') or m == 'dposer_tpu' or m == 'configs']; "
            "print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", prog], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_package_data_names_the_ports_files():
    """An installed port finds its segmentation asset and can build its
    kernels: pyproject's package-data lists both directories."""
    import glob
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    for package, pattern in (("dposer_tpu_torch", "assets/*"),
                             ("dposer_tpu_torch.ops.cuda", "csrc/*")):
        assert pattern in data[package]
        found = glob.glob(os.path.join(REPO, *package.split("."), pattern))
        assert found, f"{package}: {pattern} matches no file"
