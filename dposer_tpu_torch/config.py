"""The flagship configuration as plain Python.

A copy of the values the port reads from ``configs/default_amass_configs.py``
and ``configs/subvp/amass_scorefc_continuous.py`` (sub-VP continuous
ScoreModelFC): the model, sampling, data, training, optimizer and eval
fields. Field names are the same, so code written against the
``ml_collections`` tree reads this one unchanged.
"""
from __future__ import annotations

import importlib.util
from types import SimpleNamespace


def get_config() -> SimpleNamespace:
    training = SimpleNamespace(sde="subvpsde", continuous=True, batch_size=1280,
                               n_iters=400001, log_freq=50, eval_freq=50000,
                               save_freq=50000, auxiliary_loss=False, denoise_steps=10,
                               render=False, likelihood_weighting=False,
                               reduce_mean=True)
    sampling = SimpleNamespace(method="pc", predictor="euler_maruyama",
                               corrector="none", snr=0.16, n_steps_each=1,
                               noise_removal=True, probability_flow=False)
    model = SimpleNamespace(type="ScoreModelFC", HIDDEN_DIM=1024,
                            EMBED_DIM=512, N_BLOCKS=2, dropout=0.1,
                            fourier_scale=16, scale_by_sigma=True,
                            ema_rate=0.9999, nonlinearity="swish",
                            embedding_type="positional", sigma_min=0.01,
                            sigma_max=50, num_scales=1000, beta_min=0.1,
                            beta_max=20.0)
    data = SimpleNamespace(rot_rep="axis", normalize=True, min_max=False)
    optim = SimpleNamespace(weight_decay=0, optimizer="Adam", lr=2e-4, beta1=0.9,
                            eps=1e-8, warmup=5000, grad_clip=1.0)
    evaluate = SimpleNamespace(batch_size=50, num_samples=500)
    dataset = SimpleNamespace(TRAIN_DATASET="amass", TEST_DATASET="amass",
                              HYBRID_JOINTS_TYPE="")
    return SimpleNamespace(OUTPUT_DIR="output", DATASET=dataset, training=training,
                           sampling=sampling, model=model, data=data, optim=optim,
                           eval=evaluate, seed=42)


def load_config(path: str | None) -> SimpleNamespace:
    """The flagship config, or ``get_config()`` of the Python file at ``path``."""
    if path is None:
        return get_config()
    spec = importlib.util.spec_from_file_location("_dposer_torch_config", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no config file at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_config()
