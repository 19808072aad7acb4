"""The flagship configuration as plain Python.

A copy of the values the port reads from ``configs/default_amass_configs.py``
and ``configs/subvp/amass_scorefc_continuous.py`` (sub-VP continuous
ScoreModelFC). Field names are the same, so code written against the
``ml_collections`` tree reads this one unchanged.
"""
from __future__ import annotations

import importlib.util
from types import SimpleNamespace


def get_config() -> SimpleNamespace:
    training = SimpleNamespace(sde="subvpsde", continuous=True)
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
    return SimpleNamespace(training=training, sampling=sampling, model=model,
                           data=data)


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
