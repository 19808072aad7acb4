"""DPoser in PyTorch + CUDA for one NVIDIA H100 (sm_90a).

The port of ``dposer_tpu`` (JAX/Pallas on a TPU), module for module:

- ``dposer_tpu_torch.models``: ScoreModelFC (``nn.Module``) with the
  reference's torch parameter names, so its ``.pth`` checkpoints load with
  ``load_state_dict(strict=True)``.
- ``dposer_tpu_torch.diffusion``: VP/subVP/VE SDEs, the score adapter, the
  plain predictor-corrector loop, the tabled fast sampler (with masked
  imputation), the few-step samplers (DDIM, DPM-Solver++, hybrid), the
  adaptive RK45 and fixed-grid RK4 probability-flow-ODE samplers and the
  exact likelihood in bits/dim.
- ``dposer_tpu_torch.tasks``: the DPoser prior loss and the completion
  solver (``DPoserComp``).
- ``dposer_tpu_torch.ops.cuda``: hand-written Hopper kernels for the fused
  reverse-diffusion loop, the completion solver's Adam loop, the RK4 PF-ODE
  sampler and the likelihood with its forward-mode tangent, each beside its
  plain PyTorch version.
- ``dposer_tpu_torch.data``, ``body_model``, ``ops.metrics``, ``utils``: the
  pose normalizer, the SMPL / SMPL-H / SMPL-X body model, APD and the
  completion ``Evaler``, checkpoints and completion masks; ``ops.smoothing``:
  linear and spherical interpolation.

Entry point: ``python -m dposer_tpu_torch.demo --task
generation|completion|completion2|interpolation``.
The package imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"

N_POSES = 21  # SMPL-X body joints modelled by the pose prior (ref lib/dataset/AMASS.py:9)
