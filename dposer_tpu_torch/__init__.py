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
- ``dposer_tpu_torch.diffusion.losses``: the DSM, SMLD and DDPM losses,
  Adam with warmup and the global-norm clip, the train step; ``ema``.
- ``dposer_tpu_torch.tasks``: the DPoser prior loss, the completion
  solver (``DPoserComp``), motion denoising (``MotionDenoise``) and SMPLify
  mesh fitting (``SMPLify`` with the ``DPoser`` prior).
- ``dposer_tpu_torch.ops.cuda``: hand-written Hopper kernels for the fused
  reverse-diffusion loop, the completion solver's Adam loop, the RK4 PF-ODE
  sampler, the likelihood with its forward-mode tangent and the DSM train
  step's forward and backward, each beside its plain PyTorch version.
- ``dposer_tpu_torch.data``, ``body_model``, ``ops.metrics``, ``ops.rotations``,
  ``utils``: the AMASS dataset, the pose normalizer, the HumanEva splitter,
  the HMR image preprocessing and ``MocapDataset``, the SMPL / SMPL-H /
  SMPL-X body model with the 49-joint ``SMPLXFit`` and the fitting losses,
  APD, the completion ``Evaler`` and the PA-MPJPE, rotation conversions,
  checkpoints, completion masks, logging and step timing; ``ops.smoothing``:
  the temporal filters and linear and spherical interpolation.
- ``dposer_tpu_torch.parallel``: a device mesh of the port's own, over which
  the kernel samplers, the completion solver, the RK4 sampler and the
  likelihood shard their rows (``mesh=``), and multi-process evaluation.

Entry points: ``python -m dposer_tpu_torch.demo --task
generation|completion|completion2|interpolation``, ``python -m
dposer_tpu_torch.train``, ``python -m dposer_tpu_torch.bench``, ``python -m
dposer_tpu_torch.completion``, ``python -m dposer_tpu_torch.motion_denoising``
and ``python -m dposer_tpu_torch.fitting``.
The package imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"

N_POSES = 21  # SMPL-X body joints modelled by the pose prior (ref lib/dataset/AMASS.py:9)
