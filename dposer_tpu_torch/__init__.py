"""DPoser in PyTorch + CUDA for one NVIDIA H100 (sm_90a).

The port of ``dposer_tpu`` (JAX/Pallas on a TPU), module for module:

- ``dposer_tpu_torch.models``: ScoreModelFC (``nn.Module``) with the
  reference's torch parameter names, so its ``.pth`` checkpoints load with
  ``load_state_dict(strict=True)``.
- ``dposer_tpu_torch.diffusion``: VP/subVP/VE SDEs, the score adapter, the
  plain predictor-corrector loop and the tabled fast sampler.
- ``dposer_tpu_torch.ops.cuda``: hand-written Hopper kernels for the fused
  reverse-diffusion loop, each beside its plain PyTorch version.
- ``dposer_tpu_torch.data``, ``body_model``, ``ops.metrics``: the pose
  normalizer, the SMPL body model and APD for the generation protocol.

Entry point: ``python -m dposer_tpu_torch.demo --task generation``.
The package imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"

N_POSES = 21  # SMPL-X body joints modelled by the pose prior (ref lib/dataset/AMASS.py:9)
