"""SMPL-X for 2D-keypoint fitting, with the 49-joint OpenPose remap. Port of
``dposer_tpu/body_model/smplx_fit.py`` (ref lib/body_model/smpl.py:49-77).

The output joints follow the 25 OpenPose + 24 ground-truth convention of
``JOINT_MAP``, with the first 25 replaced by the SMPL-X keypoints at 55..65
(``SMPLX_OPENPOSE_MAP``). As in the reference, only those 25 are fixed: the
24 ground-truth rows keep SPIN's SMPL indices, which in the SMPL-X joint
layout land on finger and eye joints. They are read only by
``camera_fitting_loss``'s fallback, when a sample's OpenPose hips and
shoulders all have confidence 0. The mean pose and shape for the fit's
initialisation come from ``smpl_mean_params.npz`` (the pose as rot6d).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..ops.rotations import rot6d_to_axis_angle
from . import constants
from .smpl import BodyModel


class SMPLXFit:
    """The 49-joint SMPL-X of the fitting stack."""

    def __init__(self, model_path: str, batch_size: int = 1, num_betas: int = 10,
                 vertex_ids: Optional[dict] = None, mean_params_path: Optional[str] = None,
                 device="cpu"):
        del batch_size  # the forward takes any batch
        self.bm = BodyModel(model_path, num_betas=num_betas, model_type="smplx",
                            device=device, vertex_ids=vertex_ids)
        joints = [constants.JOINT_MAP[name] for name in constants.JOINT_NAMES]
        joints[:25] = constants.SMPLX_OPENPOSE_MAP  # ref smpl.py:54-57
        self.joint_map = torch.as_tensor(joints, dtype=torch.long, device=device)
        with np.load(mean_params_path or constants.SMPL_MEAN_PATH) as mean:
            rot6d = torch.as_tensor(mean["pose"], dtype=torch.float32, device=device)
            self.mean_shape = torch.as_tensor(mean["shape"], dtype=torch.float32,
                                              device=device)  # [10]
        self.mean_poses = rot6d_to_axis_angle(rot6d.reshape(-1, 6)).reshape(-1)  # [72]
        self.faces = self.bm.faces

    def __call__(self, betas=None, body_pose=None, global_orient=None, transl=None,
                 pose2rot: bool = True, **kwargs):
        if not pose2rot:
            raise ValueError("the fitting stack passes axis-angle poses (pose2rot=True)")
        out = self.bm(root_orient=global_orient, pose_body=body_pose, betas=betas,
                      trans=transl)
        return SimpleNamespace(vertices=out.v, joints=out.Jtr[:, self.joint_map],
                               betas=out.betas, global_orient=global_orient,
                               body_pose=body_pose, full_pose=out.full_pose)
