"""2D-keypoint fitting losses (ref ``lib/body_model/fitting_losses.py``).
Port of ``dposer_tpu/body_model/fitting_losses.py``."""
from __future__ import annotations

import torch

from . import constants

_CAM_OP = [constants.JOINT_IDS[j] for j in
           ["OP RHip", "OP LHip", "OP RShoulder", "OP LShoulder"]]
_CAM_GT = [constants.JOINT_IDS[j] for j in
           ["Right Hip", "Left Hip", "Right Shoulder", "Left Shoulder"]]


def perspective_projection(points: torch.Tensor, rotation: torch.Tensor,
                           translation: torch.Tensor, focal_length,
                           camera_center: torch.Tensor) -> torch.Tensor:
    """Pinhole projection (ref fitting_losses.py:6-38): ``points`` [B, N, 3],
    ``rotation`` [B, 3, 3], ``focal_length`` [B] or a scalar,
    ``camera_center`` [B, 2] -> [B, N, 2].

    ``translation`` [B, 3] is taken and not applied, as in the reference,
    whose callers pass the camera translation into the body model
    (``transl=``), so the points arrive in the camera frame.
    """
    del translation  # applied by the body model's transl
    batch = points.shape[0]
    fl = torch.as_tensor(focal_length, dtype=points.dtype,
                         device=points.device).expand(batch)
    K = torch.zeros(batch, 3, 3, dtype=points.dtype, device=points.device)
    K[:, 0, 0] = fl
    K[:, 1, 1] = fl
    K[:, 2, 2] = 1.0
    K[:, :2, 2] = camera_center
    points = torch.einsum("bij,bkj->bki", rotation, points)
    projected = points / points[:, :, -1:]
    return torch.einsum("bij,bkj->bki", K, projected)[:, :, :-1]


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """The Geman-McClure robustifier (ref :41-47)."""
    x2 = x ** 2
    s2 = sigma ** 2
    return (s2 * x2) / (s2 + x2)


def angle_prior(pose: torch.Tensor) -> torch.Tensor:
    """The penalty on unnatural knee and elbow bends (ref :50-56); ``pose``
    [B, 63+] -> [B, 4]."""
    signs = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=pose.dtype, device=pose.device)
    return torch.exp(pose[:, [55 - 3, 58 - 3, 12 - 3, 15 - 3]] * signs) ** 2


def _project(model_joints, camera_t, focal_length, camera_center):
    rotation = torch.eye(3, dtype=model_joints.dtype,
                         device=model_joints.device).expand(model_joints.shape[0], 3, 3)
    return perspective_projection(model_joints, rotation, camera_t, focal_length,
                                  camera_center)


def body_fitting_loss(body_pose, betas, model_joints, camera_t, camera_center,
                      joints_2d, joints_conf, pose_prior_loss,
                      focal_length=5000.0, sigma=100.0, pose_prior_weight=4.78,
                      shape_prior_weight=5.0, angle_prior_weight=15.2,
                      output="mean"):
    """The weighted fitting loss (ref :59-103). ``pose_prior_loss`` is the
    DPoser prior's value (a scalar), or None. ``output``: ``"mean"`` over
    the batch, ``"sum"``, or ``"reprojection"``, the per-joint
    confidence-weighted reprojection term [B, J]."""
    projected = _project(model_joints, camera_t, focal_length, camera_center)
    reproj_loss = (joints_conf ** 2) * gmof(projected - joints_2d, sigma).sum(-1)
    if output == "reprojection":
        return reproj_loss
    prior = (pose_prior_weight ** 2) * pose_prior_loss if pose_prior_loss is not None else 0.0
    angle = (angle_prior_weight ** 2) * angle_prior(body_pose).sum(-1)
    shape = (shape_prior_weight ** 2) * (betas ** 2).sum(-1)
    total = reproj_loss.sum(-1) + prior + angle + shape
    return total.sum() if output == "sum" else total.mean()


def camera_fitting_loss(model_joints, camera_t, camera_t_est, camera_center,
                        joints_2d, joints_conf, focal_length=5000.0,
                        depth_loss_weight=100.0):
    """The camera stage's loss on the hips and shoulders (OpenPose's where
    all four are confident, else the ground-truth joints') plus the depth
    anchor (ref :106-136)."""
    projected = _project(model_joints, camera_t, focal_length, camera_center)
    err_op = (joints_2d[:, _CAM_OP] - projected[:, _CAM_OP]) ** 2
    err_gt = (joints_2d[:, _CAM_GT] - projected[:, _CAM_GT]) ** 2
    is_valid = (joints_conf[:, _CAM_OP].min(-1).values[:, None, None] > 0).to(model_joints.dtype)
    reproj = (is_valid * err_op + (1 - is_valid) * err_gt).sum((1, 2))
    depth = (depth_loss_weight ** 2) * (camera_t[:, 2] - camera_t_est[:, 2]) ** 2
    return (reproj + depth).sum()
