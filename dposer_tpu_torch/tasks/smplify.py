"""SMPLify-style human mesh recovery with the DPoser prior. Port of
``dposer_tpu/tasks/smplify.py`` (ref run/smplify.py).

Two Adam stages: the camera stage moves the global orientation and the
camera translation against the hips' and shoulders' reprojection and a depth
anchor; the body stage moves the body pose, the betas and the orientation
for 5 stages x ``num_iters`` steps against the weighted fitting loss with
the DPoser prior. As in the reference:

- the stage weights: pose and shape prior ``[50, 20, 10, 5, 2]``, angle
  prior ``[150, 50, 30, 15, 5]`` (ref :147-151);
- the time strategy's offset 5, ``sample_trun`` 20, ``sample_time =
  round(0.9 sde_N)`` (ref :143-166);
- the prior on ``poses[:, :63]`` normalised from axis-angle, weighted
  ``0.5 sqrt(1 + SNR)``, its sum divided by the batch size (ref :94-115);
- OP Neck and the OpenPose and ground-truth hips get confidence 0 in the
  body stage and the final reprojection (ref :135-136, :235).

The gradient flows through the body model and the prior's L2; the images of
a batch share each step's time draw. Each stage is an eager loop (JAX runs
each as one ``lax.scan``).

``SMPLify(mesh=)`` splits the images over a ``parallel.sharding.Mesh`` (JAX
shards the image axis of its two stages): every step's time and the prior's
normals are drawn first, at the whole batch's shape and in the unsharded
fit's order, from the caller's generator, and split by rows; each shard then
fits its images on its device with its rows of them, the shards one after
the other from this thread, and the results are joined on the first device.
A shard's loss is scaled by its share of the batch, so each image's gradient
is the unsharded fit's. A batch that does not divide the mesh is padded with
its last image and trimmed. A shard on another device than the body
model's runs on ``replica(device) -> (body_model, pose_prior)``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import copy

import torch

from ..body_model import constants
from ..body_model.fitting_losses import body_fitting_loss, camera_fitting_loss
from ..diffusion.sde import SDE
from ..parallel.sharding import Mesh, padded_split
from .optim import Adam
from .prior import DPoserPrior, sample_quan_t

N_POSES = 21


class DPoser:
    """The pose prior SMPLify calls (ref run/smplify.py:17-115)."""

    def __init__(self, sde: SDE, score_fn: Callable, normalizer, batch_size: int = 32,
                 device=None):
        self.prior = DPoserPrior(sde, score_fn, device=device)
        self.normalizer = normalizer
        self.batch_size = batch_size
        self.timesteps = self.prior.timesteps.tolist()

    def __call__(self, poses: torch.Tensor, betas: torch.Tensor, quan_t: int,
                 z: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The weighted prior of ``poses[:, :63]``; ``z`` [B, 63] injects the
        perturbation normal, else it is drawn from ``generator``."""
        del betas  # the reference's signature; the prior reads the pose only
        normed = self.normalizer.offline_normalize(poses[:, :N_POSES * 3], from_axis=True)
        vec_t = torch.full((poses.shape[0],), self.timesteps[quan_t], dtype=poses.dtype,
                           device=poses.device)
        return self.prior.loss(normed, vec_t, weighted=True, reduction="sum_per_batch",
                               batch_size=self.batch_size, z=z, generator=generator)


class SMPLify:
    """Two-stage keypoint fitting (ref run/smplify.py:118-281)."""

    IGN_JOINTS = ["OP Neck", "OP RHip", "OP LHip", "Right Hip", "Left Hip"]
    POSE_PRIOR_WEIGHTS = (50.0, 20.0, 10.0, 5.0, 2.0)
    SHAPE_PRIOR_WEIGHTS = (50.0, 20.0, 10.0, 5.0, 2.0)
    ANGLE_PRIOR_WEIGHTS = (150.0, 50.0, 30.0, 15.0, 5.0)
    STAGES = 5

    def __init__(self, body_model, pose_prior: Optional[DPoser] = None,
                 step_size: float = 1e-2, batch_size: int = 32, num_iters: int = 100,
                 focal_length=5000.0, time_strategy: str = "3", sde_N: int = 500,
                 cam_step_size: Optional[float] = None, mesh: Optional[Mesh] = None,
                 replica: Optional[Callable] = None):
        self.smpl = body_model
        self.pose_prior = pose_prior
        self.step_size = step_size
        # the camera stage's step (its travel is bounded by step x iters, as
        # Adam normalises the gradient); None keeps the reference's one step
        # for both stages (ref run/smplify.py:140)
        self.cam_step_size = step_size if cam_step_size is None else cam_step_size
        self.batch_size = batch_size
        self.num_iters = num_iters
        self.focal_length = focal_length
        self.time_strategy = time_strategy
        self.sde_N = sde_N
        self.sample_time = round(sde_N * 0.9)
        self.sample_trun = 20.0
        self.ign_joints = [constants.JOINT_IDS[i] for i in self.IGN_JOINTS]
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.replica = replica
        self.loss_scale = 1.0  # a shard's share of the batch (the body stage's loss)
        self._parts = {}

    def _shard(self, device, rows: int, batch: int) -> "SMPLify":
        """The single-device fit of ``rows`` of ``batch`` images on
        ``device``: this fit's parts there (``replica``'s, built once, off the
        body model's device), a prior normalised by ``rows`` and the loss
        scaled by ``rows / batch``."""
        device = torch.device(device)
        own = self.smpl.bm.v_template.device
        if device not in self._parts:
            if device == own:
                self._parts[device] = (self.smpl, self.pose_prior)
            elif self.replica is None:
                raise ValueError(f"a shard on {device}, off the body model's {own}, needs "
                                 "replica=")
            else:
                self._parts[device] = self.replica(device)
        shard = copy.copy(self)
        shard.smpl, prior = self._parts[device]
        shard.pose_prior = None if prior is None else copy.copy(prior)
        if shard.pose_prior is not None:
            shard.pose_prior.batch_size = rows
        shard.mesh, shard.loss_scale = None, rows / batch
        return shard

    def _draws(self, batch: int, device, generator, z, t_idx):
        """``(z [steps, B, 63], t_idx [steps])``: the body stage's prior draws,
        each made, where not injected, as the unsharded fit makes it, step by
        step (the time, then the normals) from ``generator``."""
        total = self.STAGES * self.num_iters
        draw_t = t_idx is None and self.time_strategy == "1"
        if self.pose_prior is None or (z is not None and not draw_t):
            return z, t_idx
        zs, ts = [], []
        for i in range(total):
            ts.append(sample_quan_t(i, total, self.sde_N, self.time_strategy, self.sample_trun,
                                    self.sample_time, offset=5, generator=generator)
                      if draw_t else None)
            if z is None:
                zs.append(torch.randn((batch, N_POSES * 3), generator=generator, device=device))
        return (torch.stack(zs) if z is None else z), (ts if draw_t else t_idx)

    def _call_sharded(self, init_pose, init_betas, init_cam_t, camera_center, keypoints_2d,
                      generator, z, t_idx):
        """The fit of each shard's rows on its device, joined here."""
        B = init_pose.shape[0]
        here = init_pose.device
        z, t_idx = self._draws(B, here, generator, z, t_idx)
        outs = []
        for dev, rows in zip(self.mesh.devices, padded_split(self.mesh, B)):
            sel = torch.tensor(rows)
            outs.append(self._shard(dev, len(rows), B)(
                *(a[sel].to(dev) for a in (init_pose, init_betas, init_cam_t, camera_center,
                                           keypoints_2d)),
                z=None if z is None else z[:, sel].to(dev), t_idx=t_idx))
        return tuple(torch.cat([o[k].to(here) for o in outs])[:B] for k in range(4))

    def _forward(self, betas, body_pose, global_orient, transl):
        return self.smpl(betas=betas, body_pose=body_pose, global_orient=global_orient,
                         transl=transl)

    def _stage1(self, go, cam_t, betas, body_pose, camera_center, joints_2d, joints_conf):
        """The camera translation and the global orientation."""
        init_cam_t = cam_t.detach()
        go, cam_t = go.detach().clone().requires_grad_(True), cam_t.detach().clone().requires_grad_(True)
        opt = Adam([go, cam_t], self.cam_step_size)
        for _ in range(self.num_iters):
            out = self._forward(betas, body_pose, go, cam_t)
            loss = camera_fitting_loss(out.joints, cam_t, init_cam_t, camera_center,
                                       joints_2d, joints_conf, focal_length=self.focal_length)
            opt.step(torch.autograd.grad(loss, [go, cam_t]))
        return go.detach(), cam_t.detach()

    def _stage2(self, bp, bt, go, camera_translation, camera_center, joints_2d, conf,
                generator, z, t_idx=None):
        """The body pose, the betas and the global orientation."""
        var = [a.detach().clone().requires_grad_(True) for a in (bp, bt, go)]
        opt = Adam(var, self.step_size)
        total = self.STAGES * self.num_iters
        for i in range(total):
            stage = i // self.num_iters
            bp_v, bt_v, go_v = var
            out = self._forward(bt_v, bp_v, go_v, camera_translation)
            prior = None
            if self.pose_prior is not None:
                quan_t = (int(t_idx[i]) if t_idx is not None else
                          sample_quan_t(i, total, self.sde_N, self.time_strategy,
                                        self.sample_trun, self.sample_time, offset=5,
                                        generator=generator))
                prior = self.pose_prior(bp_v, bt_v, quan_t,
                                        z=None if z is None else z[i], generator=generator)
            loss = body_fitting_loss(
                bp_v, bt_v, out.joints, camera_translation, camera_center, joints_2d, conf,
                prior, focal_length=self.focal_length,
                pose_prior_weight=self.POSE_PRIOR_WEIGHTS[stage],
                shape_prior_weight=self.SHAPE_PRIOR_WEIGHTS[stage],
                angle_prior_weight=self.ANGLE_PRIOR_WEIGHTS[stage])
            if self.loss_scale != 1.0:
                loss = loss * self.loss_scale
            opt.step(torch.autograd.grad(loss, var))
        return [a.detach() for a in var]

    def __call__(self, init_pose: torch.Tensor, init_betas: torch.Tensor,
                 init_cam_t: torch.Tensor, camera_center: torch.Tensor,
                 keypoints_2d: torch.Tensor, generator: Optional[torch.Generator] = None,
                 z: Optional[torch.Tensor] = None, t_idx=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Fit ``init_pose`` [B, 66] (orientation and 21 body joints), the
        betas [B, 10] and the camera translation [B, 3] to ``keypoints_2d``
        [B, 49, 3] (x, y, confidence). ``z`` [5 num_iters, B, 63] injects the
        prior's normals and ``t_idx`` [5 num_iters] its time indices, else
        they come from ``generator``. Returns the pose [B, 66], the betas, the
        camera translation and the final reprojection loss [B, 49]."""
        if self.mesh is not None:
            return self._call_sharded(init_pose, init_betas, init_cam_t, camera_center,
                                      keypoints_2d, generator, z, t_idx)
        joints_2d = keypoints_2d[:, :, :2]
        joints_conf = keypoints_2d[:, :, -1]
        body_pose, betas = init_pose[:, 3:], init_betas
        global_orient, camera_translation = self._stage1(
            init_pose[:, :3], init_cam_t, betas, body_pose, camera_center, joints_2d,
            joints_conf)
        conf = joints_conf.clone()  # out of place: stage 1 kept every joint
        conf[:, self.ign_joints] = 0.0
        body_pose, betas, global_orient = self._stage2(
            body_pose, betas, global_orient, camera_translation, camera_center, joints_2d,
            conf, generator, z, t_idx)
        with torch.no_grad():
            out = self._forward(betas, body_pose, global_orient, camera_translation)
            reproj = body_fitting_loss(body_pose, betas, out.joints, camera_translation,
                                       camera_center, joints_2d, conf, None,
                                       focal_length=self.focal_length, output="reprojection")
        return (torch.cat([global_orient, body_pose], dim=-1), betas, camera_translation,
                reproj)
