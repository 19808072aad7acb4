"""The SMPL / SMPL-H / SMPL-X body model in torch: shape and expression
blendshapes, pose correctives, the kinematic chain, linear blend skinning,
the extra vertex keypoints and the barycentric face landmarks.

Port of ``dposer_tpu/body_model/smplx_jax.py``. SMPL is the generation
metrics' body (ref run/demo.py:142-161), SMPL-X the completion evaluation's.
As in the reference's wrapper (ref lib/body_model/body_model.py:30-37) hand
poses are raw 45-dim axis-angle with a flat hand mean, and hands, jaw, eyes
and expression are zero unless given.

Joint layout of ``Jtr``: the LBS joints (24 / 52 / 55), then the 21 extra
vertex keypoints of the model's vertex table (face, feet, fingertips;
``vertex_ids=`` overrides the release's table), then,
where the model file carries them, the 51 barycentric face landmarks. Vertex
and face ids beyond an under-sized template clamp to its last vertex or face,
as the JAX loader's static clamp does.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from .vertex_ids import EXTRA_JOINT_NAMES, VERTEX_IDS

MODEL_JOINTS = {"smpl": 24, "smplh": 52, "smplx": 55}
N_BODY_JOINTS = 21  # articulated body joints shared by all variants
N_HAND_JOINTS = 15


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues, [..., 3] -> [..., 3, 3], total at theta = 0."""
    eps = 1e-12
    theta2 = (aa * aa).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=eps))
    small = theta2 < 1e-8
    sin_over = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cos_term = torch.where(small, 0.5 - theta2 / 24.0,
                           (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=eps))
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], dim=-1),
                     torch.stack([z, zero, -x], dim=-1),
                     torch.stack([-y, x, zero], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    K2 = aa[..., :, None] * aa[..., None, :] - theta2[..., None] * eye
    return eye + sin_over[..., None] * K + cos_term[..., None] * K2


class BodyModel(nn.Module):
    """SMPL-family body with the reference ``BodyModel`` call signature
    (ref lib/body_model/body_model.py:68-112)."""

    # the joints the HMR evaluation reads (ref lib/body_model/body_model.py)
    J_regressor_idx = {"pelvis": 0, "lwrist": 20, "rwrist": 21, "neck": 12}

    def __init__(self, bm_path: str, num_betas: int = 10, model_type: str = "smpl",
                 num_expressions: int = 10, device="cpu", vertex_ids=None):
        super().__init__()
        if model_type not in MODEL_JOINTS:
            raise ValueError(f"model_type must be one of {sorted(MODEL_JOINTS)}, "
                             f"got {model_type!r}")
        self.model_type = model_type
        self.n_joints = n_joints = MODEL_JOINTS[model_type]
        # SMPL's "body" pose spans 23 joints (incl. the two hand roots)
        self.n_body = 23 if model_type == "smpl" else N_BODY_JOINTS
        self.num_betas = num_betas
        self.num_expressions = num_expressions if model_type == "smplx" else 0
        with np.load(bm_path, allow_pickle=True) as f:
            data = {k: f[k] for k in f.files}
        v_template = np.asarray(data["v_template"], np.float32)
        n_verts = v_template.shape[0]
        shapedirs = np.asarray(data["shapedirs"], np.float32)
        if shapedirs.shape[-1] > 300 and model_type == "smplx":
            # smplx convention: [300 shape | 100 expression]
            shapedirs = np.concatenate([shapedirs[:, :, :num_betas],
                                        shapedirs[:, :, 300:300 + num_expressions]], -1)
        else:
            shapedirs = shapedirs[:, :, :num_betas]
        posedirs = np.asarray(data["posedirs"], np.float32)
        if posedirs.ndim == 3:  # [V, 3, P] -> [P, V*3]
            posedirs = posedirs.reshape(n_verts * 3, -1).T
        J_reg = data["J_regressor"]
        if hasattr(J_reg, "toarray"):
            J_reg = J_reg.toarray()
        parents = np.asarray(data["kintree_table"])[0].astype(np.int64)[:n_joints]
        parents[0] = 0  # the release's root marker is 2^32-1
        faces = np.asarray(data["f"], np.int64) if "f" in data else np.zeros((0, 3), np.int64)
        lmk_faces = np.asarray(data.get("lmk_faces_idx", np.zeros((0,))), np.int64)
        if faces.shape[0]:
            lmk_faces = np.minimum(lmk_faces, faces.shape[0] - 1)
        lmk_bary = np.asarray(data.get("lmk_bary_coords", np.zeros((0, 3))), np.float32)

        def buf(name, arr, dtype=torch.float32):
            self.register_buffer(name, torch.as_tensor(np.asarray(arr), dtype=dtype,
                                                       device=device))

        buf("v_template", v_template)
        buf("shapedirs", shapedirs)
        buf("posedirs", posedirs)
        buf("J_regressor", np.asarray(J_reg, np.float32)[:n_joints])
        buf("lbs_weights", np.asarray(data["weights"], np.float32)[:, :n_joints])
        buf("faces", faces, torch.long)
        vid = vertex_ids or VERTEX_IDS[model_type]
        buf("extra_joint_ids", np.minimum([vid[n] for n in EXTRA_JOINT_NAMES], n_verts - 1),
            torch.long)
        buf("lmk_faces_idx", lmk_faces, torch.long)
        buf("lmk_bary_coords", lmk_bary)
        self.parents = parents.tolist()
        self.f = self.faces
        # the joint regressor as float32 numpy, for the host-side evaluation
        self.J_regressor_array = np.asarray(J_reg, np.float32)[:n_joints]

    def _lbs(self, betas: torch.Tensor, full_pose: torch.Tensor):
        B, n_joints = full_pose.shape[0], self.n_joints
        v_shaped = self.v_template[None] + torch.einsum("bs,vcs->bvc", betas, self.shapedirs)
        j_rest = torch.einsum("jv,bvc->bjc", self.J_regressor, v_shaped)
        rot_mats = axis_angle_to_matrix(full_pose.reshape(B, n_joints, 3))
        eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
        pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)
        v_posed = v_shaped + (pose_feature @ self.posedirs).reshape(B, -1, 3)

        parents = self.parents
        rel_joints = j_rest.clone()
        rel_joints[:, 1:] = j_rest[:, 1:] - j_rest[:, parents[1:]]
        T_local = torch.zeros(B, n_joints, 4, 4, dtype=rot_mats.dtype, device=rot_mats.device)
        T_local[:, :, :3, :3] = rot_mats
        T_local[:, :, :3, 3] = rel_joints
        T_local[:, :, 3, 3] = 1.0
        chains = [T_local[:, 0]]
        for j in range(1, n_joints):
            chains.append(chains[parents[j]] @ T_local[:, j])
        T_global = torch.stack(chains, dim=1)

        posed_joints = T_global[:, :, :3, 3]
        A = T_global.clone()
        A[:, :, :3, 3] -= torch.einsum("bjmn,bjn->bjm", T_global[:, :, :3, :3], j_rest)
        T = torch.einsum("vj,bjmn->bvmn", self.lbs_weights, A)
        verts = torch.einsum("bvmn,bvn->bvm", T[:, :, :3, :3], v_posed) + T[:, :, :3, 3]
        return verts, posed_joints

    def forward(self, root_orient=None, pose_body=None, pose_hand=None, pose_jaw=None,
                pose_eye=None, betas=None, trans=None, expression=None):
        """Any argument may be None. ``pose_body`` is axis-angle: [B, 69] for
        SMPL, [B, 63] for SMPL-H and SMPL-X; ``pose_hand`` [B, 90]."""
        ref = next(a for a in (pose_body, root_orient, pose_hand, betas, trans)
                   if a is not None)
        B = ref.shape[0]

        def given(a, n):
            if a is not None:
                return a
            return torch.zeros(B, n, dtype=self.v_template.dtype,
                               device=self.v_template.device)

        n_body = self.n_body * 3
        parts = [given(root_orient, 3), given(pose_body, n_body)]
        if self.model_type == "smplx":
            parts += [given(pose_jaw, 3), given(pose_eye, 6)]
        if self.model_type in ("smplh", "smplx"):
            parts.append(given(pose_hand, N_HAND_JOINTS * 2 * 3))
        full_pose = torch.cat(parts, dim=1)
        betas = given(betas, self.num_betas)
        shape_comps = betas
        if self.model_type == "smplx":
            shape_comps = torch.cat([betas, given(expression, self.num_expressions)], dim=1)
        verts, joints = self._lbs(shape_comps, full_pose)
        joints = torch.cat([joints, verts[:, self.extra_joint_ids]], dim=1)
        if self.lmk_faces_idx.numel():
            lmk_verts = verts[:, self.faces[self.lmk_faces_idx]]  # [B, L, 3, 3]
            joints = torch.cat([joints, torch.einsum("blvc,lv->blc", lmk_verts,
                                                     self.lmk_bary_coords)], dim=1)
        if trans is not None:
            verts = verts + trans[:, None, :]
            joints = joints + trans[:, None, :]
        out = SimpleNamespace(v=verts, f=self.faces, betas=betas, Jtr=joints,
                              body_joints=joints[:, :22],
                              pose_body=full_pose[:, 3:3 + n_body], full_pose=full_pose)
        if self.model_type in ("smplh", "smplx"):
            out.pose_hand = full_pose[:, full_pose.shape[1] - N_HAND_JOINTS * 6:]
        if self.model_type == "smplx":
            out.pose_jaw, out.pose_eye = full_pose[:, 66:69], pose_eye
        return out
