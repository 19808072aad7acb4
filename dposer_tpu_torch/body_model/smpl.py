"""The SMPL body model in torch: blendshapes, pose correctives, the
kinematic chain and linear blend skinning.

Port of ``dposer_tpu/body_model/smplx_jax.py`` for the SMPL type (the
generation metrics' body, ref run/demo.py:142-161), after the torch
transcription pinned to it in ``benchmarks/torch_body_shim.py``. SMPL-H/-X
wait for a later slice.

Joint layout of ``Jtr``: 24 LBS joints, then the 21 extra vertex keypoints
of the SMPL-H vertex table (face, feet, fingertips). Vertex ids beyond an
under-sized template clamp to its last vertex, as the JAX loader's static
clamp does.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

N_JOINTS = 24
N_BODY = 23  # SMPL's "body" pose spans 23 joints (incl. the two hand roots)

# Extra keypoints (smplx's vertex_ids.py, SMPL-H mesh), in the OpenPose
# order face(5), feet(6), fingertips(10).
EXTRA_VERTEX_IDS = [332, 6260, 2800, 4071, 583,
                    3216, 3226, 3387, 6617, 6624, 6787,
                    2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016, 6133]


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
    """SMPL with the reference ``BodyModel`` call signature
    (ref lib/body_model/body_model.py:68-112)."""

    def __init__(self, bm_path: str, num_betas: int = 10, model_type: str = "smpl",
                 device="cpu"):
        super().__init__()
        if model_type != "smpl":
            raise NotImplementedError("the port's body model supports model_type='smpl'")
        with np.load(bm_path, allow_pickle=True) as f:
            data = {k: f[k] for k in f.files}
        v_template = np.asarray(data["v_template"], np.float32)
        n_verts = v_template.shape[0]
        posedirs = np.asarray(data["posedirs"], np.float32)
        if posedirs.ndim == 3:  # [V, 3, P] -> [P, V*3]
            posedirs = posedirs.reshape(n_verts * 3, -1).T
        J_reg = data["J_regressor"]
        if hasattr(J_reg, "toarray"):
            J_reg = J_reg.toarray()
        parents = np.asarray(data["kintree_table"])[0].astype(np.int64)[:N_JOINTS]
        parents[0] = 0  # the release's root marker is 2^32-1
        faces = np.asarray(data["f"], np.int64) if "f" in data else np.zeros((0, 3), np.int64)

        def buf(name, arr, dtype=torch.float32):
            self.register_buffer(name, torch.as_tensor(np.asarray(arr), dtype=dtype,
                                                       device=device))

        buf("v_template", v_template)
        buf("shapedirs", np.asarray(data["shapedirs"], np.float32)[:, :, :num_betas])
        buf("posedirs", posedirs)
        buf("J_regressor", np.asarray(J_reg, np.float32)[:N_JOINTS])
        buf("lbs_weights", np.asarray(data["weights"], np.float32)[:, :N_JOINTS])
        buf("faces", faces, torch.long)
        buf("extra_joint_ids", np.minimum(EXTRA_VERTEX_IDS, n_verts - 1), torch.long)
        self.parents = parents.tolist()
        self.num_betas = num_betas
        self.f = self.faces

    def _lbs(self, betas: torch.Tensor, full_pose: torch.Tensor):
        B = full_pose.shape[0]
        v_shaped = self.v_template[None] + torch.einsum("bs,vcs->bvc", betas, self.shapedirs)
        j_rest = torch.einsum("jv,bvc->bjc", self.J_regressor, v_shaped)
        rot_mats = axis_angle_to_matrix(full_pose.reshape(B, N_JOINTS, 3))
        eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
        pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)
        v_posed = v_shaped + (pose_feature @ self.posedirs).reshape(B, -1, 3)

        parents = self.parents
        rel_joints = j_rest.clone()
        rel_joints[:, 1:] = j_rest[:, 1:] - j_rest[:, parents[1:]]
        T_local = torch.zeros(B, N_JOINTS, 4, 4, dtype=rot_mats.dtype, device=rot_mats.device)
        T_local[:, :, :3, :3] = rot_mats
        T_local[:, :, :3, 3] = rel_joints
        T_local[:, :, 3, 3] = 1.0
        chains = [T_local[:, 0]]
        for j in range(1, N_JOINTS):
            chains.append(chains[parents[j]] @ T_local[:, j])
        T_global = torch.stack(chains, dim=1)

        posed_joints = T_global[:, :, :3, 3]
        A = T_global.clone()
        A[:, :, :3, 3] -= torch.einsum("bjmn,bjn->bjm", T_global[:, :, :3, :3], j_rest)
        T = torch.einsum("vj,bjmn->bvmn", self.lbs_weights, A)
        verts = torch.einsum("bvmn,bvn->bvm", T[:, :, :3, :3], v_posed) + T[:, :, :3, 3]
        return verts, posed_joints

    @torch.no_grad()
    def forward(self, root_orient=None, pose_body=None, betas=None, trans=None):
        """Any argument may be None; ``pose_body`` is [B, 69] axis-angle."""
        ref = next(a for a in (pose_body, root_orient, betas, trans) if a is not None)
        B = ref.shape[0]

        def zeros(n):
            return torch.zeros(B, n, dtype=self.v_template.dtype, device=self.v_template.device)

        full_pose = torch.cat([zeros(3) if root_orient is None else root_orient,
                               zeros(N_BODY * 3) if pose_body is None else pose_body], dim=1)
        betas = zeros(self.num_betas) if betas is None else betas
        verts, joints = self._lbs(betas, full_pose)
        joints = torch.cat([joints, verts[:, self.extra_joint_ids]], dim=1)
        if trans is not None:
            verts = verts + trans[:, None, :]
            joints = joints + trans[:, None, :]
        return SimpleNamespace(v=verts, f=self.faces, betas=betas, Jtr=joints,
                               body_joints=joints[:, :22],
                               pose_body=full_pose[:, 3:], full_pose=full_pose)
