"""Sample-quality, completion and HMR metrics (ref lib/utils/metric.py,
lib/dataset/AMASS.py:263-324, lib/dataset/mocap_dataset.py:61-84). Port of
``dposer_tpu/ops/metrics.py``: APD, the self-intersection percentage (the
host C++ of ``dposer_tpu_torch/native``, in place of the reference's
pymeshlab), ``Evaler``, and the PA- and pelvis-aligned MPJPE (host numpy in
float64)."""
from __future__ import annotations

import functools
import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..body_model.constants import VERT_SEG_PATH
from ..body_model.part_indices import BodyPartIndices, BodySegIndices


def average_pairwise_distance(joints3d: torch.Tensor) -> torch.Tensor:
    """APD over a batch of joint sets [B, J, 3] (ref metric.py:8-37): the
    mean over ordered pairs (i != j) of the mean per-joint euclidean distance."""
    b = joints3d.shape[0]
    diff = joints3d[:, None] - joints3d[None, :]  # [B, B, J, 3]
    d = torch.sqrt(torch.clamp(torch.sum(diff ** 2, dim=-1), min=1e-24))
    pair = d.mean(-1)
    return (pair.sum() - torch.trace(pair)) / (b * (b - 1))


@functools.cache
def _warn_no_compiler(reason: str) -> None:
    warnings.warn(f"self-intersection metric unavailable ({reason}): SI is NaN",
                  RuntimeWarning, stacklevel=3)


def self_intersections_percentage(vertices, faces) -> np.ndarray:
    """The percentage of self-intersecting faces per mesh (ref
    metric.py:41-89): ``vertices`` [B, V, 3] or [V, 3] and ``faces`` [F, 3],
    tensors or arrays -> float32 numpy [B], on every host thread.

    Without a host compiler to build the native library it returns NaNs and
    warns once, as the reference does without pymeshlab (ref metric.py:70-71);
    a failed compile or load raises."""
    if isinstance(vertices, torch.Tensor):
        vertices = vertices.detach().cpu().numpy()
    if isinstance(faces, torch.Tensor):
        faces = faces.detach().cpu().numpy()
    from .. import native

    try:
        return native.self_intersections_percentage(vertices, faces)
    except FileNotFoundError as e:
        _warn_no_compiler(str(e))
        return np.full(1 if np.ndim(vertices) == 2 else len(vertices), np.nan, np.float32)


class Evaler:
    """Part-wise MPVPE / MPJPE in mm through a body model.

    ``part`` restricts which joints and vertices are scored (joint indices
    offset by +1 to skip the pelvis, ref AMASS.py:269). The part's vertices
    come from the SMPL-X vertex segmentation (``seg_json_path``, else
    ``DPOSER_VERT_SEG_PATH``, else the packaged asset); a template smaller than that mesh (a synthetic
    or reduced model) scores all vertices instead, and so does a missing
    segmentation, with a warning.
    """

    def __init__(self, body_model, part: Optional[str] = None,
                 seg_json_path: Optional[str] = None):
        self.body_model = body_model
        self.part = part
        self.joint_idx = self.vert_idx = slice(None)
        if part is None:
            return
        self.joint_idx = torch.as_tensor(getattr(BodyPartIndices, part)) + 1
        try:
            path = (seg_json_path or os.environ.get("DPOSER_VERT_SEG_PATH")
                    or VERT_SEG_PATH)
            vert_idx = torch.as_tensor(BodySegIndices.load(path)[part])
            if int(vert_idx.max()) < body_model.v_template.shape[0]:
                self.vert_idx = vert_idx
        except (FileNotFoundError, KeyError) as e:
            warnings.warn(f"part {part!r} vertex segmentation unavailable ({e}); "
                          f"scoring ALL vertices: the part-wise MPVPE is the "
                          f"full-mesh MPVPE", RuntimeWarning)

    def _errors(self, outs: torch.Tensor, gts: torch.Tensor):
        body_gt = self.body_model(pose_body=gts)
        body_out = self.body_model(pose_body=outs)

        def mm(a, b):
            return torch.linalg.norm(a - b, dim=-1).mean(-1) * 1000.0

        return (mm(body_out.v[:, self.vert_idx], body_gt.v[:, self.vert_idx]),
                mm(body_out.Jtr[:, self.joint_idx], body_gt.Jtr[:, self.joint_idx]))

    def eval_bodys(self, outs, gts) -> Dict[str, np.ndarray]:
        """``outs``, ``gts`` [B, 63] axis-angle body poses -> per-sample mm errors."""
        mesh_err, joint_err = self._errors(outs, gts)
        return {"mpvpe_all": mesh_err.cpu().numpy(), "mpjpe_body": joint_err.cpu().numpy()}

    def multi_eval_bodys(self, outs, gts) -> Dict[str, np.ndarray]:
        """``outs`` [B, hypo, 63]: the minimum over hypotheses (ref AMASS.py:300-316)."""
        b, hypo, d = outs.shape
        mesh_err, joint_err = self._errors(outs.reshape(b * hypo, d),
                                           gts.repeat_interleave(hypo, dim=0))
        return {"mpvpe_all": mesh_err.reshape(b, hypo).min(dim=1).values.cpu().numpy(),
                "mpjpe_body": joint_err.reshape(b, hypo).min(dim=1).values.cpu().numpy()}

    @staticmethod
    def print_eval_result(eval_result):
        print("MPVPE (All): %.2f mm" % np.mean(eval_result["mpvpe_all"]))
        print("MPJPE (Body): %.2f mm" % np.mean(eval_result["mpjpe_body"]))

    @staticmethod
    def print_multi_eval_result(eval_result, hypo_num):
        print(f"multihypo {hypo_num} MPVPE (All): %.2f mm" % np.mean(eval_result["mpvpe_all"]))
        print(f"multihypo {hypo_num} MPJPE (Body): %.2f mm" % np.mean(eval_result["mpjpe_body"]))


def pa_mpjpe(pred: np.ndarray, gt: np.ndarray) -> float:
    """Procrustes-aligned MPJPE in mm of one [J, 3] set against another, in
    float64 numpy (ref lib/utils/transforms.py:264-286)."""
    A = np.asarray(pred, np.float64)
    B = np.asarray(gt, np.float64)
    ca, cb = A.mean(0), B.mean(0)
    H = (A - ca).T @ (B - cb) / len(A)
    U, s, Vt = np.linalg.svd(H)
    V = Vt.T
    d = np.ones_like(s)
    d[-1] = np.sign(np.linalg.det(V @ U.T))
    R = (V * d[None, :]) @ U.T
    c = (s * d).sum() / np.var(A, axis=0).sum()
    t = -c * (R @ ca) + cb
    aligned = (c * (R @ A.T)).T + t
    return float(np.sqrt(((aligned - B) ** 2).sum(-1)).mean() * 1000.0)


def pelvis_aligned_mpjpe(pred: np.ndarray, gt: np.ndarray, pelvis_idx: int = 0) -> float:
    """MPJPE in mm after moving both sets' pelvis to the origin."""
    p = pred - pred[pelvis_idx:pelvis_idx + 1]
    g = gt - gt[pelvis_idx:pelvis_idx + 1]
    return float(np.sqrt(((p - g) ** 2).sum(-1)).mean() * 1000.0)
