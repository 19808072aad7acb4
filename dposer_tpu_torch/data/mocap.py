"""The image-crop dataset of the HMR evaluation and the EHF metrics (ref
``lib/dataset/mocap_dataset.py``). Port of ``dposer_tpu/data/mocap.py``."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..body_model.smpl import BodyModel
from ..ops.metrics import pa_mpjpe
from ..ops.rotations import axis_angle_to_matrix, estimate_focal_length
from .preprocess import bbox_from_detector, load_ply, process_image

__all__ = ["MocapDataset", "estimate_focal_length"]


class MocapDataset:
    """Per-bbox crops of detected persons (ref mocap_dataset.py:18-59).
    ``detection_list`` rows are ``[img_idx, min_x, min_y, max_x, max_y]``."""

    # the EHF camera's fixed rotation (axis-angle), ref mocap_dataset.py:25-26
    EHF_CAM_R_AA = np.array([-2.98747896, 0.01172457, -0.05704687])

    def __init__(self, img_bgr_list: List[np.ndarray], detection_list: np.ndarray,
                 body_model_path: Optional[str] = None, body_model: Optional[BodyModel] = None,
                 device="cpu"):
        self.img_bgr_list = img_bgr_list
        self.detection_list = detection_list
        self.cam_R = axis_angle_to_matrix(
            torch.as_tensor(self.EHF_CAM_R_AA, dtype=torch.float32)).numpy()
        if body_model is None and body_model_path is not None:
            body_model = BodyModel(body_model_path, num_betas=10, model_type="smplx",
                                   device=device)
        self.smplx = body_model

    def __len__(self):
        return len(self.detection_list)

    def __getitem__(self, idx) -> Dict:
        img_rgb = self.img_bgr_list[int(self.detection_list[idx][0])][:, :, ::-1]
        img_h, img_w, _ = img_rgb.shape
        norm_img, center, scale, crop_ul, crop_br, _ = process_image(
            img_rgb, self.detection_list[idx][1:5])
        return {"norm_img": norm_img, "center": center, "scale": scale,
                "crop_ul": crop_ul, "crop_br": crop_br, "img_h": img_h, "img_w": img_w,
                "focal_length": estimate_focal_length(img_h, img_w)}

    def cameras(self) -> Dict:
        """Every detection's bbox ``center`` and ``scale``, its image's
        ``img_h``, ``img_w`` and ``focal_length``, stacked into float32
        arrays: ``batch()``'s camera fields, without the crop (so without
        ``cv2``)."""
        items = []
        for img_idx, *bbox in self.detection_list:
            img_h, img_w = self.img_bgr_list[int(img_idx)].shape[:2]
            center, scale = bbox_from_detector(bbox)
            items.append(dict(center=center, scale=scale, img_h=img_h, img_w=img_w,
                              focal_length=estimate_focal_length(img_h, img_w)))
        return {k: np.stack([np.asarray(it[k], np.float32) for it in items]) for k in items[0]}

    def batch(self) -> Dict:
        """Every detection's item stacked into float32 arrays."""
        items = [self[i] for i in range(len(self))]
        return {k: np.stack([np.asarray(it[k], np.float32) for it in items]) for k in items[0]}

    def eval_EHF(self, pred_results, gt_ply_path: str) -> Dict[str, List[float]]:
        """PA- and pelvis-aligned MPJPE in mm of a fit against a ground-truth
        ``.ply`` scan (ref mocap_dataset.py:61-84)."""
        return self.eval_mesh(pred_results, load_ply(gt_ply_path))

    def eval_mesh(self, pred_results, mesh_gt: np.ndarray) -> Dict[str, List[float]]:
        """``eval_EHF`` on the scan's vertices [V, 3], given in the ply's frame:
        ``pred_results`` is (pose [1, 66], betas [1, 10], camera translation
        [1, 3], ...) of one image."""
        pose, betas, camera_translation = (torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                                           device=self.smplx.v_template.device)
                                           for a in pred_results[:3])
        mesh_gt = (self.cam_R @ np.asarray(mesh_gt).T).T
        with torch.no_grad():
            out = self.smplx(betas=betas, pose_body=pose[:, 3:66], root_orient=pose[:, :3],
                             trans=camera_translation)
        mesh_out = out.v[0].cpu().numpy()
        J = self.smplx.J_regressor_array
        joint_gt, joint_out = (J @ mesh_gt)[:22], (J @ mesh_out)[:22]
        pelvis = self.smplx.J_regressor_idx["pelvis"]
        aligned = joint_out - (J @ mesh_out)[pelvis, None, :] + (J @ mesh_gt)[pelvis, None, :]
        return {"pa_mpjpe_body": [pa_mpjpe(joint_out, joint_gt)],
                "mpjpe_body": [float(np.sqrt(((aligned - joint_gt) ** 2).sum(1)).mean() * 1000)]}

    @staticmethod
    def print_eval_result(eval_result):
        print("PA MPJPE (Body): %.2f mm" % np.mean(eval_result["pa_mpjpe_body"]))
        print("MPJPE (Body): %.2f mm" % np.mean(eval_result["mpjpe_body"]))
