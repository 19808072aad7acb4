"""SMPL-X body-part index tables (ref ``lib/body_model/utils.py:11-61``).

Port of ``dposer_tpu/body_model/part_indices.py`` (``BodyPartIndices``,
``BodySegIndices``). Joint indices follow the canonical SMPL-X body-joint
order; the pelvis (global orient) is excluded, so indices run 0..20 over the
21 modelled joints. Vertex-segment indices come from the standard
``smplx_vert_segmentation.json`` asset of the SMPL-X tooling: pass its path
or set ``DPOSER_VERT_SEG_PATH``. ``smpl_to_openpose`` maps SMPL-family joints
to the OpenPose order (ref lib/body_model/utils.py:68-177).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

BODY_JOINT_NAMES = [
    "pelvis",  # the global orient; excluded from the part indices
    "left_hip", "right_hip", "spine1", "left_knee", "right_knee", "spine2",
    "left_ankle", "right_ankle", "spine3", "left_foot", "right_foot", "neck",
    "left_collar", "right_collar", "head", "left_shoulder", "right_shoulder",
    "left_elbow", "right_elbow", "left_wrist", "right_wrist",
]

_IDX = {name: i - 1 for i, name in enumerate(BODY_JOINT_NAMES)}


def _joints(*names: str) -> List[int]:
    return sorted(_IDX[n] for n in names)


class BodyPartIndices:
    """Joint-index sets per body part, used to build completion masks."""

    left_leg = _joints("left_hip", "left_knee", "left_ankle", "left_foot")
    right_leg = _joints("right_hip", "right_knee", "right_ankle", "right_foot")
    left_arm = _joints("left_collar", "left_shoulder", "left_elbow", "left_wrist")
    right_arm = _joints("right_collar", "right_shoulder", "right_elbow", "right_wrist")
    trunk = _joints("spine1", "spine2", "spine3", "left_shoulder", "right_shoulder")
    hands = _joints("left_wrist", "right_wrist")
    legs = sorted(left_leg + right_leg)
    arms = sorted(left_arm + right_arm)

    PARTS = ["left_leg", "right_leg", "left_arm", "right_arm", "trunk", "hands",
             "legs", "arms"]


_SEG_GROUPS: Dict[str, List[str]] = {
    "left_leg": ["leftLeg", "leftUpLeg", "leftFoot", "leftToeBase"],
    "right_leg": ["rightLeg", "rightUpLeg", "rightFoot", "rightToeBase"],
    "left_arm": ["leftArm", "leftForeArm"],
    "right_arm": ["rightArm", "rightForeArm"],
    "trunk": ["spine1", "spine2", "leftShoulder", "rightShoulder"],
    "hands": ["leftHand", "rightHand"],
}


class BodySegIndices:
    """Vertex-index sets per body part, for part-wise MPVPE; built on first
    use from a ``smplx_vert_segmentation.json`` file."""

    _cache: Dict[str, Dict[str, List[int]]] = {}

    @classmethod
    def load(cls, seg_json_path: str | None = None) -> Dict[str, List[int]]:
        path = seg_json_path or os.environ.get("DPOSER_VERT_SEG_PATH")
        if path is None:
            raise FileNotFoundError(
                "smplx_vert_segmentation.json path required: pass seg_json_path "
                "or set DPOSER_VERT_SEG_PATH")
        path = os.path.abspath(path)
        if path not in cls._cache:
            with open(path) as f:
                seg = json.load(f)
            out = {part: sorted({v for g in groups for v in seg[g]})
                   for part, groups in _SEG_GROUPS.items()}
            out["legs"] = sorted(set(out["left_leg"] + out["right_leg"]))
            out["arms"] = sorted(set(out["left_arm"] + out["right_arm"]))
            cls._cache[path] = out
        return cls._cache[path]


# OpenPose body order: head keypoint, neck, shoulders, elbows, wrists, hips,
# knees, ankles; the head keypoint is the first extra joint of the model
_OP_BODY = [12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7]
_N_LBS = {"smpl": 24, "smplh": 52, "smplx": 55}
# the hands' OpenPose order over the model's finger joints; the fingertips
# (the +4, +8, ... entries) are the extra joints after the face and feet
_HAND = {"smplh": ([20, 34, 35, 36, 22, 23, 24, 25, 26, 27, 31, 32, 33, 28, 29, 30],
                   [21, 49, 50, 51, 37, 38, 39, 40, 41, 42, 46, 47, 48, 43, 44, 45]),
         "smplx": ([20, 37, 38, 39, 25, 26, 27, 28, 29, 30, 34, 35, 36, 31, 32, 33],
                   [21, 52, 53, 54, 40, 41, 42, 43, 44, 45, 49, 50, 51, 46, 47, 48])}


def _hand(joints, tips):
    """wrist, then per finger three joints and its tip."""
    out = [joints[0]]
    for f in range(5):
        out += joints[1 + 3 * f:4 + 3 * f] + [tips[f]]
    return out


def smpl_to_openpose(model_type: str = "smplx", use_hands: bool = True,
                     use_face: bool = True, use_face_contour: bool = False,
                     openpose_format: str = "coco25") -> np.ndarray:
    """The permutation of SMPL-family joints into OpenPose order (int32):
    the body (coco25: nose, body, eyes, ears, feet; coco19: no feet), then
    for SMPL-H / SMPL-X the two hands and for SMPL-X the face landmarks
    (ref lib/body_model/utils.py:68-177)."""
    fmt = openpose_format.lower()
    if fmt not in ("coco25", "coco19"):
        raise ValueError(f"Unknown joint format: {openpose_format}")
    if model_type not in _N_LBS:
        raise ValueError(f"Unknown model type: {model_type}")
    n = _N_LBS[model_type]
    n_body_extra = 10 if fmt == "coco25" else 4  # eyes and ears, and the feet
    mapping = [n] + _OP_BODY + list(range(n + 1, n + 1 + n_body_extra))
    if model_type != "smpl" and use_hands:
        tip0 = n + 1 + n_body_extra
        left, right = _HAND[model_type]
        mapping += _hand(left, list(range(tip0, tip0 + 5)))
        mapping += _hand(right, list(range(tip0 + 5, tip0 + 10)))
    if model_type == "smplx" and use_face:
        face0 = n + 1 + n_body_extra + 10
        mapping += list(range(face0, face0 + 51 + 17 * use_face_contour))
    return np.asarray(mapping, np.int32)
