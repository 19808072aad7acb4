"""SMPL-X body-part index tables (ref ``lib/body_model/utils.py:11-61``).

Port of ``dposer_tpu/body_model/part_indices.py`` (``BodyPartIndices``,
``BodySegIndices``). Joint indices follow the canonical SMPL-X body-joint
order; the pelvis (global orient) is excluded, so indices run 0..20 over the
21 modelled joints. Vertex-segment indices come from the standard
``smplx_vert_segmentation.json`` asset of the SMPL-X tooling: pass its path
or set ``DPOSER_VERT_SEG_PATH``. The OpenPose joint maps wait for the fitting
tasks.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

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
