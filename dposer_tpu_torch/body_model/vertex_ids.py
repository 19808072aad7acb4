"""Extra-keypoint vertex ids of the SMPL-family meshes. Port of
``dposer_tpu/body_model/vertex_ids.py``.

The public constants of the ``smplx`` package (vertex_ids.py) that map mesh
vertices to the keypoints appended after the LBS joints: the face points,
toes and heels, and fingertips. A model release whose ids differ passes its
own table as ``BodyModel(..., vertex_ids={...})``.

Order of the appended joints (the OpenPose remap's, ref
lib/body_model/utils.py:110-122): face(5) nose, reye, leye, rear, lear;
feet(6) LBigToe, LSmallToe, LHeel, RBigToe, RSmallToe, RHeel; tips(10)
lthumb, lindex, lmiddle, lring, lpinky, rthumb, rindex, rmiddle, rring,
rpinky.
"""

EXTRA_JOINT_NAMES = [
    "nose", "reye", "leye", "rear", "lear",
    "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
    "lthumb", "lindex", "lmiddle", "lring", "lpinky",
    "rthumb", "rindex", "rmiddle", "rring", "rpinky",
]

VERTEX_IDS = {
    "smplh": {
        "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
        "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016, "rpinky": 6133,
        "lthumb": 2746, "lindex": 2319, "lmiddle": 2445, "lring": 2556, "lpinky": 2673,
        "LBigToe": 3216, "LSmallToe": 3226, "LHeel": 3387,
        "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    },
    "smplx": {
        "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
        "rthumb": 8079, "rindex": 7669, "rmiddle": 7794, "rring": 7905, "rpinky": 8022,
        "lthumb": 5361, "lindex": 4933, "lmiddle": 5058, "lring": 5169, "lpinky": 5286,
        "LBigToe": 5770, "LSmallToe": 5780, "LHeel": 8846,
        "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
    },
}
VERTEX_IDS["smpl"] = VERTEX_IDS["smplh"]
