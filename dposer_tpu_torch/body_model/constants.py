"""HMR joint conventions, crop constants and the shared asset paths. Port of
``dposer_tpu/body_model/constants.py``.

The 49-joint superset (25 OpenPose + 24 ground-truth joints) and its map to
SMPL joint indices are the standard SPIN/CLIFF constants (ref
lib/body_model/constants.py): they define the keypoint file format and must
match exactly. The mean pose and shape and the bend pose are the JAX
package's assets, read by path; the vertex segmentation ships with the port.
"""
import os

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SHARED_ASSETS = os.path.join(os.path.dirname(_PKG), "dposer_tpu", "assets")
SMPL_MEAN_PATH = os.path.join(_SHARED_ASSETS, "smpl_mean_params.npz")
BEND_POSE_PATH = os.path.join(_SHARED_ASSETS, "bend_pose.npz")
VERT_SEG_PATH = os.path.join(_PKG, "assets", "smplx_vert_segmentation.json")

CROP_IMG_HEIGHT = 256
CROP_IMG_WIDTH = 192
CROP_ASPECT_RATIO = CROP_IMG_HEIGHT / float(CROP_IMG_WIDTH)

IMG_NORM_MEAN = [0.485, 0.456, 0.406]
IMG_NORM_STD = [0.229, 0.224, 0.225]

FOCAL_LENGTH = 5000.0
IMG_RES = 224

# 25 OpenPose joints + 24 ground-truth joints
JOINT_NAMES = [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
    "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
    "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee",
    "Left Ankle", "Right Wrist", "Right Elbow", "Right Shoulder",
    "Left Shoulder", "Left Elbow", "Left Wrist", "Neck (LSP)",
    "Top of Head (LSP)", "Pelvis (MPII)", "Thorax (MPII)", "Spine (H36M)",
    "Jaw (H36M)", "Head (H36M)", "Nose", "Left Eye", "Right Eye",
    "Left Ear", "Right Ear",
]

JOINT_IDS = {name: i for i, name in enumerate(JOINT_NAMES)}

# joint name -> SMPL(+extra-regressor) joint index
JOINT_MAP = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17,
    "OP RElbow": 19, "OP RWrist": 21, "OP LShoulder": 16,
    "OP LElbow": 18, "OP LWrist": 20, "OP MidHip": 0,
    "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8,
    "OP LHip": 1, "OP LKnee": 4, "OP LAnkle": 7,
    "OP REye": 25, "OP LEye": 26, "OP REar": 27,
    "OP LEar": 28, "OP LBigToe": 29, "OP LSmallToe": 30,
    "OP LHeel": 31, "OP RBigToe": 32, "OP RSmallToe": 33, "OP RHeel": 34,
    "Right Ankle": 8, "Right Knee": 5, "Right Hip": 45,
    "Left Hip": 46, "Left Knee": 4, "Left Ankle": 7,
    "Right Wrist": 21, "Right Elbow": 19, "Right Shoulder": 17,
    "Left Shoulder": 16, "Left Elbow": 18, "Left Wrist": 20,
    "Neck (LSP)": 47, "Top of Head (LSP)": 48,
    "Pelvis (MPII)": 49, "Thorax (MPII)": 50,
    "Spine (H36M)": 51, "Jaw (H36M)": 52,
    "Head (H36M)": 53, "Nose": 24, "Left Eye": 26,
    "Right Eye": 25, "Left Ear": 28, "Right Ear": 27,
}

# the SMPL -> SMPL-X fix of the 25 OpenPose entries (ref
# lib/body_model/smpl.py:54-57): the SMPL-X 127-joint layout already holds
# OpenPose-style keypoints at 55..65
SMPLX_OPENPOSE_MAP = [55, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5,
                      8, 1, 4, 7, 56, 57, 58, 59, 60, 61, 62,
                      63, 64, 65]

# joint selectors (SPIN conventions)
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]
J24_TO_J17 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17]
J24_TO_J14 = J24_TO_J17[:14]

SMPL_JOINTS_FLIP_PERM = [0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13,
                         15, 17, 16, 19, 18, 21, 20, 23, 22]
SMPL_POSE_FLIP_PERM = [3 * i + k for i in SMPL_JOINTS_FLIP_PERM for k in range(3)]
J24_FLIP_PERM = [5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 15, 16,
                 17, 18, 19, 21, 20, 23, 22]
J49_FLIP_PERM = ([0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15,
                  18, 17, 22, 23, 24, 19, 20, 21]
                 + [25 + i for i in J24_FLIP_PERM])
