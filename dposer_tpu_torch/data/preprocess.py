"""Image preprocessing for HMR (ref ``lib/utils/preprocess.py``). Port of
``dposer_tpu/data/preprocess.py``.

Host-side numpy: the CLIFF / Hand4Whole crop pipeline, the bbox helpers and
light mesh readers (the PLY reader needs no plyfile). The functions that
read or resize images import ``cv2`` when called, so the package imports
without it.
"""
from __future__ import annotations

import numpy as np

from ..body_model import constants


def load_img(path: str, order: str = "RGB") -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if not isinstance(img, np.ndarray):
        raise IOError("Fail to read %s" % path)
    if order == "RGB":
        img = img[:, :, ::-1].copy()
    return img.astype(np.float32)


def load_obj(file_name: str) -> np.ndarray:
    v = []
    with open(file_name) as f:
        for line in f:
            words = line.split(" ")
            if words and words[0] == "v":
                v.append([float(words[1]), float(words[2]), float(words[3])])
    return np.asarray(v)


_PLY_TYPES = {"float": "f4", "float32": "f4", "double": "f8", "uchar": "u1", "uint8": "u1",
              "int": "i4", "int32": "i4", "ushort": "u2", "short": "i2", "uint": "u4",
              "char": "i1"}


def load_ply(file_name: str) -> np.ndarray:
    """The vertices [V, 3] (float64) of an ascii or binary little-endian PLY."""
    with open(file_name, "rb") as f:
        if f.readline().strip() != b"ply":
            raise IOError(f"{file_name}: not a PLY file")
        fmt, n_verts, props, in_vertex = None, 0, [], False
        while True:
            line = f.readline().strip()
            if line == b"end_header":
                break
            parts = line.split()
            if parts[0] == b"format":
                fmt = parts[1].decode()
            elif parts[0] == b"element":
                in_vertex = parts[1] == b"vertex"
                if in_vertex:
                    n_verts = int(parts[2])
            elif parts[0] == b"property" and in_vertex:
                props.append((parts[2].decode(), parts[1].decode()))
        if fmt == "ascii":
            arr = np.asarray([f.readline().split() for _ in range(n_verts)], np.float64)
            return arr[:, [i for i, (n, _) in enumerate(props) if n in ("x", "y", "z")]]
        dt = np.dtype([(n, "<" + _PLY_TYPES[t]) for n, t in props])
        data = np.frombuffer(f.read(n_verts * dt.itemsize), dtype=dt, count=n_verts)
        return np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float64)


def get_transform(center, scale, res, rot=0) -> np.ndarray:
    """The crop's transformation matrix (ref preprocess.py:43-70)."""
    h = 200 * scale
    w = h / (res[0] / float(res[1]))
    t = np.zeros((3, 3))
    t[0, 0] = float(res[1]) / w
    t[1, 1] = float(res[0]) / h
    t[0, 2] = res[1] * (-float(center[0]) / w + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / h + 0.5)
    t[2, 2] = 1
    if rot != 0:
        rot_rad = -rot * np.pi / 180
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat = np.zeros((3, 3))
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform(pt, center, scale, res, invert=0, rot=0) -> np.ndarray:
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = t @ np.array([pt[0] - 1, pt[1] - 1, 1.0]).T
    return np.array([round(new_pt[0]), round(new_pt[1])], dtype=int) + 1


def crop(img, center, scale, res):
    """Crop to the bbox, then resize to ``res`` [rows, cols] (ref :83-114)."""
    import cv2

    ul = np.array(transform([1, 1], center, scale, res, invert=1)) - 1
    br = np.array(transform([res[1] + 1, res[0] + 1], center, scale, res, invert=1)) - 1
    new_shape = [br[1] - ul[1], br[0] - ul[0]]
    if len(img.shape) > 2:
        new_shape += [img.shape[2]]
    new_img = np.zeros(new_shape, dtype=np.float32)
    new_x = max(0, -ul[0]), min(br[0], len(img[0])) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], len(img)) - ul[1]
    old_x = max(0, ul[0]), min(len(img[0]), br[0])
    old_y = max(0, ul[1]), min(len(img), br[1])
    new_img[new_y[0]:new_y[1], new_x[0]:new_x[1]] = img[old_y[0]:old_y[1], old_x[0]:old_x[1]]
    return cv2.resize(new_img, (res[1], res[0])), ul, br


def bbox_from_detector(bbox, rescale: float = 1.1):
    """[min_x, min_y, max_x, max_y] -> (center [2], scale) (ref :117-134)."""
    center = np.array([(bbox[0] + bbox[2]) / 2.0, (bbox[1] + bbox[3]) / 2.0])
    bbox_size = max((bbox[2] - bbox[0]) * constants.CROP_ASPECT_RATIO, bbox[3] - bbox[1])
    return center, bbox_size / 200.0 * rescale


def compute_bbox(json_data) -> np.ndarray:
    """An OpenPose json -> [[batch_id, min_x, min_y, max_x, max_y], ...] over
    the people with a visible keypoint (ref :136-159)."""
    bbox_list = []
    for batch_id, person in enumerate(json_data["people"]):
        keypoints = np.array(person["pose_keypoints_2d"]).reshape(-1, 3)
        visible = keypoints[keypoints[:, 2] > 0]
        if len(visible) == 0:
            continue
        bbox_list.append([batch_id, visible[:, 0].min(), visible[:, 1].min(),
                          visible[:, 0].max(), visible[:, 1].max()])
    return np.array(bbox_list)


def process_image(orig_img_rgb, bbox, crop_height=constants.CROP_IMG_HEIGHT,
                  crop_width=constants.CROP_IMG_WIDTH):
    """The bbox's crop -> (normalised CHW image, center, scale, crop corners
    ul and br, the crop) (ref :161-188)."""
    try:
        center, scale = bbox_from_detector(bbox)
    except Exception as e:
        print("Error occurs in person detection", e)
        height, width = orig_img_rgb.shape[:2]
        center = np.array([width // 2, height // 2])
        scale = max(height, width * crop_height / float(crop_width)) / 200.0
    img, ul, br = crop(orig_img_rgb, center, scale, (crop_height, crop_width))
    crop_img = img.copy()
    mean = np.array(constants.IMG_NORM_MEAN, dtype=np.float32)
    std = np.array(constants.IMG_NORM_STD, dtype=np.float32)
    norm_img = np.transpose((img / 255.0 - mean) / std, (2, 0, 1))
    return norm_img, center, scale, ul, br, crop_img
