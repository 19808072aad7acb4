"""Rotation representation conversions and camera helpers in PyTorch (port of
``dposer_tpu/ops/rotations.py``; ref lib/utils/transforms.py).

Same formulas as the JAX package: closed-form Rodrigues, Gram-Schmidt rot6d
decoding, and a quaternion route from matrix to axis-angle that is total
(no NaNs), so each function can sit inside differentiated code.

Layout conventions (on-disk data compatibility, as the reference):

- ``rot6d`` is the row-interleaved flattening of the first two columns of
  the rotation matrix, ``[r00, r01, r10, r11, r20, r21]``, i.e.
  ``R[:3, :2].reshape(6)`` (ref transforms.py:251-253).
- Decoding views rot6d as ``(3, 2)``; columns 0 and 1 are the two
  Gram-Schmidt inputs (ref transforms.py:210-218).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _last_dims(x: torch.Tensor, shape) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + tuple(shape))


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues. ``aa`` [..., 3] -> [..., 3, 3]; the series near 0."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    sin_over = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cos_term = torch.where(small, 0.5 - theta2 / 24.0,
                           (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], dim=-1),
                     torch.stack([z, zero, -x], dim=-1),
                     torch.stack([-y, x, zero], dim=-1)], dim=-2)
    outer = aa[..., :, None] * aa[..., None, :]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    K2 = outer - theta2[..., None] * eye
    return eye + sin_over[..., None] * K + cos_term[..., None] * K2


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z),
    Shepperd's method: the largest of four candidate roots, selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=_EPS))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)
    cands = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(cands, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.take_along_dim(qs, idx[..., None, None], dim=-2)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> axis-angle [..., 3]."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1)
    half = torch.atan2(sin_half, w)
    small = sin_half < 1e-6
    scale = torch.where(small, 2.0 + 2.0 * (half ** 2) / 6.0,
                        2.0 * half / torch.clamp(sin_half, min=_EPS))
    return xyz * scale[..., None]


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(R))


def rot6d_to_matrix(rot6d: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] by Gram-Schmidt (ref transforms.py:227-235)."""
    m = _last_dims(rot6d, (3, 2))
    a1, a2 = m[..., 0], m[..., 1]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=1e-12)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.norm(a2p, dim=-1, keepdim=True), min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6]: the first two columns, row-major."""
    return R[..., :3, :2].reshape(R.shape[:-2] + (6,))


def axis_angle_to_rot6d(aa: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 6] (ref transforms.py:238-255)."""
    return matrix_to_rot6d(axis_angle_to_matrix(aa))


def rot6d_to_axis_angle(rot6d: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3] (ref transforms.py:197-224, without NaNs)."""
    return matrix_to_axis_angle(rot6d_to_matrix(rot6d))


# ---------------------------------------------------------------------------
# Camera math (ref transforms.py:172-194)
# ---------------------------------------------------------------------------

def cam_crop2full(crop_cam, center, scale, full_img_shape, focal_length):
    """Weak-perspective crop camera (s, tx, ty) -> full-image translation."""
    img_h, img_w = full_img_shape[:, 0], full_img_shape[:, 1]
    cx, cy, b = center[:, 0], center[:, 1], scale * 200.0
    w_2, h_2 = img_w / 2.0, img_h / 2.0
    bs = b * crop_cam[:, 0] + 1e-9
    tz = 2.0 * focal_length / bs
    tx = (2.0 * (cx - w_2) / bs) + crop_cam[:, 1]
    ty = (2.0 * (cy - h_2) / bs) + crop_cam[:, 2]
    return torch.stack([tx, ty, tz], dim=-1)


def estimate_focal_length(img_h, img_w):
    """The field-of-view ~55 degree heuristic (ref transforms.py:193-194)."""
    return (img_w * img_w + img_h * img_h) ** 0.5


# ---------------------------------------------------------------------------
# Camera-frame transforms (ref transforms.py:9-46, 136-169)
# ---------------------------------------------------------------------------

def world_to_camera_frame(P, R, T):
    """[N, 3] world points -> camera frame; R [3, 3], T [3, 1]."""
    return (R @ (P.T - T)).T


def camera_to_world_frame(P, R, T):
    return (R.T @ P.T + T).T


def cam2pixel(cam_coord, f, c):
    """[N, 3] camera coordinates -> pixel coordinates (x, y, depth)."""
    x = cam_coord[:, 0] / cam_coord[:, 2] * f[0] + c[0]
    y = cam_coord[:, 1] / cam_coord[:, 2] * f[1] + c[1]
    return torch.stack((x, y, cam_coord[:, 2]), 1)


def pixel2cam(pixel_coord, f, c):
    x = (pixel_coord[:, 0] - c[0]) / f[0] * pixel_coord[:, 2]
    y = (pixel_coord[:, 1] - c[1]) / f[1] * pixel_coord[:, 2]
    return torch.stack((x, y, pixel_coord[:, 2]), 1)


def rotate_points(points, rotation_matrix):
    return points @ rotation_matrix.T


def _angle(angle):
    return torch.as_tensor(angle, dtype=torch.float32)


def get_rotation_matrix_x(angle):
    a = _angle(angle)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, c, -s]),
                        torch.stack([zero, s, c])])


def get_rotation_matrix_y(angle):
    a = _angle(angle)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([c, zero, s]), torch.stack([zero, one, zero]),
                        torch.stack([-s, zero, c])])


# ---------------------------------------------------------------------------
# Procrustes and rigid alignment (evaluation helpers)
# ---------------------------------------------------------------------------

def procrustes(A, B, scaling: bool = True):
    """MATLAB-style procrustes (ref transforms.py:48-133): the similarity
    transform of B that minimises ||A - (s B R + t)||^2. Returns ``(d, Z,
    tform)``: the normalised residual, the transformed B, and the rotation,
    scale and translation."""
    A = torch.as_tensor(A)
    B = torch.as_tensor(B, dtype=A.dtype, device=A.device)
    mu_A, mu_B = A.mean(0), B.mean(0)
    A0, B0 = A - mu_A, B - mu_B
    ssA, ssB = (A0 ** 2).sum(), (B0 ** 2).sum()
    normA, normB = torch.sqrt(ssA), torch.sqrt(ssB)
    A0, B0 = A0 / normA, B0 / normB
    U, s, Vt = torch.linalg.svd(A0.T @ B0)
    R = Vt.T @ U.T
    trace = s.sum()
    if scaling:
        scale = trace * normA / normB
        d = 1 - trace ** 2
        Z = normA * trace * (B0 @ R) + mu_A
    else:
        scale = torch.ones((), dtype=A.dtype, device=A.device)
        d = 1 + ssB / ssA - 2 * trace * normB / normA
        Z = normB * (B0 @ R) + mu_A
    translation = mu_A - scale * (mu_B @ R)
    return d, Z, {"rotation": R, "scale": scale, "translation": translation}


def align_to_gt(pose, pose_gt):
    """Align a pose to the ground truth with procrustes (ref transforms.py:150-155)."""
    return procrustes(pose_gt, pose)[1]


def rigid_transform_3d(A, B):
    """Least-squares similarity transform A -> B (ref transforms.py:264-280)."""
    n = A.shape[0]
    centroid_A, centroid_B = A.mean(0), B.mean(0)
    H = (A - centroid_A).T @ (B - centroid_B) / n
    U, s, Vt = torch.linalg.svd(H)
    V = Vt.T
    det = torch.linalg.det(V @ U.T)
    d = torch.ones_like(s)
    d[-1] = torch.sign(det)
    R = (V * d[None, :]) @ U.T
    varP = torch.var(A, dim=0, unbiased=False).sum()
    c = torch.sum(s * d) / varP
    t = -c * (R @ centroid_A) + centroid_B
    return c, R, t


def rigid_align(A, B):
    """Align point set A to B with a similarity transform (PA-MPJPE)."""
    c, R, t = rigid_transform_3d(A, B)
    return (c * (R @ A.T)).T + t
