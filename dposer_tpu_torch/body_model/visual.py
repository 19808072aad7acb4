"""Mesh and skeleton renders without OpenGL (port of
``dposer_tpu/body_model/visual.py``; ref lib/body_model/visual.py).

``rasterize_mesh`` runs the native flat-shaded z-buffer rasterizer
(``native/src/raster.cpp``, built with the host's ``g++`` at first use). A
failed build or load raises, as the self-intersection metric's does:
``FileNotFoundError`` without ``g++``, ``native.NativeLibraryError``
otherwise; nothing falls back to ``rasterize_mesh_plain``, the numpy
z-buffer loop the tests and ``chip_smoke.py`` hold the library to.

``render_mesh`` turns a mesh to one of six view presets about its centroid
and draws it at a fixed camera distance over a background;
``multiple_render`` denormalizes pose samples, runs the body model on their
device, moves the meshes to the host once and writes one PNG a sample.
``cv2`` (PNG and video I/O) and ``matplotlib`` (skeleton plots) are imported
by the functions that need them, so the module imports without them.
"""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from .. import native

VIEW_ANGLES = {
    "front": (0.0, 0.0),
    "back": (0.0, np.pi),
    "left": (0.0, np.pi / 2),
    "right": (0.0, -np.pi / 2),
    "top": (np.pi / 2, 0.0),
    "bottom": (-np.pi / 2, 0.0),
}
LIGHT_DIR = (0.3, 0.3, -1.0)
BASE_COLOR = (0.65, 0.74, 0.86)
CAMERA_DISTANCE = 2.5


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def rasterize_mesh(verts: np.ndarray, faces: np.ndarray, height: int, width: int, focal,
                   princpt, light_dir=LIGHT_DIR, base_color=BASE_COLOR) -> tuple:
    """Flat-shaded z-buffer rasterization on the native library: ``verts``
    [V, 3] in camera space (z > 0 forward), ``faces`` [F, 3] -> (rgb [H, W,
    3] float64 0-255, mask [H, W] bool)."""
    return native.rasterize(verts, faces, height, width, float(focal[0]), float(focal[1]),
                            float(princpt[0]), float(princpt[1]), light_dir, base_color)


def rasterize_mesh_plain(verts: np.ndarray, faces: np.ndarray, height: int, width: int,
                         focal, princpt, light_dir=LIGHT_DIR, base_color=BASE_COLOR) -> tuple:
    """``rasterize_mesh`` as a numpy loop over the faces, in float64: the
    plain version the native library is held to (masks agree on all but
    sub-pixel edge rounding)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    fx, fy = focal
    cx, cy = princpt
    z = np.maximum(verts[:, 2], 1e-6)
    pts = np.stack([verts[:, 0] * fx / z + cx, verts[:, 1] * fy / z + cy], 1)

    tri = pts[faces]  # [F, 3, 2]
    tri_z = z[faces]  # [F, 3]
    normals = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                       verts[faces[:, 2]] - verts[faces[:, 0]])
    normals = normals / np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-9)
    light = np.asarray(light_dir, np.float64)
    light = light / np.linalg.norm(light)
    shade = np.clip(np.abs(normals @ light), 0.15, 1.0)

    zbuf = np.full((height, width), np.inf, np.float64)
    img = np.zeros((height, width, 3), np.float64)
    mask = np.zeros((height, width), bool)
    color = np.asarray(base_color, np.float64)
    # faces touching the near plane are culled, as the library does: a
    # z-clamped vertex behind the camera would project far off the frame
    ok_faces = (verts[faces][:, :, 2] > 1e-6).all(1)
    for f in np.argsort(-tri_z.mean(1)):
        if not ok_faces[f]:
            continue
        t = tri[f]
        x0, y0 = np.floor(t.min(0)).astype(int)
        x1, y1 = np.ceil(t.max(0)).astype(int)
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1 + 1, width), min(y1 + 1, height)
        if x0 >= x1 or y0 >= y1:
            continue
        xs_g, ys_g = np.meshgrid(np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5)
        a, b, c = t
        den = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if abs(den) < 1e-12:
            continue
        w0 = ((b[1] - c[1]) * (xs_g - c[0]) + (c[0] - b[0]) * (ys_g - c[1])) / den
        w1 = ((c[1] - a[1]) * (xs_g - c[0]) + (a[0] - c[0]) * (ys_g - c[1])) / den
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        zv = w0 * tri_z[f, 0] + w1 * tri_z[f, 1] + w2 * tri_z[f, 2]
        sub_z = zbuf[y0:y1, x0:x1]
        closer = inside & (zv < sub_z)
        sub_z[closer] = zv[closer]
        img[y0:y1, x0:x1][closer] = color * shade[f] * 255.0
        mask[y0:y1, x0:x1] |= closer
    return img, mask


def view_vertices(verts, view: str = "front") -> np.ndarray:
    """``verts`` [V, 3] turned to ``view`` about their centroid, y flipped
    to the image's and pushed ``CAMERA_DISTANCE`` along z (an unknown view
    is the front)."""
    verts = np.asarray(verts, np.float64)
    pitch, yaw = VIEW_ANGLES.get(view, (0.0, 0.0))
    v = (verts - verts.mean(0)) @ (_rot_x(pitch) @ _rot_y(yaw)).T
    v[:, 1] *= -1
    v[:, 2] += CAMERA_DISTANCE
    return v


def render_mesh(bg_img: np.ndarray, verts, faces, cam_param: dict,
                view: str = "front") -> np.ndarray:
    """The mesh in ``view`` over ``bg_img`` [H, W, 3] -> float64 [H, W, 3]
    (ref visual.py:132-214). ``cam_param`` holds ``focal`` and ``princpt``."""
    h, w = bg_img.shape[:2]
    rgb, mask = rasterize_mesh(view_vertices(verts, view), np.asarray(faces, np.int64), h, w,
                          cam_param["focal"], cam_param["princpt"])
    out = np.asarray(bg_img, np.float64).copy()
    out[mask] = rgb[mask]
    return out


def save_obj(verts, faces, path: str):
    """A plain OBJ file (ref visual.py:122-129)."""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write("v %.6f %.6f %.6f\n" % (v[0], v[1], v[2]))
        for face in np.asarray(faces) + 1:
            f.write("f %d %d %d\n" % (face[0], face[1], face[2]))


def vis_skeletons(joints3d, output_path: str, skeleton=None):
    """One matplotlib 3D skeleton PNG a frame of ``joints3d`` [T, J, 3] or
    [J, 3], ``skeleton_{i:04d}.png`` (ref visual.py:18-119)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if skeleton is None:
        skeleton = get_smpl_skeleton()
    os.makedirs(output_path, exist_ok=True)
    joints3d = np.asarray(joints3d)
    if joints3d.ndim == 2:
        joints3d = joints3d[None]
    for i, joints in enumerate(joints3d):
        fig = plt.figure(figsize=(4, 4))
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(joints[:, 0], joints[:, 1], joints[:, 2], s=8)
        for a, b in skeleton:
            if a < len(joints) and b < len(joints):
                ax.plot(*np.stack([joints[a], joints[b]], 1), c="steelblue")
        ax.view_init(elev=10, azim=-90)
        plt.savefig(os.path.join(output_path, f"skeleton_{i:04d}.png"), dpi=100)
        plt.close(fig)


def get_smpl_skeleton() -> np.ndarray:
    """The 22-joint SMPL kinematic edges (ref lib/body_model/utils.py:180-205)."""
    return np.array([
        [0, 1], [0, 2], [0, 3], [1, 4], [2, 5], [3, 6], [4, 7], [5, 8],
        [6, 9], [7, 10], [8, 11], [9, 12], [9, 13], [9, 14], [12, 15],
        [13, 16], [14, 17], [16, 18], [17, 19], [18, 20], [19, 21]])


@torch.no_grad()
def body_meshes(samples: torch.Tensor, normalizer, body_model, convert: bool = True) -> tuple:
    """``samples`` [B, D] (normalized, or axis-angle with ``convert`` False
    or no normalizer) -> (vertices [B, V, 3], faces [F, 3]) as numpy: the
    denormalization and the body model run on the samples' device, and the
    meshes come to the host in one copy."""
    if normalizer is not None and convert:
        samples = normalizer.offline_denormalize(samples, to_axis=True)
    out = body_model(pose_body=samples)
    return out.v.cpu().numpy(), out.f.cpu().numpy()


def multiple_render(samples, normalizer, body_model, target_path: str,
                    name_fmt: str = "sample{}.png", convert: bool = True, bg_img=None,
                    focal=(1500, 1500), princpt=(200, 192), idx_map=None,
                    view: str = "front", faster: bool = False, device=None):
    """Denormalize, run the body model and render each sample to
    ``target_path/name_fmt.format(idx)`` (ref visual.py:231-249).
    ``samples`` is a tensor [B, D] on the body model's device (or anything
    ``torch.as_tensor`` takes, moved there); ``faster`` and ``device`` are
    the reference's signature and not read."""
    import cv2

    os.makedirs(target_path, exist_ok=True)
    if bg_img is None:
        bg_img = np.ones([512, 384, 3]) * 255
    samples = torch.as_tensor(samples, dtype=torch.float32,
                              device=body_model.v_template.device)
    meshes, faces = body_meshes(samples, normalizer, body_model, convert)
    for i in range(len(meshes)):
        img = render_mesh(bg_img, meshes[i], faces, {"focal": focal, "princpt": princpt},
                          view=view)
        idx = idx_map[i] if idx_map is not None else i
        cv2.imwrite(os.path.join(target_path, name_fmt.format(idx)), img.astype(np.uint8))


def write_video(frames, video_path: str, fps: int):
    """``frames`` (each [H, W, 3], 0-255 BGR) as an mp4v video."""
    import cv2

    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        out.write(np.asarray(f).astype(np.uint8))
    out.release()
    print(f"Video saved at {video_path}")


def seq_to_video(render_dir: str, merge_dir: str, video_path: str, fps: int = 30,
                 prefixes=("gt", "out")):
    """Per-frame renders ``<prefix>_*.png`` merged side by side into
    ``merge_dir/merge_{i:04d}.png`` and a video (ref
    lib/utils/motion_video.py:89-130)."""
    import cv2

    os.makedirs(merge_dir, exist_ok=True)
    frame_sets = []
    for p in prefixes:
        frames = sorted(glob.glob(os.path.join(render_dir, f"{p}_*.png")))
        if frames:
            frame_sets.append(frames)
    if not frame_sets:
        print(f"no frames found under {render_dir}")
        return
    n = min(len(fs) for fs in frame_sets)
    first = cv2.imread(frame_sets[0][0])
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w * len(frame_sets), h))
    for i in range(n):
        row = np.concatenate([cv2.imread(fs[i]) for fs in frame_sets], axis=1)
        cv2.imwrite(os.path.join(merge_dir, f"merge_{i:04d}.png"), row)
        writer.write(row.astype(np.uint8))
    writer.release()
    print(f"Video saved at {video_path}")
