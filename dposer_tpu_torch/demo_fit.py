"""The single-image HMR demo on the card (port of ``run/demo_fit.py``):
OpenPose keypoints -> bbox -> camera -> SMPLify with the DPoser prior ->
the fitted mesh rendered over the image.

    python -m dposer_tpu_torch.demo_fit --img image.jpg --openpose keypoints.json \\
        --ckpt-path artifacts/trained_r5/axis-zscore-400k-synth.pth \\
        --stats-dir artifacts/trained_r5/stats --bodymodel-path SMPLX_NEUTRAL.npz \\
        [--outdir output/test_results/hmr] [--device cpu]

One person in one image: the body starts from the mean pose and shape at the
camera translation the keypoints' bbox implies (crop camera (1.3, 0, 0)),
and SMPLify fits it in 100 + 5 x 100 Adam steps. The CLI prints the
re-projection loss of the hips and shoulders before the fit and SMPLify's
summed loss after it (ref :104-139), and writes ``<outdir>/fit_result.npz``
(``pose`` [1, 66], ``betas`` [1, 10], ``cam_t`` [1, 3]) and the overlay
``<outdir>/mesh_fit.jpg`` (the native rasterizer's front view over the
image). The image is read and the overlay written with ``cv2``; ``fit_image``
fits an image array and an OpenPose dict without it (``cv2`` is imported only
by ``main``). As in the JAX CLI, a render that fails prints ``[skip render]``
and the fit is still written.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .body_model import constants
from .body_model.fitting_losses import perspective_projection
from .body_model.smplx_fit import SMPLXFit
from .body_model.visual import render_mesh
from .data.mocap import MocapDataset
from .data.preprocess import compute_bbox
from .ops.rotations import cam_crop2full
from .smplify import build_dposer_prior, cli_device
from .tasks.smplify import SMPLify

N_POSES = 22  # the global orientation and the 21 body joints
CROP_CAM = (1.3, 0.0, 0.0)  # the weak-perspective crop camera of the init (ref :80)
REPROJ_JOINTS = ("OP RHip", "OP LHip", "OP RShoulder", "OP LShoulder")


def parse_args(argv):
    p = argparse.ArgumentParser(description="fit SMPL-X with the DPoser prior to one image's "
                                            "OpenPose keypoints, on the GPU")
    p.add_argument("--dataset-folder", default="../data/AMASS/amass_processed")
    p.add_argument("--version", default="version1")
    p.add_argument("--stats-dir", default=None,
                   help="normalizer stats directory (default: "
                        "<dataset-folder>/<version>/train)")
    p.add_argument("--ckpt-path", default="./pretrained_models/axis-zscore-400k.pth")
    p.add_argument("--bodymodel-path", default="../body_models/smplx/SMPLX_NEUTRAL.npz")
    p.add_argument("--config-path", default=None,
                   help="Python file with get_config() (default: the flagship config)")
    p.add_argument("--sde-N", type=int, default=500)
    p.add_argument("--time-strategy", default="3", choices=["1", "2", "3"])
    p.add_argument("--img", required=True)
    p.add_argument("--openpose", default=None)
    p.add_argument("--outdir", default="./output/test_results/hmr")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=42)
    return p.parse_args(argv)


def reprojection_loss(smpl, pose, betas, cam_t, focal_length, camera_center, kpts) -> float:
    """The squared 2D error of the hips and shoulders of image 0 (ref
    :104-139): ``kpts`` [1, 49, 3] numpy."""
    with torch.no_grad():
        out = smpl(betas=betas, body_pose=pose[:, 3:], global_orient=pose[:, :3], transl=cam_t)
        rot = torch.eye(3, device=pose.device).expand(pose.shape[0], 3, 3)
        kp2d = perspective_projection(out.joints, rot, cam_t, focal_length,
                                      camera_center).cpu().numpy()
    idx = np.array([constants.JOINT_IDS[j] for j in REPROJ_JOINTS])
    return float(((kpts[0, idx, :2] - kp2d[0, idx]) ** 2).sum())


def fit_image(args, img: np.ndarray, json_data: dict, device,
              generator: torch.Generator = None, smpl: SMPLXFit = None) -> dict:
    """Fit the one person of ``json_data`` (an OpenPose dict) in ``img`` [H,
    W, 3]: returns ``pose`` [1, 66], ``betas`` [1, 10], ``cam_t`` [1, 3],
    ``loss`` (SMPLify's final loss [1, 49]), ``vertices`` [V, 3] and
    ``faces`` of the fitted mesh (numpy), ``focal_length`` and the
    hip-and-shoulder re-projection loss before and after the fit,
    ``init_reproj`` and ``final_reproj``."""
    device = torch.device(device)
    smpl = smpl if smpl is not None else SMPLXFit(args.bodymodel_path, device=device)
    keypoints = np.array(json_data["people"][0]["pose_keypoints_2d"]).reshape(25, 3)
    bboxes = compute_bbox(json_data)
    if len(bboxes) != 1:
        raise ValueError(f"the demo fits a single person in a single image; the keypoints "
                         f"hold {len(bboxes)}")
    cams = {k: torch.as_tensor(v, device=device)
            for k, v in MocapDataset([img], bboxes, body_model=smpl.bm).cameras().items()}
    kpts = np.zeros((1, 49, 3), np.float32)
    kpts[0, :25] = keypoints
    init_cam_t = cam_crop2full(torch.tensor([CROP_CAM], device=device), cams["center"],
                               cams["scale"], torch.stack((cams["img_h"], cams["img_w"]), -1),
                               cams["focal_length"])
    poses = smpl.mean_poses[:N_POSES * 3][None].clone()
    betas = smpl.mean_shape[None].clone()
    camera_center = torch.stack([cams["img_w"], cams["img_h"]], -1) / 2
    focal = cams["focal_length"]
    init_reproj = reprojection_loss(smpl, poses, betas, init_cam_t, focal, camera_center, kpts)
    print("initial re-projection loss", init_reproj)

    prior = build_dposer_prior(args, batch_size=1, device=device)
    smplify = SMPLify(smpl, pose_prior=prior, step_size=1e-2, batch_size=1, num_iters=100,
                      focal_length=float(focal[0]), time_strategy=args.time_strategy,
                      sde_N=args.sde_N)
    new_pose, new_betas, new_cam_t, new_loss = smplify(
        poses, betas, init_cam_t, camera_center, torch.as_tensor(kpts, device=device),
        generator=generator)
    print("after re-projection loss", float(new_loss.sum()))
    with torch.no_grad():
        out = smpl(betas=new_betas, body_pose=new_pose[:, 3:], global_orient=new_pose[:, :3],
                   transl=new_cam_t)
    return dict(pose=new_pose.cpu().numpy(), betas=new_betas.cpu().numpy(),
                cam_t=new_cam_t.cpu().numpy(), loss=new_loss.cpu().numpy(),
                vertices=out.vertices[0].cpu().numpy(), faces=smpl.faces.cpu().numpy(),
                focal_length=float(focal[0]), init_reproj=init_reproj,
                final_reproj=reprojection_loss(smpl, new_pose, new_betas, new_cam_t, focal,
                                               camera_center, kpts))


def overlay(img: np.ndarray, fit: dict) -> np.ndarray:
    """The fitted mesh's front view over ``img`` (ref :118-125), float64."""
    h, w = img.shape[:2]
    f = fit["focal_length"]
    return render_mesh(img.astype(np.float64), fit["vertices"], fit["faces"],
                       {"focal": (f, f), "princpt": (w / 2, h / 2)}, view="front")


def run(args) -> dict:
    """Read the image and keypoints, fit, write the overlay and the fit;
    returns ``fit_image``'s dict with ``fit_file`` and, when the render
    succeeded, ``overlay_file``."""
    import cv2

    device = cli_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    img = cv2.imread(args.img)
    if img is None:
        raise FileNotFoundError(f"cannot read the image {args.img}")
    with open(args.openpose) as f:
        json_data = json.load(f)
    fit = fit_image(args, img, json_data, device, generator)
    try:
        path = os.path.join(args.outdir, "mesh_fit.jpg")
        cv2.imwrite(path, overlay(img, fit).astype(np.uint8))
        fit["overlay_file"] = path
        print(f"overlay saved under {args.outdir}")
    except Exception as e:  # the JAX CLI's handling (ref :115-128)
        print(f"[skip render] {e}")
    fit["fit_file"] = os.path.join(args.outdir, "fit_result.npz")
    np.savez(fit["fit_file"], pose=fit["pose"], betas=fit["betas"], cam_t=fit["cam_t"])
    return fit


def main(argv=None) -> int:
    run(parse_args(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
