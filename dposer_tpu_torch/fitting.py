"""The EHF-layout HMR evaluation on the card (port of ``run/fitting.py``):
SMPLify with the DPoser prior on each image's OpenPose keypoints, and the
PA- and pelvis-aligned MPJPE against the ground-truth ``.ply`` scans.

    python -m dposer_tpu_torch.fitting --data-dir <EHF dir> \\
        --ckpt-path artifacts/trained_r5/axis-zscore-400k-synth.pth \\
        --stats-dir artifacts/trained_r5/stats --bodymodel-path SMPLX_NEUTRAL.npz \\
        [--report-init-baseline] [--device cpu]

``--data-dir`` holds ``*_img.jpg`` (or ``.png``), ``*_2Djnt.json`` and
``*_align.ply`` per image; the images are read with ``cv2``, which this
entry point needs (the library underneath does not). ``--batch-images``
images are fitted as one batch (they share each step's time draw; each is
evaluated on its own); every image starts from the mean pose, or from the
bend pose when its keypoints' bbox starts below row 400 (a seated subject,
ref :71), at the camera translation the manual EHF bbox implies. Each fit is
written to ``<outdir>/<name>_fit.npz``. A batch's images split over this
process's cards (``parallel.make_mesh``; ``run(args, mesh=)`` names other
devices), which it prints when there are several; the fit draws its times
and normals for the whole batch before it splits them, so the results are
those of one device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from glob import glob

import numpy as np
import torch

from .body_model import constants
from .body_model.smplx_fit import SMPLXFit
from .data.mocap import MocapDataset
from .data.preprocess import compute_bbox
from .ops.rotations import cam_crop2full
from .parallel import make_mesh, mesh_route
from .smplify import build_dposer_prior, cli_device
from .tasks.smplify import SMPLify

N_POSES = 22  # the global orientation and the 21 body joints
EHF_BBOX = (400, 100, 1000, 1200)  # the manual EHF bbox (ref :72)
CROP_CAM = (0.9, 0.0, 0.0)  # the weak-perspective crop camera of the init


def parse_args(argv):
    p = argparse.ArgumentParser(description="SMPLify with the DPoser prior on EHF-layout "
                                            "images, on the GPU")
    p.add_argument("--dataset-folder", default="./data/AMASS/amass_processed")
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
    p.add_argument("--data-dir", required=True)
    p.add_argument("--outdir", default="lifting_results/output")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--step-size", type=float, default=1e-2,
                   help="Adam step of SMPLify's body stage (ref run/smplify.py:140)")
    p.add_argument("--cam-step-size", type=float, default=1e-2,
                   help="Adam step of the camera stage (the reference uses one step for "
                        "both stages)")
    p.add_argument("--num-iters", type=int, default=100,
                   help="iterations a stage (the body stage has 5)")
    p.add_argument("--report-init-baseline", action="store_true",
                   help="also evaluate the unfitted init (mean or bend pose at the "
                        "bbox-implied camera translation) and print its PA-MPJPE and MPJPE")
    p.add_argument("--batch-images", type=int, default=16,
                   help="images fitted as one batch")
    return p.parse_args(argv)


def init_camera(center, scale, img_h, img_w, focal_length):
    """The camera translation [B, 3] the fit starts from: the crop camera
    ``CROP_CAM`` of each image's bbox (``center`` [B, 2], ``scale`` [B])
    in the full image, and the principal points [B, 2], the image centres."""
    B = center.shape[0]
    crop = torch.tensor([CROP_CAM], dtype=center.dtype, device=center.device).expand(B, 3)
    cam_t = cam_crop2full(crop, center, scale, torch.stack((img_h, img_w), -1), focal_length)
    return cam_t, torch.stack([img_w, img_h], -1) / 2


def run(args, mesh=None) -> dict:
    """Fit every image; returns the per-image ``pa_mpjpe_body`` and
    ``mpjpe_body`` in mm, and with ``--report-init-baseline`` the init's as
    ``init_pa_mpjpe_body`` and ``init_mpjpe_body``. ``mesh`` is the devices a
    batch's images split over, by default the process's visible CUDA devices
    on ``--device cuda`` and the CPU on ``--device cpu``."""
    import cv2

    device = cli_device(args.device)
    if mesh is None:
        mesh = make_mesh() if device.type == "cuda" else make_mesh(devices=[device])
    mesh, _ = mesh_route(mesh, device)
    if mesh is not None:
        print(f"batched images data-parallel over {mesh.size} devices")
    os.makedirs(args.outdir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    smpl = SMPLXFit(args.bodymodel_path, device=device)
    img_paths = sorted(glob(f"{args.data_dir}/*_img.jpg") or glob(f"{args.data_dir}/*_img.png"))
    json_paths = sorted(glob(f"{args.data_dir}/*_2Djnt.json"))
    gt_ply_paths = sorted(glob(f"{args.data_dir}/*_align.ply"))
    all_eval = {"pa_mpjpe_body": [], "mpjpe_body": []}
    init_eval = {"pa_mpjpe_body": [], "mpjpe_body": []}
    with np.load(constants.BEND_POSE_PATH) as f:
        bend_pose = torch.as_tensor(f["pose"][0, :N_POSES * 3], dtype=torch.float32,
                                    device=device)
    items = list(zip(img_paths, json_paths, gt_ply_paths))
    priors, fitters = {}, {}
    for c0 in range(0, len(items), args.batch_images):
        chunk = items[c0:c0 + args.batch_images]
        B = len(chunk)
        imgs, kpts49, bends, names = [], [], [], []
        for img_path, json_path, _ in chunk:
            imgs.append(cv2.imread(img_path))
            with open(json_path) as f:
                json_data = json.load(f)
            row = np.zeros((49, 3), np.float32)
            row[:25] = np.array(json_data["people"][0]["pose_keypoints_2d"]).reshape(25, 3)
            kpts49.append(row)
            # bbox min_y > 400: the subject sits low in the frame, seated
            bends.append(compute_bbox(json_data)[0, 2] > 400)
            names.append(os.path.splitext(os.path.basename(img_path))[0])
        det = np.concatenate([np.arange(B, dtype=np.float32)[:, None],
                              np.tile([EHF_BBOX], (B, 1))], axis=1)
        mocap_db = MocapDataset(imgs, det, body_model=smpl.bm)
        batch = mocap_db.batch()
        if not np.allclose(batch["focal_length"], batch["focal_length"][0]):
            raise ValueError("images with different sizes in one batch; use --batch-images 1")
        t = {k: torch.as_tensor(batch[k], device=device)
             for k in ("center", "scale", "img_h", "img_w", "focal_length")}
        init_cam_t, camera_center = init_camera(t["center"], t["scale"], t["img_h"],
                                                t["img_w"], t["focal_length"])
        poses = smpl.mean_poses[:N_POSES * 3].expand(B, -1).clone()
        poses[torch.as_tensor(bends, device=device)] = bend_pose
        betas = smpl.mean_shape.expand(B, -1).clone()
        keypoints = torch.as_tensor(np.stack(kpts49), device=device)

        fkey = (round(float(batch["focal_length"][0]), 3), B)
        if fkey not in fitters:
            if B not in priors:
                priors[B] = build_dposer_prior(args, batch_size=B)
            fitters[fkey] = SMPLify(smpl, pose_prior=priors[B], step_size=args.step_size,
                                    cam_step_size=args.cam_step_size, batch_size=B,
                                    num_iters=args.num_iters, focal_length=fkey[0],
                                    time_strategy=args.time_strategy, sde_N=args.sde_N,
                                    mesh=mesh, replica=lambda dev, B=B: (
                                        SMPLXFit(args.bodymodel_path, device=dev),
                                        build_dposer_prior(args, batch_size=B, device=dev)))
        fit = [r.cpu().numpy() for r in fitters[fkey](poses, betas, init_cam_t,
                                                       camera_center, keypoints,
                                                       generator=generator)]
        init = [r.cpu().numpy() for r in (poses, betas, init_cam_t)]
        for i, (_, _, ply) in enumerate(chunk):
            if args.report_init_baseline:
                r = mocap_db.eval_EHF([a[i:i + 1] for a in init], ply)
                for k in init_eval:
                    init_eval[k].extend(r[k])
            one = [a[i:i + 1] for a in fit]
            r = mocap_db.eval_EHF(one, ply)
            mocap_db.print_eval_result(r)
            for k in all_eval:
                all_eval[k].extend(r[k])
            np.savez(os.path.join(args.outdir, f"{names[i]}_fit.npz"),
                     pose=one[0], betas=one[1], cam_t=one[2])
    out = dict(all_eval)
    if args.report_init_baseline:
        print("init (unfitted) baseline on whole dataset:")
        MocapDataset.print_eval_result(init_eval)
        out.update({f"init_{k}": v for k, v in init_eval.items()})
    print("results on whole dataset:")
    MocapDataset.print_eval_result(all_eval)
    return out


def main(argv=None) -> int:
    run(parse_args(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
