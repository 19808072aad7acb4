"""``python -m dposer_tpu_torch.demo`` end to end on the CPU: a tiny config
and a tiny reference-schema checkpoint, the plain versions of the kernels."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.utils.checkpoint import torch_parameter_order

from fixtures import make_stats_dir, make_synthetic_body_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_CONFIG = '''
from dposer_tpu_torch.config import get_config as _flagship


def get_config():
    c = _flagship()
    c.model.HIDDEN_DIM, c.model.EMBED_DIM, c.model.N_BLOCKS = 64, 32, 1
    c.model.num_scales = 50      # the sub-VP grid: 50 steps
    c.model.scale_by_sigma = False
    return c
'''


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_demo")
    (tmp / "tiny_config.py").write_text(TINY_CONFIG)
    (tmp / "tiny_config_lgv.py").write_text(TINY_CONFIG.replace(
        "    return c", "    c.sampling.corrector = 'langevin'\n    return c"))
    # the generic score function labels the model with t*999, so its sigma
    # table needs the full 1000 entries
    (tmp / "tiny_config_n1000.py").write_text(TINY_CONFIG.replace(
        "num_scales = 50", "num_scales = 1000").replace(
        "    return c", "    c.model.beta_max = 1.0  # a tame field: fewer adaptive steps\n"
                        "    return c"))
    (tmp / "tiny_config_ode.py").write_text(TINY_CONFIG.replace(
        "    return c", "    c.sampling.method = 'ode'\n    return c"))
    for ckpt, num_scales in (("tiny.pth", 50), ("tiny_n1000.pth", 1000)):
        torch.manual_seed(0)
        model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=64, embed_dim=32,
                             n_blocks=1, scale_by_sigma=False, num_scales=num_scales)
        sd = model.state_dict()
        shadow = [sd[name].clone() * 0.5 for name in torch_parameter_order(1)]
        torch.save({"model_state_dict": sd, "optimizer_state_dict": {}, "epoch": 0,
                    "step": 7, "ema": {"decay": 0.999, "num_updates": 7,
                                       "shadow_params": shadow}}, tmp / ckpt)
    stats = make_stats_dir(tmp / "stats", mean=np.full(63, 0.1), std=np.full(63, 0.2))
    smpl, _ = make_synthetic_body_model(tmp / "smpl.npz", "smpl")
    smplx, _ = make_synthetic_body_model(tmp / "smplx.npz", "smplx")
    poses = 0.1 + 0.2 * np.random.default_rng(0).normal(size=(8, 63)).astype(np.float32)
    np.savez(tmp / "poses.npz", pose_samples=poses)
    np.savez(tmp / "poses20.npz", pose_samples=0.1 + 0.2 * np.random.default_rng(1).normal(
        size=(20, 63)).astype(np.float32))
    return dict(tmp=tmp, stats=stats, smpl=smpl, smplx=smplx, poses=str(tmp / "poses.npz"))


def _args(w, out, *extra, task="generation"):
    return ["--task", task, "--device", "cpu",
            "--config-path", str(w["tmp"] / "tiny_config.py"),
            "--ckpt-path", str(w["tmp"] / "tiny.pth"), "--stats-dir", w["stats"],
            "--output-path", str(out), "--seed", "3", *extra]


def test_demo_generation_and_metrics(workdir):
    out = workdir["tmp"] / "out"
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo",
                        *_args(workdir, out, "--metrics", "--smpl-path", workdir["smpl"])],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "(step 7)" in p.stdout
    with np.load(out / "generation" / "samples.npz") as f:
        poses = f["pose_samples"]
    assert poses.shape == (50, 63) and np.isfinite(poses).all()
    m = re.search(r"average_pairwise_distance for 500 generated samples (\S+)", p.stdout)
    assert m and np.isfinite(float(m.group(1))) and float(m.group(1)) > 0
    m = re.search(r"self-intersections percentage for 500 generated samples (\S+)", p.stdout)
    assert m and 0.0 <= float(m.group(1)) <= 100.0
    assert "protocol segment wall (build+sample+APD+SI, chunks=1)" in p.stdout


def test_demo_metrics_chunks(workdir):
    """``--metrics-chunks 4``: four chunks of 125 poses, SI on a worker thread;
    both metric lines. A count that does not divide 500 exits non-zero."""
    out = workdir["tmp"] / "out_chunks"
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo",
                        *_args(workdir, out, "--metrics", "--smpl-path", workdir["smpl"],
                               "--metrics-chunks", "4")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "protocol segment wall (build+sample+APD+SI, chunks=4)" in p.stdout
    apd = re.search(r"average_pairwise_distance for 500 generated samples (\S+)", p.stdout)
    si = re.search(r"self-intersections percentage for 500 generated samples (\S+)", p.stdout)
    assert apd and np.isfinite(float(apd.group(1))) and float(apd.group(1)) > 0
    assert si and 0.0 <= float(si.group(1)) <= 100.0
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo",
                        *_args(workdir, out, "--metrics", "--smpl-path", workdir["smpl"],
                               "--metrics-chunks", "3")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "must divide 500" in p.stdout + p.stderr


def test_demo_never_loads_jax(workdir):
    """The demo's whole path, in a fresh process: torch only."""
    out = workdir["tmp"] / "out_nojax"
    prog = ("import sys\n"
            "from dposer_tpu_torch.demo import main\n"
            f"rc = main({_args(workdir, out)!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'dposer_tpu', 'configs', 'ml_collections')]\n"
            "print('loaded:', bad)\n"
            "sys.exit(rc or (1 if bad else 0))\n")
    p = subprocess.run([sys.executable, "-c", prog], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert (out / "generation" / "samples.npz").exists()


def test_demo_refuses_cuda_without_a_card(workdir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo", "--device", "cuda",
                        "--ckpt-path", str(workdir["tmp"] / "tiny.pth")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "no CUDA device" in p.stdout + p.stderr


@pytest.mark.parametrize("task,extra", [
    ("completion", []),
    ("completion2", ["--sampler", "hybrid", "--sampler-steps", "3", "--hybrid-tail", "5"]),
    ("completion2", ["--sampler", "pc"]),
    ("completion2", ["--sampler", "ddim", "--sampler-steps", "4"]),
    ("completion2", ["--sampler", "dpm", "--sampler-steps", "4"]),
    ("completion2", ["--sampler", "pc", "--config-path", "tiny_config_lgv.py"]),
], ids=["completion", "completion2-hybrid", "completion2-pc", "completion2-ddim",
        "completion2-dpm", "completion2-pc-langevin"])
def test_demo_completion_tasks(workdir, task, extra):
    """Both completion tasks at the tiny config (N = 50, 2 hypotheses): the
    ``.npz`` of hypotheses and both metric lines."""
    out = workdir["tmp"] / f"out_{task}_{'_'.join(extra[1:2])}_{len(extra)}"
    if "--config-path" in extra:  # a config of the work directory, by its name
        extra = [*extra[:-1], str(workdir["tmp"] / extra[-1])]
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo",
                        *_args(workdir, out, "--hypo", "2", "--part", "left_leg",
                               "--file-path", workdir["poses"], "--bodymodel-path",
                               workdir["smplx"], *extra, task=task)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    mv = re.search(r"multihypo 2 MPVPE \(All\): (\S+) mm", p.stdout)
    mj = re.search(r"multihypo 2 MPJPE \(Body\): (\S+) mm", p.stdout)
    assert mv and mj, p.stdout
    if extra[:2] == ["--sampler", "pc"]:  # with or without a corrector: the kernel route
        assert "[sampler] kernel multi-hypothesis imputation" in p.stdout
    assert np.isfinite(float(mv.group(1))) and float(mj.group(1)) > 0
    with np.load(out / "completion" / "hypotheses.npz") as f:
        hypos, mask, gts = f["pose_hypotheses"], f["mask"], f["gts"]
    assert hypos.shape == (8, 2, 63) and np.isfinite(hypos).all()
    assert mask.shape == gts.shape == (8, 63) and int((1 - mask[0]).sum()) == 12
    if task == "completion":  # the solver pastes the observed dims exactly
        np.testing.assert_allclose(hypos[:, 0] * mask, gts * mask, atol=1e-6)


def test_demo_generation_under_an_ode_config(workdir):
    """``sampling.method = "ode"``: the RK4 PF-ODE kernel route (its plain
    loop on the CPU)."""
    out = workdir["tmp"] / "out_ode"
    args = _args(workdir, out)
    args[args.index("--config-path") + 1] = str(workdir["tmp"] / "tiny_config_ode.py")
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo", *args],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "[sampler] kernel RK4 PF-ODE path" in p.stdout
    with np.load(out / "generation" / "samples.npz") as f:
        poses = f["pose_samples"]
    assert poses.shape == (50, 63) and np.isfinite(poses).all()


@pytest.mark.parametrize("extra", [[], ["--adaptive-ode"]], ids=["fast", "adaptive"])
def test_demo_interpolation_task(workdir, extra):
    """Encode six anchors, decode them back and decode 60 slerp frames per
    pair, at the tiny config (N = 50; 1000 for the generic path): the error
    line and the ``.npz``."""
    out = workdir["tmp"] / f"out_interp{len(extra)}"
    args = _args(workdir, out, "--file-path", str(workdir["tmp"] / "poses20.npz"), *extra,
                 task="interpolation")
    if extra:
        args[args.index("--config-path") + 1] = str(workdir["tmp"] / "tiny_config_n1000.py")
        args[args.index("--ckpt-path") + 1] = str(workdir["tmp"] / "tiny_n1000.pth")
    # tiny tensors, thousands of calls: one thread is fastest beside other workers
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo", *args],
                       cwd=REPO, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stdout + p.stderr
    assert ("[ode] adaptive RK45 encode" if extra else
            "[ode] tabled fixed-grid RK4 encode") in p.stdout
    assert ("[ode] generic PF-Euler decode" if extra else
            "[ode] kernel PF-Euler decode") in p.stdout
    m = re.search(r"reconstruction mean abs err \(normalized space\): (\S+)", p.stdout)
    assert m and np.isfinite(float(m.group(1)))
    with np.load(out / "interpolation" / "frames.npz") as f:
        frames, anchors, recon = f["pose_frames"], f["anchors"], f["recon"]
    assert frames.shape == (5, 60, 63) and np.isfinite(frames).all()
    assert anchors.shape == recon.shape == (6, 63)
    with np.load(workdir["tmp"] / "poses20.npz") as f:
        np.testing.assert_array_equal(anchors, f["pose_samples"][[1, 10, 11, 12, 17, 14]])
    # a pair's first and last frames decode the anchors' own latents
    np.testing.assert_allclose(frames[:, 0], recon[:5], atol=1e-4)
    np.testing.assert_allclose(frames[:, -1], recon[1:], atol=1e-4)
    # the coarse Euler decode of an untrained net is no inverse of the encode;
    # it must still move with the latent: neighbouring frames differ, and little
    step = np.abs(np.diff(frames, axis=1)).max()
    assert 0 < step < np.abs(frames[:, 0] - frames[:, -1]).max()


def test_demo_interpolation_needs_enough_poses(workdir):
    out = workdir["tmp"] / "out_interp_short"
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo",
                        *_args(workdir, out, "--file-path", workdir["poses"],
                               task="interpolation")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "anchors" in p.stdout + p.stderr


def test_demo_view_task(workdir):
    """``--task view``: the poses of ``--file-path`` rendered as they are
    through the SMPL-X body, one PNG a pose, in the ``--view`` preset."""
    out = workdir["tmp"] / "out_view"
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo",
                        *_args(workdir, out, "--file-path", workdir["poses"], "--bodymodel-path",
                               workdir["smplx"], "--view", "left", task="view")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    names = sorted(os.listdir(out / "view"))
    assert names == sorted(f"GT_sample{i}.png" for i in range(8))
    # without the body model the view task raises, as JAX's does
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo",
                        *_args(workdir, out, "--file-path", workdir["poses"], task="view")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "FileNotFoundError" in p.stderr


def test_demo_generation_process_task(workdir):
    """``--task generation_process``: the kernel sampler (its plain versions
    here) records steps 9, 19, ... of the N = 50 grid; one 5-frame video a
    pose, 3 poses."""
    out = workdir["tmp"] / "out_process"
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo",
                        *_args(workdir, out, "--bodymodel-path", workdir["smplx"],
                               task="generation_process")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "[sampler] kernel sampler recording steps 9, 19" in p.stdout
    import cv2

    for i in range(3):
        cap = cv2.VideoCapture(str(out / "generation_process" / f"generation_process{i}.mp4"))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
        ok, frame = cap.read()
        assert ok and frame.shape == (512, 384, 3)


def test_demo_generation_renders_on_the_plain_route(workdir):
    """A corrector outside the kernels' scope (ald) samples on the plain PC
    loop, and generation renders its 50 samples through the body model;
    without the body model it skips the renders, as JAX's demo does."""
    # the generic score function labels with t*999: the 1000-entry sigma table
    (workdir["tmp"] / "tiny_config_ald.py").write_text(
        (workdir["tmp"] / "tiny_config_n1000.py").read_text().replace(
            "    return c", "    c.sampling.corrector = 'ald'\n    return c"))
    out = workdir["tmp"] / "out_ald"
    args = _args(workdir, out, "--bodymodel-path", workdir["smplx"])
    args[args.index("--config-path") + 1] = str(workdir["tmp"] / "tiny_config_ald.py")
    args[args.index("--ckpt-path") + 1] = str(workdir["tmp"] / "tiny_n1000.pth")
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo", *args],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "[sampler] plain PC loop (predictor=euler_maruyama, corrector=ald)" in p.stdout
    names = os.listdir(out / "generation")
    assert len([n for n in names if n.startswith("generated_sample")]) == 50
    with np.load(out / "generation" / "samples.npz") as f:
        assert f["pose_samples"].shape == (50, 63) and np.isfinite(f["pose_samples"]).all()
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo",
                        *_args(workdir, workdir["tmp"] / "out_skip")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "[skip renders] body model unavailable" in p.stdout


def test_demo_interpolation_video(workdir):
    """``--task interpolation --video``: one 60 fps video of the 5 x 60
    decoded frames, beside ``frames.npz``."""
    out = workdir["tmp"] / "out_interp_video"
    args = _args(workdir, out, "--file-path", str(workdir["tmp"] / "poses20.npz"), "--video",
                 "--bodymodel-path", workdir["smplx"], task="interpolation")
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.demo", *args],
                       cwd=REPO, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stdout + p.stderr
    import cv2

    cap = cv2.VideoCapture(str(out / "interpolation" / "interpolation_video.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 300
    assert cap.get(cv2.CAP_PROP_FPS) == 60
    with np.load(out / "interpolation" / "frames.npz") as f:
        assert f["pose_frames"].shape == (5, 60, 63)
