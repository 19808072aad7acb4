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
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=64, embed_dim=32,
                         n_blocks=1, scale_by_sigma=False, num_scales=50)
    sd = model.state_dict()
    shadow = [sd[name].clone() * 0.5 for name in torch_parameter_order(1)]
    torch.save({"model_state_dict": sd, "optimizer_state_dict": {}, "epoch": 0,
                "step": 7, "ema": {"decay": 0.999, "num_updates": 7,
                                   "shadow_params": shadow}}, tmp / "tiny.pth")
    stats = make_stats_dir(tmp / "stats", mean=np.full(63, 0.1), std=np.full(63, 0.2))
    smpl, _ = make_synthetic_body_model(tmp / "smpl.npz", "smpl")
    return dict(tmp=tmp, stats=stats, smpl=smpl)


def _args(w, out, *extra):
    return ["--task", "generation", "--device", "cpu",
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
