"""``python -m dposer_tpu_torch.completion`` on the CPU against the JAX
package's ``run.completion``: one batch of the CLI's pipeline against JAX's
with the mask's fill and the perturbation normals injected (a 2-block net
at hidden 128, 8 poses x 2 hypotheses, the full 2 x 100 Adam steps), the
whole CLI against ``python -m run.completion`` on the tiny config of
``tests/test_cli.py`` over a sampled synthetic split, and the refusals
(``tests/test_torch_parallel.py`` runs it as two processes)."""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.body_model.smplx_jax import BodyModel as JaxBodyModel
from dposer_tpu.data import AMASSDataset as JaxAMASSDataset
from dposer_tpu.data import PoseNormalizer as JaxNormalizer
from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.diffusion.score_fn import get_score_fn as jax_get_score_fn
from dposer_tpu.ops.metrics import Evaler as JaxEvaler
from dposer_tpu.tasks import DPoserComp as JaxDPoserComp
from dposer_tpu.utils.masks import create_mask as jax_create_mask
from dposer_tpu_torch import completion as cli
from dposer_tpu_torch.body_model import BodyModel
from dposer_tpu_torch.data import AMASSDataset, PoseNormalizer
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.score_fn import get_score_fn
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.ops.metrics import Evaler
from dposer_tpu_torch.tasks import DPoserComp
from dposer_tpu_torch.utils.checkpoint import torch_parameter_order
from dposer_tpu_torch.utils.masks import part_mask_indices

from fixtures import make_stats_dir, make_synthetic_body_model
from test_torch_model import SMALL, flax_and_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PART = "left_leg"

# the tiny model of tests/test_cli.py (hidden 128, embed 64, one block) at the
# flagship's 1000 sigma scales: the generic score function labels the net
# with t * 999, which the port's sigma table must hold (JAX's gather clamps)
JAX_CONFIG = """
from configs.subvp.amass_scorefc_continuous import get_config as base


def get_config():
    config = base()
    config.model.HIDDEN_DIM = 128
    config.model.EMBED_DIM = 64
    config.model.N_BLOCKS = 1
    return config
"""
TORCH_CONFIG = """
from dposer_tpu_torch.config import get_config as base


def get_config():
    config = base()
    config.model.HIDDEN_DIM, config.model.EMBED_DIM, config.model.N_BLOCKS = 128, 64, 1
    return config
"""


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Small tensors and thousands of small calls: one thread is the fastest
    way through them, above all beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The layout of tests/test_cli.py: a 3,200-pose test split of 0.3 x
    N(0, 1) poses, identity stats, a tiny reference-schema checkpoint, the
    synthetic SMPL-X body."""
    tmp = tmp_path_factory.mktemp("torch_completion_cli")
    rng = np.random.default_rng(0)
    root = tmp / "amass"
    train, test = root / "version1" / "train", root / "version1" / "test"
    test.mkdir(parents=True)
    make_stats_dir(train)
    torch.save(torch.from_numpy((0.3 * rng.normal(size=(3200, 63))).astype(np.float32)),
               test / "pose_body.pt")
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=128, embed_dim=64, n_blocks=1,
                         scale_by_sigma=True, num_scales=1000)
    sd = model.state_dict()
    torch.save({"model_state_dict": sd, "optimizer_state_dict": None, "epoch": 0, "step": 1,
                "ema": {"decay": 0.9999, "num_updates": 1,
                        "shadow_params": [sd[n].clone() for n in torch_parameter_order(1)]}},
               tmp / "tiny.pth")
    body, _ = make_synthetic_body_model(tmp / "SMPLX_NEUTRAL.npz", "smplx")
    (tmp / "jax_config.py").write_text(JAX_CONFIG)
    (tmp / "torch_config.py").write_text(TORCH_CONFIG)
    return dict(tmp=tmp, root=str(root), ckpt=str(tmp / "tiny.pth"), body=body)


def test_batch_pipeline_matches_jax(tmp_path):
    """One batch through ``complete_batch`` (normalize, mask, 2 x 100 Adam
    steps per hypothesis, denormalize, score) against JAX's CLI pipeline:
    the dataset's normalized batch, ``create_mask`` of the batch's mask key,
    ``DPoserComp.optimize`` per hypothesis on the same normals, and
    ``Evaler.multi_eval_bodys`` on JAX's body. The hypotheses to the bound of
    ``test_torch_solver_matches_jax_xla_solver``, the errors to 1e-4."""
    rng = np.random.default_rng(3)
    root = tmp_path / "amass"
    test = root / "v1" / "test"
    test.mkdir(parents=True)
    stats = make_stats_dir(root / "v1" / "train", mean=0.1 * rng.normal(size=63),
                           std=rng.uniform(0.3, 0.6, 63))
    np.save(test / "pose_body.npy", (0.3 * rng.normal(size=(24, 63))).astype(np.float32))
    body, _ = make_synthetic_body_model(tmp_path / "smplx.npz", "smplx")
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True, num_scales=1000))
    js, ts = jsde.SubVPSDE(N=500), tsde.SubVPSDE(N=500)
    B, hypo = 8, 2

    jbatch = next(JaxAMASSDataset(str(root), "v1", subset="test", sample_interval=2,
                                  rot_rep="axis", normalize=True, min_max=False)
                  .eval_batches(B))
    km, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(42), 0))
    jmask, jobs = jax_create_mask(km, jnp.asarray(jbatch), part=PART)
    fill = np.asarray(jax.random.normal(km, (B, len(part_mask_indices(PART, 3))), jnp.float32))
    jcomp = JaxDPoserComp(js, jax_get_score_fn(
        js, lambda x, t: fm.apply({"params": params}, x, t), continuous=True))
    noise = rng.normal(size=(hypo, jcomp.total_steps, B, 63)).astype(np.float32)
    jhyp = jnp.stack([jcomp.optimize(jax.random.PRNGKey(h), jobs, jmask,
                                     noise=jnp.asarray(noise[h])) for h in range(hypo)], 1)
    jnz = JaxNormalizer(stats, normalize=True, min_max=False, rot_rep="axis")
    jpreds = np.asarray(jnz.offline_denormalize(jhyp, to_axis=True))
    jres = JaxEvaler(JaxBodyModel(body), part=PART).multi_eval_bodys(
        jpreds, jnz.offline_denormalize(jnp.asarray(jbatch), to_axis=True))

    batch = next(AMASSDataset(str(root), "v1", subset="test", sample_interval=2,
                              rot_rep="axis", normalize=False).eval_batches(B))
    comp = DPoserComp(ts, get_score_fn(ts, tm), backend="torch", device="cpu")
    preds, res = cli.complete_batch(
        comp, PoseNormalizer(stats, normalize=True, min_max=False, rot_rep="axis"),
        Evaler(BodyModel(body, model_type="smplx"), part=PART), batch, PART, hypo, None,
        fill=torch.from_numpy(fill), noise=torch.from_numpy(noise))
    assert preds.shape == (B, hypo, 63)
    np.testing.assert_allclose(preds.numpy(), jpreds, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(jpreds).max()))
    for k in ("mpvpe_all", "mpjpe_body"):
        np.testing.assert_allclose(res[k], jres[k], rtol=1e-4, err_msg=k)


def _averages(text):
    return {k: float(re.search(rf"The average of {k} is (\S+)", text).group(1))
            for k in ("mpvpe_all", "mpjpe_body")}


def test_cli_against_jax_cli(workdir, capsys):
    """The whole split (every 40th pose: 5 batches of 16, 2 hypotheses, N =
    50) through both CLIs. Their draws differ, so the averages are compared
    as distributions: within four standard errors of their difference."""
    w = workdir
    common = ["--ckpt-path", w["ckpt"], "--dataset-folder", w["root"], "--version",
              "version1", "--bodymodel-path", w["body"], "--part", PART, "--hypo", "2",
              "--batch_size", "16", "--steps", "50", "--sample", "40"]
    env = dict(os.environ, DPOSER_PLATFORM="cpu")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "-m", "run.completion", "--config",
                        str(w["tmp"] / "jax_config.py"), *common],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    ref = _averages(p.stdout + p.stderr)
    out = cli.run(cli.parse_args(["--device", "cpu", "--config-path",
                                  str(w["tmp"] / "torch_config.py"), *common]))
    printed = capsys.readouterr().out
    assert "[completion] autograd Adam-loop solver" in printed
    assert out["n_batches"] == 5 and out["mpjpe_body"].shape == (80,)
    for k, v in _averages(printed).items():
        assert v == pytest.approx(float(np.mean(out[k])))
        # the standard error of the difference of two 80-sample means,
        # from the port's per-sample spread (measured: 1.6 and 1.1 of them)
        se = float(np.std(out[k])) * np.sqrt(2 / len(out[k]))
        assert np.isfinite(v) and abs(v - ref[k]) < 4 * se, (k, v, ref[k], se)


@pytest.mark.parametrize("flags", [["--multihost"], ["--num-processes", "2"],
                                   ["--device", "cuda"]])
def test_cli_refusals(workdir, flags, monkeypatch):
    """``--multihost`` with neither a coordinator nor torchrun's environment
    exits naming what is missing; a multi-process flag without
    ``--multihost`` is refused, not ignored; ``--device cuda`` without a
    card exits non-zero. A ``SystemExit`` with a message exits with status
    1."""
    if flags == ["--device", "cuda"] and torch.cuda.is_available():
        pytest.skip("a card is present")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit) as e:
        cli.main(["--ckpt-path", workdir["ckpt"], *flags])
    msg = str(e.value.code)
    want = {"--multihost": "MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE not set",
            "--num-processes": "--num-processes given without --multihost",
            "--device": "no CUDA device"}[flags[0]]
    assert want in msg, msg
