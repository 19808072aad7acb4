"""DPoser's rot6d configuration (``data.rot_rep = "rot6d"``: 21 joints x 6 =
126-dim poses) on the port, on the CPU at tiny sizes: the output head padded
by the pose dim, the kernel sampler's route (the kernels' plain versions)
held step by step to the JAX package's kernel in interpret mode and to the
benchmark's plain reference (``portbench/reference/``), and every path a
126-dim pose takes: the demo's generation and completions, its ODE
generation, the trainer's eval. The kernel sampler's route (K1's two-tile
pre route, K2's 128-column head) takes the pose; the routes whose head is
64 columns wide (K6, K8, K7 and K9, K10 to K12) refuse it in their scope
checks and count the refusal: the demo and ``--train-kernel auto`` then
choose the plain loop and say so, and a caller that asks for those kernels
by name gets an error."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.ops.pallas.fused_em import get_pallas_em_sampler
from dposer_tpu_torch import demo
from dposer_tpu_torch import train as train_cli
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.ops.cuda import fused_em, fused_lik, fused_ode, fused_train, score_net
from dposer_tpu_torch.ops.cuda.quant import calibrate_act_amax_per_channel
from dposer_tpu_torch.tasks import DPoserComp
from dposer_tpu_torch.utils.checkpoint import torch_parameter_order
from fixtures import make_synthetic_body_model
from portbench import inputs, program
from portbench.reference import scorefc, tasks
from test_torch_model import SMALL, flax_and_torch
from test_torch_sampling import _injected

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(name="ScoreModelFC", n_poses=21, pose_dim=6, hidden_dim=256, embed_dim=64,
             n_blocks=2, dropout=0.1, nonlinearity="swish", embedding_type="positional",
             scale_by_sigma=True, sigma_min=0.01, sigma_max=50.0, num_scales=1000)
SDE = dict(type="subvpsde", beta_min=0.1, beta_max=20.0, num_scales=12)
EPS = 1e-3
# A step's gap to the reference over its model term (-g^2 score dt), at its
# widest: the port rounds each matmul's inputs to bf16 (2^-9 relative a
# factor), the reference keeps float32; on the card at full size the cell
# reads at most 0.0058 (PERF.md). An int8-rounded reference reads ~1.
STEP_GAP = 0.05
FLOOR = 2.0 ** -14  # as the benchmark's generation check: the state's fp32 rounding
# The same gap against the JAX package's kernel (interpret mode): both round
# each matmul's inputs to bf16 and sum in fp32, so they part only where a
# sum taken in another order rounds to another bf16 input of the next layer
# (2^-9 relative an element). Read at most 0.0024 of the model term over the
# 12 steps; the port's int8 per-channel sampler reads up to ~1.3 there.
JAX_STEP_GAP = 0.01


@pytest.mark.parametrize("pose_dim,cols", [(3, 64), (6, 128)])
def test_operands_pad_the_head_by_pose_dim(pose_dim, cols):
    """A 63-dim head is padded to 64 zero columns, as before; a 126-dim one
    to 128, K2's wide tile."""
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=pose_dim, hidden_dim=64, embed_dim=32,
                         n_blocks=1).eval()
    net, _ = fused_em.build_sampler_operands(tsde.SubVPSDE(N=4), model, EPS, "euler_maruyama",
                                             "cpu")
    dim = 21 * pose_dim
    assert score_net.head_cols(dim) == cols
    assert net["w_post"].shape == (64, cols) and net["b_post"].shape == (cols,)
    assert torch.equal(net["w_post"][:, :dim], model.post_dense.weight.t().to(torch.bfloat16))
    assert torch.equal(net["b_post"][:dim], model.post_dense.bias.detach())
    assert not net["w_post"][:, dim:].any() and not net["b_post"][dim:].any()


def test_no_head_past_128_columns():
    """A pose of more than 128 dims has no head kernel: the operand builder
    raises and the sampler's scope check refuses it, counted."""
    model = ScoreModelFC(n_poses=22, pose_dim=6, hidden_dim=64, embed_dim=32, n_blocks=1)
    with pytest.raises(NotImplementedError, match="pose dim 132 > 128"):
        score_net.build_network_operands(model, torch.zeros(2))
    fused_em.reset_launch_counts()
    sampling = type("S", (), dict(predictor="euler_maruyama", corrector="none"))
    assert not fused_em.in_kernel_scope(sampling, model)
    rot6d = ScoreModelFC(n_poses=21, pose_dim=6, hidden_dim=64, embed_dim=32, n_blocks=1)
    assert fused_em.in_kernel_scope(sampling, rot6d)
    assert fused_em.scope_refused_counts()["pose_dim"] == 1


def _ask_for_kernels(route, model):
    """Ask for ``route``'s kernels by name with ``model``, on their plain
    versions: ``DPoserComp(backend="cuda")``, the RK4 PF-ODE sampler, the
    likelihood, the train kernels' scope (``--train-kernel on`` raises its
    message)."""
    sde = tsde.SubVPSDE(N=4)
    if route == "solver":
        return DPoserComp(sde, model=model, backend="cuda", device="cpu")
    if route == "ode":
        return fused_ode.get_cuda_ode_sampler(sde, model, (2, 126), n_steps=2,
                                              device="cpu")(z=torch.zeros(2, 126))
    if route == "likelihood":
        return fused_lik.get_cuda_likelihood_fn(sde, model, (2, 126), n_steps=2, device="cpu")(
            torch.Generator().manual_seed(0), torch.zeros(2, 126))
    raise NotImplementedError(fused_train.scope_error(sde, model))


# the error a caller asking for each route's kernels gets: the solver's and
# the train step's scope checks name the pose; the samplers' head operands
# are 128 columns wide where the kernels take 64
REFUSALS = dict(solver=(NotImplementedError, "head .K6. is 64 columns wide, a pose of 126"),
                ode=(ValueError, r"w_post has shape \(64, 128\), expected \(64, 64\)"),
                likelihood=(ValueError, r"w_post has shape \(64, 128\), expected \(64, 64\)"),
                train=(NotImplementedError, "pose dim <= 64 .got 126"))


@pytest.mark.parametrize("route", fused_em.NARROW_HEAD_ROUTES)
def test_narrow_routes_refuse_rot6d(route):
    """The 64-column routes take axis-angle and refuse rot6d, counted by
    route; asked for by name with a rot6d model, their kernels raise rather
    than launch."""
    fused_em.reset_launch_counts()
    axis = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=64, embed_dim=32, n_blocks=1)
    rot6d = ScoreModelFC(n_poses=21, pose_dim=6, hidden_dim=64, embed_dim=32, n_blocks=1)
    assert fused_em.narrow_head_scope(axis, route)
    assert not fused_em.narrow_head_scope(rot6d, route)
    assert fused_em.scope_refused_counts()[f"wide_pose_{route}"] == 1
    error, match = REFUSALS[route]
    with pytest.raises(error, match=match):
        _ask_for_kernels(route, rot6d.eval())
    assert fused_em.launch_counts()["dense_gn_silu"] == 0


def _step_gaps(net, sde, grid, z, trajs, out, noise):
    """Each step's gap (at its widest, over the step's model term) between the
    run's state after it and ``net``'s step from the run's state before it
    on the same normals; the last step's denoised mean against ``out``."""
    n = sde.N
    gaps = []
    for s in range(n):
        x = z if s == 0 else trajs[s - 1]
        x_new, x_mean, term = tasks.em_step(net, sde, grid, s, x, noise[s])
        want, got = (x_mean, out) if s == n - 1 else (x_new, trajs[s])
        gaps.append(float((got - want).abs().max()
                          / (term.abs().max() + FLOOR * x.abs().max())))
    return gaps


@torch.no_grad()
def test_plain_em_route_matches_the_reference():
    """The port's EM sampler on a rot6d ScoreModelFC (the kernels' plain
    versions on the CPU, host normals injected, every step recorded), step by
    step against the plain float32 reference from the same states and normals
    (the harness's weights from one seed): within ``STEP_GAP``. The
    reference with W8A8 per-channel hidden layers (its int8 emulation,
    calibrated as the int8 configuration) fails that bound."""
    config = dict(model=MODEL, sde=SDE)
    w = inputs.make_weights(MODEL, 2 ** 33 + 5, "cpu")
    model = program.build_model(config, w, "cpu").eval()
    rows, dim, n = 6, 126, SDE["num_scales"]
    g = torch.Generator().manual_seed(4)
    z = torch.randn(rows, dim, generator=g)
    noise = torch.randn(n, rows, dim, generator=g)
    fused_em.reset_launch_counts()
    sampler = fused_em.get_cuda_em_sampler(program.build_sde(config), model, (rows, dim),
                                           eps=EPS, denoise=True, device="cpu",
                                           trajectory_steps=range(n))
    trajs, out = sampler(z=z, noise=noise)
    scorefc.no_tf32()
    sde = scorefc.SubVP(SDE)
    grid = sde.grid(EPS)
    ref = scorefc.ScoreFC(w, MODEL)
    gaps = _step_gaps(ref, sde, grid, z, trajs, out, noise)
    assert max(gaps) < STEP_GAP, gaps
    cal_z = torch.randn(8, dim, generator=g)
    amax = tasks.calibrate_per_channel(ref, sde, EPS, cal_z, torch.randn(n, 8, dim, generator=g))
    int8 = scorefc.ScoreFC(w, MODEL, scorefc.Quant.per_channel(w, amax, MODEL["n_blocks"], 127))
    states = [int8_step for int8_step in trajs]
    int8_gaps = [float((tasks.em_step(int8, sde, grid, s, x, noise[s])[0]
                        - tasks.em_step(ref, sde, grid, s, x, noise[s])[0]).abs().max()
                       / (tasks.em_step(ref, sde, grid, s, x, noise[s])[2].abs().max()
                          + FLOOR * x.abs().max()))
                 for s, x in enumerate([z] + states[:-1])]
    assert max(int8_gaps) > STEP_GAP, int8_gaps


@torch.no_grad()
def test_kernel_sampler_matches_pallas_interpret_step_by_step():
    """The port's EM sampler on a tiny rot6d ScoreModelFC (the kernels' plain
    versions on the CPU, host normals injected, every state recorded) against
    the JAX package's kernel (interpret mode) on the same weights: each step
    run by both from the port's state before it on the same normals (the
    JAX sampler's ``step_range``, exact for a slice of the grid; the last
    step with the denoise), the gap at its widest over the step's model term
    within ``JAX_STEP_GAP``. The port's int8 per-channel sampler, run the same
    way from the same states, exceeds it."""
    fm, params, tm = flax_and_torch(**dict(SMALL, pose_dim=6, scale_by_sigma=True))
    n, shape = 12, (8, 126)
    z, noise = _injected(shape, n, 1, seed=11)
    z, noise = torch.from_numpy(z), torch.from_numpy(noise)[:, 0]
    sde = tsde.SubVPSDE(N=n)
    trajs, out = fused_em.get_cuda_em_sampler(sde, tm, shape, device="cpu",
                                              trajectory_steps=range(n))(z=z, noise=noise)
    _, coefs = fused_em.build_sampler_operands(sde, tm, EPS, "euler_maruyama", "cpu")
    amax = calibrate_act_amax_per_channel(sde, tm, shape, z=z, noise=noise, device="cpu")
    gaps, int8_gaps = [], []
    for s in range(n):
        x, last = (z if s == 0 else trajs[s - 1]), s == n - 1
        _, ref = get_pallas_em_sampler(jsde.SubVPSDE(N=n), fm, params, shape, eps=EPS,
                                       denoise=last, interpret=True, rng_mode="host",
                                       step_range=(s, s + 1))(
            jax.random.PRNGKey(0), z=jnp.asarray(x.numpy()),
            noise=jnp.asarray(noise[s:s + 1].numpy()))
        ref = torch.from_numpy(np.array(ref))
        # the step less its state and noise terms: the model's, cout * score
        term = ref - coefs[s, 0] * x - (0.0 if last else coefs[s, 2] * noise[s])
        scale = float(term.abs().max() + FLOOR * x.abs().max())
        int8 = fused_em.get_cuda_em_sampler(sde, tm, shape, device="cpu", denoise=last,
                                            step_range=(s, s + 1), quant="int8",
                                            act_amax=amax)(z=x, noise=noise[s:s + 1])
        gaps.append(float(((out if last else trajs[s]) - ref).abs().max()) / scale)
        int8_gaps.append(float((int8 - ref).abs().max()) / scale)
    assert max(gaps) < JAX_STEP_GAP, gaps
    assert max(int8_gaps) > JAX_STEP_GAP, int8_gaps


# ---------------------------------------------------------------------------
# The paths of a 126-dim pose: the demo and the trainer
# ---------------------------------------------------------------------------

CONFIG = '''
from dposer_tpu_torch.config import get_config as _flagship


def get_config():
    c = _flagship()
    c.data.rot_rep = "rot6d"
    c.model.HIDDEN_DIM, c.model.EMBED_DIM, c.model.N_BLOCKS = 64, 32, 1
    c.model.num_scales = 50
    c.model.scale_by_sigma = False
{extra}    return c
'''


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rot6d_demo")
    (tmp / "pc.py").write_text(CONFIG.format(extra=""))
    (tmp / "ode.py").write_text(CONFIG.format(extra="    c.sampling.method = 'ode'\n"))
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=6, hidden_dim=64, embed_dim=32, n_blocks=1,
                         scale_by_sigma=False, num_scales=50)
    sd = model.state_dict()
    shadow = [sd[name].clone() * 0.5 for name in torch_parameter_order(1)]
    torch.save({"model_state_dict": sd, "optimizer_state_dict": {}, "epoch": 0, "step": 7,
                "ema": {"decay": 0.999, "num_updates": 7, "shadow_params": shadow}},
               tmp / "rot6d.pth")
    stats = tmp / "stats"
    stats.mkdir()
    np.savez(stats / "rot6d_normalize1.npz", min_poses=-np.ones(126, np.float32),
             max_poses=np.ones(126, np.float32), min_shapes=np.nan, max_shapes=np.nan)
    np.savez(stats / "rot6d_normalize2.npz", mean_poses=np.zeros(126, np.float32),
             std_poses=np.ones(126, np.float32), mean_shapes=np.nan, std_shapes=np.nan)
    smplx, _ = make_synthetic_body_model(tmp / "smplx.npz", "smplx")
    poses = 0.2 * np.random.default_rng(0).normal(size=(8, 63)).astype(np.float32)
    np.savez(tmp / "poses.npz", pose_samples=poses)
    return tmp


def _demo(workdir, capsys, config, *extra, task="generation"):
    args = demo.parse_args(["--task", task, "--device", "cpu", "--config-path",
                            str(workdir / config), "--ckpt-path", str(workdir / "rot6d.pth"),
                            "--stats-dir", str(workdir / "stats"), "--output-path",
                            str(workdir / f"out_{task}_{config}"), "--seed", "3", *extra])
    fused_em.reset_launch_counts()
    res = demo.run(args)
    return res, capsys.readouterr().out


def test_demo_generation_takes_the_kernel_sampler(workdir, capsys):
    """The pc config: the kernel sampler (its plain versions here), no scope
    refusal, the poses back in axis-angle."""
    res, out = _demo(workdir, capsys, "pc.py")
    assert "[sampler] kernel sampler (corrector=none)" in out
    assert "outside the kernels' scope" not in out
    with np.load(res["samples_file"]) as f:
        poses = f["pose_samples"]
    assert poses.shape == (50, 63) and np.isfinite(poses).all()
    assert set(fused_em.scope_refused_counts().values()) == {0}


def test_demo_ode_generation_says_it_took_the_plain_loop(workdir, capsys):
    """The ode config: K8's head is 64 columns wide, so the fp32 tabled RK4
    loop runs, and says so; the refusal is counted."""
    res, out = _demo(workdir, capsys, "ode.py")
    assert ("[sampler] fp32 tabled RK4 PF-ODE loop: a pose of 126 dims is outside the "
            "kernels' scope") in out
    assert fused_em.scope_refused_counts()["wide_pose_ode"] == 1
    assert fused_em.launch_counts()["dense_gn_silu"] == 0
    with np.load(res["samples_file"]) as f:
        assert f["pose_samples"].shape == (50, 63) and np.isfinite(f["pose_samples"]).all()


@pytest.mark.parametrize("task,extra", [("completion", ()), ("completion2", ("--sampler", "pc"))])
def test_demo_completions(workdir, capsys, task, extra):
    """completion: K6's head is 64 columns wide, so the autograd solver runs,
    and says so; completion2 pc: the kernel imputation sampler (K2's
    imputation instantiation) takes the pose."""
    res, out = _demo(workdir, capsys, "pc.py", "--hypo", "2", "--part", "left_leg",
                     "--file-path", str(workdir / "poses.npz"), "--bodymodel-path",
                     str(workdir / "smplx.npz"), *extra, task=task)
    if task == "completion":
        assert ("[completion] autograd solver: a pose of 126 dims is outside the kernel "
                "solver's scope") in out
        assert "[completion] kernel Adam-loop solver" not in out
        assert fused_em.scope_refused_counts()["wide_pose_solver"] == 1
    else:
        assert "[sampler] kernel multi-hypothesis imputation" in out
        assert set(fused_em.scope_refused_counts().values()) == {0}
    with np.load(res["hypotheses_file"]) as f:
        hypos, gts = f["pose_hypotheses"], f["gts"]
    assert hypos.shape == (8, 2, 63) and np.isfinite(hypos).all() and gts.shape == (8, 63)
    assert np.isfinite(res["mpvpe"]) and res["mpjpe"] > 0


TRAIN_CONFIG = """
from dposer_tpu_torch.config import get_config as _base


def get_config():
    c = _base()
    c.OUTPUT_DIR = {out!r}
    c.data.rot_rep = "rot6d"
    c.model.HIDDEN_DIM, c.model.EMBED_DIM, c.model.N_BLOCKS = 64, 32, 1
    c.model.scale_by_sigma = False
    c.training.batch_size, c.training.n_iters = 8, 2
    c.training.log_freq, c.training.eval_freq, c.training.save_freq = 1, 2, 10 ** 9
    c.eval.batch_size = 2
    return c
"""


def test_trainer_eval_on_rot6d(tmp_path, monkeypatch):
    """Two autograd steps of a tiny rot6d model and an eval: the kernel
    samplers (in scope: their plain versions here) give the trajectory and
    the left-leg completion's hypotheses at 126 dims; the train kernels
    refuse the pose (``--train-kernel on`` says why)."""
    rng = np.random.default_rng(0)
    for subset, n in (("train", 160), ("test", 200)):
        d = tmp_path / "amass" / "v1" / subset
        d.mkdir(parents=True)
        np.save(d / "pose_body.npy", (0.4 * rng.normal(size=(n, 63))).astype(np.float32))
    smplx, _ = make_synthetic_body_model(str(tmp_path / "smplx.npz"), "smplx")
    cfg = tmp_path / "rot6d.py"
    cfg.write_text(TRAIN_CONFIG.format(out=str(tmp_path / "out")))
    monkeypatch.setenv("DPOSER_TENSORBOARD", "0")
    # the bits/dim's adaptive solve at coarse tolerances: an untrained 126-dim
    # field takes thousands of evaluations at the trainer's 1e-4, and the
    # likelihood is plain torch whatever the pose
    lik = train_cli.get_likelihood_fn
    monkeypatch.setattr(train_cli, "get_likelihood_fn",
                        lambda sde, score, **kw: lik(sde, score, rtol=1e-2, atol=1e-2,
                                                     eps=kw["eps"]))
    args = ["--config", str(cfg), "--dataset-folder", str(tmp_path / "amass"), "--version",
            "v1", "--bodymodel-path", smplx, "--device", "cpu", "--seed", "3"]
    fused_em.reset_launch_counts()
    res = train_cli.main(args)
    assert res["step"] == 2 and res["last_eval"]["step"] == 2
    log = open(os.path.join(res["output_dir"], "train.log")).read()
    assert "Sample bpd:" in log and "APD:" in log and "plain PC loop" not in log
    assert res["last_eval"]["trajs"].shape == (10, 2, 126)
    assert torch.isfinite(res["last_eval"]["trajs"]).all()
    # the train kernels' scope check (--train-kernel auto) refused the pose
    refused = fused_em.scope_refused_counts()
    assert refused.pop("wide_pose_train") == 1 and set(refused.values()) == {0}
    with pytest.raises(NotImplementedError, match="pose dim <= 64 .got 126"):
        train_cli.main(args + ["--train-kernel", "on"])
