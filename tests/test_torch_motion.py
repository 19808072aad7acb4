"""The port's motion-denoising slice against the JAX package on the same
weights and inputs (CPU): the temporal filters, ``_safe_norm``, the noise
schedules, ``MotionDenoise.optimize`` against JAX's with injected init and
prior normals (a 2-block net at hidden 64, the 120-vertex human-scale
synthetic SMPL-X body, 2 x 5 Adam steps), without and with the prior,
``optimize_batch`` against ``optimize``, the metrics, the HumanEva splitter,
and ``python -m dposer_tpu_torch.motion_denoising --device cpu`` on
``benchmarks/gen_synth_motion.py`` fragments with the pinned checkpoint."""
import csv
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.body_model.smplx_jax import BodyModel as JaxBodyModel
from dposer_tpu.data import PoseNormalizer as JaxNormalizer
from dposer_tpu.data.humaneva import split_npz as jax_split_npz
from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.diffusion.score_fn import get_score_fn as jax_get_score_fn
from dposer_tpu.ops import smoothing as jsm
from dposer_tpu.tasks import MotionDenoise as JaxMotionDenoise
from dposer_tpu.tasks.motion_denoising import _safe_norm as jax_safe_norm
from dposer_tpu.tasks.motion_denoising import noise_schedule_kwargs as jax_schedule
from dposer_tpu_torch import motion_denoising as cli
from dposer_tpu_torch.body_model import BodyModel
from dposer_tpu_torch.data import PoseNormalizer
from dposer_tpu_torch.data.humaneva import split_npz
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.score_fn import get_score_fn
from dposer_tpu_torch.ops import smoothing as tsm
from dposer_tpu_torch.tasks import MotionDenoise
from dposer_tpu_torch.tasks.motion_denoising import _safe_norm, noise_schedule_kwargs

from fixtures import make_stats_dir, make_synthetic_body_model
from test_torch_model import SMALL, flax_and_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "trained_r5")
T = 12
SCHED = dict(time_strategy="3", iterations=2, steps_per_iter=5, sample_trun=4.0,
             sample_time=490)
STEPS = SCHED["iterations"] * SCHED["steps_per_iter"]
# optimize against JAX's: the deterministic run (prior weight 0) agrees to
# 1.1e-6 here and the run with the prior on injected normals to 2.1e-5;
# Adam divides each gradient by its running norm, so ulps of a small
# gradient move a step by up to a few 1e-6 of its lr
TOL = {0.0: 1e-5, 1.0: 1e-4}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_motion")
    path, vids = make_synthetic_body_model(tmp / "m.npz", "smplx", template_scale=0.15)
    rng = np.random.default_rng(0)
    stats = make_stats_dir(tmp / "stats", mean=0.1 * rng.normal(size=63),
                           std=rng.uniform(0.3, 0.6, 63))
    fm, params, tm = flax_and_torch(**dict(SMALL, hidden_dim=64, embed_dim=32,
                                           scale_by_sigma=True, num_scales=1000))
    js, ts = jsde.SubVPSDE(N=500), tsde.SubVPSDE(N=500)
    jbm = JaxBodyModel(path, vertex_ids=vids)
    gt = (0.3 * rng.normal(size=(T, 63))).astype(np.float32)
    noisy = (np.asarray(jbm(pose_body=jnp.asarray(gt)).Jtr[:, :22])
             + 0.04 * rng.normal(size=(T, 22, 3))).astype(np.float32)
    return dict(
        jbm=jbm, tbm=BodyModel(path, model_type="smplx", vertex_ids=vids),
        jnz=JaxNormalizer(stats, normalize=True, min_max=False, rot_rep="axis"),
        tnz=PoseNormalizer(stats, normalize=True, min_max=False, rot_rep="axis"),
        js=js, ts=ts, tscore=get_score_fn(ts, tm, continuous=True),
        jscore=jax_get_score_fn(js, lambda x, t: fm.apply({"params": params}, x, t),
                                continuous=True),
        gt=gt, noisy=noisy)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Small tensors and thousands of small calls: one thread is the fastest
    way through them, above all beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("window", [3, 4, 5])
def test_moving_average_matches_jax(window):
    """Zero padding of K//2 on both sides: length T for odd K, T + 1 for even."""
    data = np.random.default_rng(window).normal(size=(20, 7)).astype(np.float32)
    ref = np.asarray(jsm.moving_average(jnp.asarray(data), window))
    out = tsm.moving_average(_t(data), window).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("window,sigma", [(3, 2.0), (5, 1.0), (7, 3.0)])
def test_gaussian_smoothing_matches_jax(window, sigma):
    data = np.random.default_rng(window).normal(size=(30, 63)).astype(np.float32)
    ref = np.asarray(jsm.gaussian_smoothing(jnp.asarray(data), window, sigma))
    out = tsm.gaussian_smoothing(_t(data), window, sigma).numpy()
    assert out.shape == data.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_add_noise():
    x = torch.zeros(2000, 3)
    assert tsm.add_noise(x, 0.0) is x
    g = tsm.add_noise(x, 0.5, generator=torch.Generator().manual_seed(0))
    assert abs(float(g.std()) - 0.5) < 0.02
    u = tsm.add_noise(x, 0.5, "uniform", generator=torch.Generator().manual_seed(0))
    assert float(u.abs().max()) <= 0.25 and float(u.std()) > 0.13
    with pytest.raises(NotImplementedError):
        tsm.add_noise(x, 0.5, "laplace")


def test_safe_norm_matches_jax_with_a_gradient_at_zero():
    d = np.random.default_rng(1).normal(size=(5, 4, 3)).astype(np.float32)
    d[0, 0] = 0.0
    np.testing.assert_allclose(_safe_norm(_t(d)).numpy(), np.asarray(jax_safe_norm(d)),
                               rtol=1e-6)
    x = _t(d).requires_grad_(True)
    (g,) = torch.autograd.grad(_safe_norm(x).sum(), x)
    ref = np.asarray(jax.grad(lambda a: jax_safe_norm(a).sum())(jnp.asarray(d)))
    assert torch.isfinite(g).all() and float(g[0, 0].abs().max()) == 0.0
    np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("std", [0.02, 0.04, 0.1, 0.5])
def test_noise_schedules_match_jax(std):
    if std == 0.5:
        with pytest.raises(NotImplementedError):
            noise_schedule_kwargs(std)
        return
    assert noise_schedule_kwargs(std) == jax_schedule(std)


def _jax_draws(key):
    """JAX's init and the per-step prior normals of ``optimize(key, ...)``:
    ``key, k_init = split(key)``, then ``k_t, k_z = split(fold_in(key, i))``."""
    key, k_init = jax.random.split(key)
    poses0 = np.asarray(0.01 * jax.random.normal(k_init, (T, 63)))
    z = np.stack([np.asarray(jax.random.normal(
        jax.random.split(jax.random.fold_in(key, i))[1], (T, 63), jnp.float32))
        for i in range(STEPS)])
    return poses0, z


@pytest.mark.parametrize("dposer_weight", [0.0, 1.0], ids=["prior_off", "prior_on"])
def test_optimize_matches_jax(setup, dposer_weight):
    s = setup
    key = jax.random.PRNGKey(4)
    jmd = JaxMotionDenoise(s["js"], s["jscore"], s["jbm"], s["jnz"],
                           dposer_weight=dposer_weight, batch_size=T)
    ref = jmd.optimize(key, jnp.asarray(s["noisy"]), jnp.asarray(s["gt"]), **SCHED)
    poses0, z = _jax_draws(key)
    md = MotionDenoise(s["ts"], s["tscore"], s["tbm"], s["tnz"],
                       dposer_weight=dposer_weight, batch_size=T)
    out = md.optimize(_t(s["noisy"]), _t(s["gt"]), poses0=_t(poses0), z=_t(z), **SCHED)
    r = np.asarray(jmd.last_poses)
    np.testing.assert_allclose(md.last_poses.numpy(), r, rtol=0,
                               atol=TOL[dposer_weight] * max(1.0, np.abs(r).max()))
    for k in ("init_MPJPE", "MPJPE", "MPVPE"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_metrics_match_jax(setup):
    s = setup
    poses = (0.3 * np.random.default_rng(5).normal(size=(T, 63))).astype(np.float32)
    ref = JaxMotionDenoise(s["js"], s["jscore"], s["jbm"], s["jnz"]).metrics(
        jnp.asarray(poses), jnp.asarray(s["noisy"]), jnp.asarray(s["gt"]))
    out = MotionDenoise(s["ts"], s["tscore"], s["tbm"], s["tnz"]).metrics(
        _t(poses), _t(s["noisy"]), _t(s["gt"]))
    for k in ref:
        assert out[k].shape == (T,)
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, err_msg=k)


def test_optimize_batch_matches_optimize(setup):
    """F fragments in one batched loss: each fragment's trajectory is its
    own optimize's, from generators of the same seeds and from injected
    draws, to 1e-5 rad: the body model's and the network's products at 36
    rows round otherwise than at 12 (measured up to 2.1e-6 over 10 steps)."""
    s = setup
    F = 3
    rng = np.random.default_rng(6)
    noisy = _t(s["noisy"][None] + 0.02 * rng.normal(size=(F, T, 22, 3)).astype(np.float32))
    md = MotionDenoise(s["ts"], s["tscore"], s["tbm"], s["tnz"], batch_size=T)
    batched = md.optimize_batch(
        noisy, generators=[torch.Generator().manual_seed(10 + f) for f in range(F)], **SCHED)
    assert batched.shape == (F, T, 63)
    poses0 = _t(0.01 * rng.normal(size=(F, T, 63)).astype(np.float32))
    z = _t(rng.normal(size=(STEPS, F, T, 63)).astype(np.float32))
    injected = md.optimize_batch(noisy, poses0=poses0, z=z, **SCHED)
    for f in range(F):
        md.optimize(noisy[f], generator=torch.Generator().manual_seed(10 + f), **SCHED)
        np.testing.assert_allclose(batched[f].numpy(), md.last_poses.numpy(), rtol=0,
                                   atol=1e-5, err_msg=f"fragment {f}")
        md.optimize(noisy[f], poses0=poses0[f], z=z[:, f], **SCHED)
        np.testing.assert_allclose(injected[f].numpy(), md.last_poses.numpy(), rtol=0,
                                   atol=1e-5, err_msg=f"fragment {f}, injected")
    assert not torch.allclose(batched[0], batched[1])


def test_optimize_batch_matches_optimize_time_strategy_1(setup):
    """Under time strategy '1' fragment f draws its own time every step from
    ``generators[f]``, before its normals, as ``optimize`` draws from its
    generator: the batch's fragments are each one's own ``optimize`` to 1e-5
    rad over 10 steps, as under strategy '3'."""
    s = setup
    F = 3
    sched = dict(SCHED, time_strategy="1")
    rng = np.random.default_rng(8)
    noisy = _t(s["noisy"][None] + 0.02 * rng.normal(size=(F, T, 22, 3)).astype(np.float32))
    md = MotionDenoise(s["ts"], s["tscore"], s["tbm"], s["tnz"], batch_size=T)
    batched = md.optimize_batch(
        noisy, generators=[torch.Generator().manual_seed(20 + f) for f in range(F)], **sched)
    for f in range(F):
        md.optimize(noisy[f], generator=torch.Generator().manual_seed(20 + f), **sched)
        np.testing.assert_allclose(batched[f].numpy(), md.last_poses.numpy(), rtol=0,
                                   atol=1e-5, err_msg=f"fragment {f}")
    # injected draws without the time indices have no time to draw from
    with pytest.raises(ValueError, match="strategy '1'"):
        md.optimize_batch(noisy, poses0=torch.zeros(F, T, 63),
                          z=torch.zeros(STEPS, F, T, 63), **sched)


def test_optimize_batch_time_strategy_1_matches_jax(setup):
    """The batch under strategy '1' against JAX's ``optimize_batch``, which
    vmaps each fragment's run over its own key: JAX's init, per-step time
    indices and normals injected (``poses0``, ``t_idx``, ``z``). Random
    times put some steps at small indices (33 and 43 on these keys), where
    float32 rounding of the prior's gradient moves Adam's normalised step:
    JAX's own ``optimize_batch`` lies 3.0e-3 rad from its own ``optimize``
    on these keys, and the port 1.3e-3 from JAX's batch (both measured), so
    the bound is 5e-3 rad."""
    s = setup
    F = 2
    sched = dict(SCHED, time_strategy="1")
    rng = np.random.default_rng(9)
    noisy = (s["noisy"][None] + 0.02 * rng.normal(size=(F, T, 22, 3))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), F)
    jmd = JaxMotionDenoise(s["js"], s["jscore"], s["jbm"], s["jnz"], batch_size=T)
    ref = np.asarray(jmd.optimize_batch(keys, jnp.asarray(noisy), **sched))
    poses0, z, t_idx = [], [], []
    for k in keys:
        p0, zf = _jax_draws(k)
        k = jax.random.split(k)[0]
        t_idx.append([int(jax.random.randint(jax.random.split(jax.random.fold_in(k, i))[0],
                                             (), 0, 500)) for i in range(STEPS)])
        poses0.append(p0)
        z.append(zf)
    t_idx = np.asarray(t_idx).T  # [steps, F]
    assert len(np.unique(t_idx)) > STEPS  # the fragments draw their own times
    md = MotionDenoise(s["ts"], s["tscore"], s["tbm"], s["tnz"], batch_size=T)
    out = md.optimize_batch(_t(noisy), poses0=_t(np.stack(poses0)),
                            z=_t(np.stack(z, 1)), t_idx=torch.as_tensor(t_idx), **sched)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=5e-3)


def test_humaneva_split_matches_jax(tmp_path):
    src = tmp_path / "in" / "Subject1"
    src.mkdir(parents=True)
    poses = np.random.default_rng(2).normal(size=(130, 156)).astype(np.float32)
    np.savez(src / "walk_poses.npz", poses=poses)
    np.savez(src / "walk_shape.npz", betas=np.zeros(16))
    for out, fn in (("jax", jax_split_npz), ("torch", split_npz)):
        for name in ("walk_poses.npz", "walk_shape.npz"):
            fn(str(src / name), str(tmp_path / out), seq_len=60)
    names = sorted(os.listdir(tmp_path / "torch" / "Subject1"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "Subject1")) == [
        "walk_poses_batch000.npz", "walk_poses_batch001.npz"]
    for n in names:
        with np.load(tmp_path / "torch" / "Subject1" / n) as a, \
                np.load(tmp_path / "jax" / "Subject1" / n) as b:
            assert sorted(a.files) == sorted(b.files) == ["pose_body", "root_orient"]
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(np.load(tmp_path / "torch" / "Subject1" / names[1])
                                  ["pose_body"], poses[60:120, 3:66])


@pytest.fixture(scope="module")
def motion_data(tmp_path_factory):
    """Two 60-frame fragments of ``benchmarks/gen_synth_motion.py`` (numpy;
    the mixture of the pinned checkpoint's training data) and the human-scale
    120-vertex body of ``gen_synth_body.py``'s ``human`` variant."""
    tmp = tmp_path_factory.mktemp("torch_motion_cli")
    spec = importlib.util.spec_from_file_location(
        "gen_synth_motion", os.path.join(REPO, "benchmarks", "gen_synth_motion.py"))
    mod = importlib.util.module_from_spec(spec)
    import sys

    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    spec.loader.exec_module(mod)
    centers, w, basis = mod.make_mixture(np.random.default_rng(0))
    rng = np.random.default_rng(1234)
    frags = tmp / "frags"
    frags.mkdir()
    for i in range(2):
        np.savez(frags / f"seq{i}.npz",
                 pose_body=mod.sample_sequence(rng, 60, centers, w, basis, 30.0))
    body, _ = make_synthetic_body_model(tmp / "human.npz", "smplx", n_verts=120,
                                        template_scale=0.15, seed=0)
    return dict(tmp=tmp, frags=str(frags), body=body)


def _cli_args(d, *extra):
    return cli.parse_args(["--device", "cpu", "--ckpt-path",
                           os.path.join(ART, "axis-zscore-400k-synth.pth"),
                           "--stats-dir", os.path.join(ART, "stats"),
                           "--bodymodel-path", d["body"], "--noise-std", "0.04", *extra])


def test_motion_cli_file_mode_against_jax_metrics(motion_data, capsys):
    """One fragment through the CLI at the 0.04 schedule (3 x 60 steps) with
    the pinned prior: the denoised MPJPE is below the noisy joints' (the
    contract of tests/test_tasks.py), and the printed averages are JAX's
    metrics of the written poses against the same noisy joints (the JAX CLI
    draws other noise, so its own averages are not comparable pointwise)."""
    d = motion_data
    out_dir = str(d["tmp"] / "file_out")
    seq = os.path.join(d["frags"], "seq0.npz")
    avg = cli.run(_cli_args(d, "--file-path", seq, "--outpath-folder", out_dir,
                            "--seed", "3"))
    printed = capsys.readouterr().out
    assert f"The average of MPJPE is {avg['MPJPE']}" in printed
    assert 5.0 < avg["init_MPJPE"] < 8.0  # 0.04 m noise: 100 * 0.04 * E|N(0, I3)| = 6.38
    assert avg["MPJPE"] < avg["init_MPJPE"], avg
    gt = np.load(seq)["pose_body"]
    with np.load(os.path.join(out_dir, "denoised_poses.npz")) as f:
        poses = f["pose_body"]
    assert poses.shape == (60, 63) and np.isfinite(poses).all()
    body = BodyModel(d["body"], model_type="smplx")
    noisy = cli.noisy_joints(body, _t(gt), 0.04, torch.Generator().manual_seed(3))
    jmd = JaxMotionDenoise(jsde.SubVPSDE(N=500), None, JaxBodyModel(d["body"]), None)
    ref = jmd.metrics(jnp.asarray(poses), jnp.asarray(noisy.numpy()), jnp.asarray(gt))
    for k, v in ref.items():
        np.testing.assert_allclose(avg[k], float(np.mean(v)), rtol=1e-5, err_msg=k)


def test_motion_cli_directory_mode(motion_data):
    """Both fragments as one batch: a CSV row each, each final MPJPE below its
    init, and each fragment's result that of a batch of its own (its noise,
    init and normals come from its own generator): the same noisy joints, and
    the same fit to 1e-3 relative, the float32 rounding of the body model's
    products at 120 rows against 60, carried through 60 Adam steps (measured
    3e-5)."""
    d = motion_data
    out_dir = d["tmp"] / "dir_out"
    avg = cli.run(_cli_args(d, "--data-dir", d["frags"], "--outpath-folder", str(out_dir),
                            "--batch-fragments", "2", "--iterations", "1"))
    with open(out_dir / "AMASS_results_logging.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Sequence", "init_MPJPE", "MPJPE", "MPVPE"] and len(rows) == 3
    for row in rows[1:]:
        assert float(row[2]) < float(row[1]), row
    assert avg["MPJPE"] < avg["init_MPJPE"]
    one = cli.run(_cli_args(d, "--data-dir", d["frags"], "--outpath-folder",
                            str(d["tmp"] / "dir_out1"), "--batch-fragments", "1",
                            "--iterations", "1"))
    assert one["init_MPJPE"] == avg["init_MPJPE"]
    for k in avg:
        np.testing.assert_allclose(one[k], avg[k], rtol=1e-3, err_msg=k)


def test_motion_cli_directory_mode_time_strategy_1(motion_data):
    """Under ``--time-strategy 1`` each fragment draws its own times, so a
    batch of two gives each sequence the result of a batch of its own, to
    the 1e-3 relative of ``test_motion_cli_directory_mode``."""
    d = motion_data
    common = ["--data-dir", d["frags"], "--time-strategy", "1", "--iterations", "1",
              "--steps-per-iter", "30"]
    two = cli.run(_cli_args(d, *common, "--outpath-folder", str(d["tmp"] / "ts1_b2"),
                            "--batch-fragments", "2"))
    one = cli.run(_cli_args(d, *common, "--outpath-folder", str(d["tmp"] / "ts1_b1"),
                            "--batch-fragments", "1"))
    assert one["init_MPJPE"] == two["init_MPJPE"]
    for k in two:
        np.testing.assert_allclose(one[k], two[k], rtol=1e-3, err_msg=k)


def test_instrument_trace_matches_jax(setup):
    """``optimize(instrument=True)``'s per-step raw and weighted loss terms
    on ``last_trace``, under JAX's names, against JAX's trace over the 10
    steps on JAX's draws injected."""
    s = setup
    key = jax.random.PRNGKey(6)
    jmd = JaxMotionDenoise(s["js"], s["jscore"], s["jbm"], s["jnz"], batch_size=T)
    jmd.optimize(key, jnp.asarray(s["noisy"]), instrument=True, **SCHED)
    poses0, z = _jax_draws(key)
    md = MotionDenoise(s["ts"], s["tscore"], s["tbm"], s["tnz"], batch_size=T)
    md.optimize(_t(s["noisy"]), poses0=_t(poses0), z=_t(z), instrument=True, **SCHED)
    assert sorted(md.last_trace) == sorted(jmd.last_trace)
    for k, ref in jmd.last_trace.items():
        assert md.last_trace[k].shape == (STEPS,)
        np.testing.assert_allclose(md.last_trace[k], ref, rtol=1e-5, err_msg=k)
    # without instrument= the poses are the same and no trace is taken
    md2 = MotionDenoise(s["ts"], s["tscore"], s["tbm"], s["tnz"], batch_size=T)
    md2.optimize(_t(s["noisy"]), poses0=_t(poses0), z=_t(z), **SCHED)
    assert torch.equal(md2.last_poses, md.last_poses) and not hasattr(md2, "last_trace")
