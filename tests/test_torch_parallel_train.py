"""The port's data-parallel training (``dposer_tpu_torch.parallel``'s
training half) on the CPU: the dropout hash and the train kernels' plain
versions at a row offset, ``data_parallel_step`` and its multi-step and
indexed forms over 2 and 4 gloo processes (a ``file://`` rendezvous, each
process joined with a timeout) against one process on both train routes,
against JAX's ``data_parallel_step`` on the conftest's 8-device CPU mesh,
the trainer CLI as two processes against one, and the ``_params`` samplers
after a weight swap against freshly built ones. A one-block net at hidden
64, a global batch of 16."""
import datetime
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dposer_tpu_torch.diffusion import losses as tlosses
from dposer_tpu_torch.diffusion.sde import SubVPSDE
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.ops.cuda import fused_train as ft
from dposer_tpu_torch.ops.cuda.fused_em import get_cuda_em_hypo_sampler, get_cuda_em_sampler
from dposer_tpu_torch.parallel import Mesh
from dposer_tpu_torch.parallel import sharding as par

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
JOIN_S = 180  # each process's time limit
GB, D, STEPS = 16, 63, 3  # the global batch, the pose dim, the steps of a case
TINY = dict(n_poses=21, pose_dim=3, hidden_dim=64, embed_dim=32, n_blocks=1)
CFG = SimpleNamespace(
    optim=SimpleNamespace(optimizer="Adam", lr=1e-3, beta1=0.9, eps=1e-8, warmup=10,
                          grad_clip=1.0, weight_decay=0.0),
    model=SimpleNamespace(ema_rate=0.999))
# the one-process step against the data-parallel one: tests/test_parallel.py's
# bounds for JAX's sharded step against its single-device step
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6


# ---------------------------------------------------------------------------
# The row offset of K10 and K12
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [1, 37, 640])
def test_dropout_keep_rows_are_the_full_mask_rows(offset):
    """The hash keyed by global row: rows ``offset ..`` of a launch at
    ``row_offset=offset`` are those rows of the full mask, bit for bit."""
    full = ft.dropout_keep(20261016, 3, offset + 50, 128, 0.9)
    part = ft.dropout_keep(20261016, 3, 50, 128, 0.9, row_offset=offset)
    assert torch.equal(part, full[offset:])
    assert torch.equal(ft.dropout_mask(5, 1, 50, 128, 0.9, row_offset=offset),
                       ft.dropout_mask(5, 1, offset + 50, 128, 0.9)[offset:])
    assert not torch.equal(part, full[:50])  # another rows' mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_train_plain_versions_at_row_offset_equal_the_full_rows(dtype):
    """Both train plain versions on rows 24:48 of a 48-row batch at
    ``row_offset=24`` equal rows 24:48 of the full call (every row is its
    own: its matmul row, GroupNorm and mask), and K12's dgamma and dbeta of
    the two halves sum to the full call's within fp32 rounding (1e-5 of
    the sums' scale)."""
    g = torch.Generator().manual_seed(0)
    B, K, N, half = 48, 64, 128, 24

    def rn(*s, sc=1.0):
        return sc * torch.randn(*s, generator=g)

    a, w = rn(B, K), rn(K, N, sc=K ** -0.5).to(dtype)
    proj, gamma, beta, res = rn(B, N, sc=0.3).to(dtype), 1 + rn(N, sc=0.1), rn(N, sc=0.1), rn(B, N)
    fwd = ft.dense_gn_silu_train_plain(a, w, proj, gamma, beta, 9, 2, 0.9, res)
    low = ft.dense_gn_silu_train_plain(a[half:], w, proj[half:], gamma, beta, 9, 2, 0.9,
                                       res[half:], row_offset=half)
    for x, y in zip(low, fwd):
        assert torch.equal(x, y[half:])
    dh_next, w_t = rn(B, N, sc=0.1).to(dtype), rn(N, N, sc=N ** -0.5).to(dtype)
    xhat, rstd = fwd[2], fwd[3]
    bwd = ft.dense_gn_silu_bwd_plain(dh_next, w_t, xhat, rstd, gamma, beta, 9, 2, 0.9, res)
    parts = [ft.dense_gn_silu_bwd_plain(dh_next[sl], w_t, xhat[sl], rstd[sl], gamma, beta, 9,
                                        2, 0.9, res[sl], row_offset=sl.start)
             for sl in (slice(0, half), slice(half, B))]
    for k in (0, 1):
        assert torch.equal(parts[1][k], bwd[k][half:])
    for k in (2, 3):
        torch.testing.assert_close(parts[0][k] + parts[1][k], bwd[k], rtol=0,
                                   atol=1e-5 * float(bwd[k].abs().max()))
    # the wrappers on CPU tensors take row_offset to their plain versions
    out = ft.dense_gn_silu_train(a[half:], w, proj[half:], gamma, beta, 9, 2, 0.9,
                                 residual=res[half:], row_offset=half)
    assert all(torch.equal(x, y) for x, y in zip(out, low))
    with pytest.raises(ValueError, match="row_offset"):
        ft.dense_gn_silu_train(a, w, proj, gamma, beta, 9, 2, 0.9, row_offset=-1)


# ---------------------------------------------------------------------------
# data_parallel_step and its forms, run in every process of a group
# ---------------------------------------------------------------------------

def _model(dropout: float) -> ScoreModelFC:
    torch.manual_seed(0)
    return ScoreModelFC(**TINY, dropout=dropout)


def _step_fn(route: str, model):
    sde = SubVPSDE(N=1000)
    if route == "kernel":  # the kernels' plain versions: the tensors are on the CPU
        return ft.get_cuda_step_fn(sde, model, reduce_mean=True)
    return tlosses.get_step_fn(sde, True, tlosses.make_model_apply(model), reduce_mean=True)


def _flat(tensors) -> np.ndarray:
    return torch.cat([t.detach().reshape(-1) for t in tensors]).numpy()


def _result(state, losses) -> dict:
    return dict(losses=np.asarray(losses, np.float64), params=_flat(state.tx.params),
                ema=_flat(state.ema.shadow_params))


def run_case(route: str, data: dict) -> dict:
    """``route``'s (``autograd`` or ``kernel``, dropout 0.1) three steps of a
    global batch of 16 in this process's group (or alone), in three forms
    from one init: ``data_parallel_step`` a step, ``data_parallel_multi_step``
    over the window and ``data_parallel_multi_step_indexed`` over its
    indices into ``data["pool"]``. Each step's draws come from a generator
    seeded by the step; the kernel route's dropout hash from a seed a step.
    Returns each form's losses, parameters and EMA."""
    x, idx, pool = (torch.from_numpy(data[k]) for k in ("x", "idx", "pool"))
    kernel = route == "kernel"
    gen = torch.Generator()

    def noise(s):
        gen.manual_seed(100 + s)
        return dict(generator=gen, **({"dropout_seed": 7 + s} if kernel else {}))

    out = {}
    for form in ("single", "multi", "indexed"):
        model = _model(0.1)
        state = tlosses.init_train_state(CFG, model)
        step_fn = _step_fn(route, model)
        if form == "single":
            step = par.data_parallel_step(step_fn)
            losses = [float(step(state, par.shard_global_batch(x[s]), **noise(s))["step_loss"])
                      for s in range(STEPS)]
        elif form == "multi":
            rows = par.data_parallel_multi_step(step_fn)(
                state, par.shard_global_multi_batch(x), noise)
            losses = [r["step_loss"] for r in rows]
        else:
            rows = par.data_parallel_multi_step_indexed(step_fn)(
                state, par.shard_global_multi_batch(idx), pool, noise)
            losses = [r["step_loss"] for r in rows]
        for k, v in _result(state, losses).items():
            out[f"{form}_{k}"] = v
    return out


def run_jax_case(data: dict) -> dict:
    """The autograd step at dropout 0 from ``data["state_dict"]`` (JAX's
    init) on JAX's draws ``data["t"]`` [3, 16] and ``data["z"]`` [3, 16, D]:
    three data-parallel steps on this process's rows."""
    model = ScoreModelFC(**TINY, dropout=0.0, scale_by_sigma=False)
    model.load_state_dict(torch.load(data["state_dict"], weights_only=True), strict=True)
    state = tlosses.init_train_state(CFG, model)
    step = par.data_parallel_step(_step_fn("autograd", model))
    losses, first = [], None
    for s in range(STEPS):
        ld = step(state, par.shard_global_batch(torch.from_numpy(data["x"][s])),
                  t=par.shard_global_batch(torch.from_numpy(data["t"][s])),
                  z=par.shard_global_batch(torch.from_numpy(data["z"][s])))
        losses.append(float(ld["step_loss"]))
        first = _flat(state.tx.params) if s == 0 else first
    return dict(_result(state, losses), params_step1=first)


WORKER = """
import datetime, sys
import numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
import test_torch_parallel_train as t
from dposer_tpu_torch.parallel import sharding as par
par.init_distributed({url!r}, {n}, {rank}, timeout=datetime.timedelta(seconds=120))
data = dict(np.load({inputs!r}))
data["state_dict"] = {state_dict!r}
out = {{f"{{route}}_{{k}}": v for route in ("autograd", "kernel")
       for k, v in t.run_case(route, data).items()}}
out.update({{f"jax_{{k}}": v for k, v in t.run_jax_case(data).items()}})
out["world"] = np.asarray([par.process_index(), par.process_count()])
np.savez({out!r}, **out)
"""


def run_processes(scripts, timeout=JOIN_S, env=None):
    """One ``python -c`` process a script, all started at once from the
    repository root; each joined with a timeout (a hang fails the test), a
    non-zero exit fails it; every process is stopped. Their outputs."""
    env = dict(env or os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, TESTS, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", s], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for s in scripts]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, out[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Three global batches drawn from a pool of 64 poses by an index window,
    and JAX's init and draws for the JAX case."""
    import jax
    import jax.numpy as jnp

    from dposer_tpu.models import ScoreModelFC as FlaxScoreModelFC
    from dposer_tpu_torch.utils.checkpoint import state_dict_from_flax

    tmp = tmp_path_factory.mktemp("dp_inputs")
    rng = np.random.default_rng(3)
    pool = (0.5 * rng.normal(size=(64, D))).astype(np.float32)
    idx = rng.integers(0, 64, size=(STEPS, GB)).astype(np.int64)
    fm = FlaxScoreModelFC(**TINY, dropout=0.0, scale_by_sigma=False)
    params = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, D)), jnp.zeros((1,)))["params"]
    params = jax.tree.map(np.asarray, params)
    t, z = [], []
    for s in range(STEPS):  # the draws of JAX's continuous loss at key 100 + s
        k_t, k_z, _ = jax.random.split(jax.random.PRNGKey(100 + s), 3)
        t.append(np.asarray(jax.random.uniform(k_t, (GB,), jnp.float32, minval=1e-5,
                                               maxval=1.0)))
        z.append(np.asarray(jax.random.normal(k_z, (GB, D), jnp.float32)))
    data = dict(pool=pool, idx=idx, x=pool[idx], t=np.stack(t), z=np.stack(z))
    np.savez(tmp / "inputs.npz", **data)
    torch.save(state_dict_from_flax(params), tmp / "state_dict.pt")
    return dict(data, params=params, path=str(tmp / "inputs.npz"),
                state_dict=str(tmp / "state_dict.pt"))


@pytest.fixture(scope="module")
def one_process(inputs):
    data = dict(inputs)
    out = {f"{route}_{k}": v for route in ("autograd", "kernel")
           for k, v in run_case(route, data).items()}
    out.update({f"jax_{k}": v for k, v in run_jax_case(data).items()})
    return out


@pytest.fixture(scope="module")
def groups(inputs, tmp_path_factory):
    """A group of 2 and one of 4 processes, all started at once: each
    process's results by group size."""
    tmp = tmp_path_factory.mktemp("dp_groups")
    scripts, files = [], {}
    for n in (2, 4):
        url = f"file://{tmp / f'rendezvous{n}'}"
        files[n] = [str(tmp / f"g{n}_r{r}.npz") for r in range(n)]
        scripts += [WORKER.format(tests=TESTS, url=url, n=n, rank=r, inputs=inputs["path"],
                                  state_dict=inputs["state_dict"], out=files[n][r])
                    for r in range(n)]
    run_processes(scripts)
    return {n: [dict(np.load(f)) for f in fs] for n, fs in files.items()}


@pytest.fixture(params=[2, 4], ids=["2proc", "4proc"])
def group(request, groups):
    return request.param, groups[request.param]


@pytest.mark.parametrize("route", ["autograd", "kernel"])
def test_data_parallel_step_equals_one_process(group, one_process, route):
    """Three steps at dropout 0.1 over 2 and 4 processes against one: each
    step's loss within 1e-5 relative and the parameters and EMA within 1e-4
    relative, 1e-6 absolute (JAX's sharded-step bounds). The draws (t, z,
    the autograd route's dropout factors, the kernel route's hash rows) are
    the global batch's, so only the order of the gradients' sums differs."""
    n, ranks = group
    ref = one_process
    for form in ("single", "multi", "indexed"):
        got = ranks[0]
        np.testing.assert_allclose(got[f"{route}_{form}_losses"], ref[f"{route}_{form}_losses"],
                                   rtol=LOSS_RTOL, err_msg=form)
        for k in ("params", "ema"):
            np.testing.assert_allclose(got[f"{route}_{form}_{k}"], ref[f"{route}_{form}_{k}"],
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=f"{form} {k}")
    # the parameters moved, and dropout was on: another mask gives another loss
    assert np.abs(ref[f"{route}_single_params"] - _flat(
        tlosses.init_train_state(CFG, _model(0.1)).tx.params)).max() > 1e-5


def test_ranks_are_bit_equal(group):
    """Every rank ends on the same losses, parameters and EMA, bit for bit:
    the update runs on the all-reduced gradients on each."""
    n, ranks = group
    assert [list(r["world"]) for r in ranks] == [[i, n] for i in range(n)]
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k != "world":
                np.testing.assert_array_equal(r[k], v, err_msg=k)


def test_multi_and_indexed_forms_equal_single_steps(group, one_process):
    """``data_parallel_multi_step`` over the [3, B, D] window and its indexed
    form over the [3, B] index window take the steps one step at a time
    takes, bit for bit, in one process and in each group."""
    _, ranks = group
    for out in (one_process, ranks[0]):
        for route in ("autograd", "kernel"):
            for form in ("multi", "indexed"):
                for k in ("losses", "params", "ema"):
                    np.testing.assert_array_equal(out[f"{route}_{form}_{k}"],
                                                  out[f"{route}_single_{k}"],
                                                  err_msg=f"{route} {form} {k}")


@pytest.fixture(scope="module")
def jax_steps(inputs):
    """JAX's ``data_parallel_step`` on the conftest's 8-device CPU mesh, three
    steps from ``inputs``' init with ``CFG``'s optimizer (that of
    ``tests/test_parallel.py``): the losses and the first step's parameters
    by the port's names."""
    import jax
    import jax.numpy as jnp
    import ml_collections

    from dposer_tpu import parallel as jpar
    from dposer_tpu.diffusion import losses as jlosses
    from dposer_tpu.diffusion import sde as jsde
    from dposer_tpu.models import ScoreModelFC as FlaxScoreModelFC
    from dposer_tpu.models.score_mlp import make_model_apply
    from dposer_tpu_torch.utils.checkpoint import state_dict_from_flax

    c = ml_collections.ConfigDict(dict(optim=vars(CFG.optim), model=vars(CFG.model)))
    fm = FlaxScoreModelFC(**TINY, dropout=0.0, scale_by_sigma=False)
    state, tx = jlosses.init_train_state(c, inputs["params"])
    mesh = jpar.make_mesh()
    assert mesh.devices.size == 8
    step = jpar.data_parallel_step(
        jlosses.get_step_fn(jsde.SubVPSDE(N=1000), True, make_model_apply(fm), tx=tx,
                            reduce_mean=True), mesh)
    losses = []
    for s in range(STEPS):
        state, ld = step(state, jax.random.PRNGKey(100 + s),
                         jpar.shard_batch(mesh, jnp.asarray(inputs["x"][s])))
        losses.append(float(ld["step_loss"]))
        if s == 0:
            sd = state_dict_from_flax(jax.tree.map(np.asarray, state.params))
    return losses, {k: v.numpy().reshape(-1) for k, v in sd.items()}


def test_data_parallel_step_matches_jax_sharded_step(group, one_process, jax_steps):
    """The port's data-parallel autograd step at dropout 0 on JAX's t and z,
    three steps from JAX's init, against JAX's ``data_parallel_step``: every
    step's loss within 1e-5 relative, so the updates the two take agree
    where the loss sees them, and the parameters after the first step within
    1e-4 relative, 1e-6 absolute, the bounds of ``tests/test_parallel.py``'s
    one step. Later parameters are not held element by element: the
    frameworks' gradients differ by float rounding, and Adam's normalisation
    carries that into whole steps of elements whose gradient is near 0
    (measured up to 4e-5)."""
    losses, first = jax_steps
    model = ScoreModelFC(**TINY, dropout=0.0, scale_by_sigma=False)
    named = [(n, p.numel()) for n, p in model.named_parameters() if p.requires_grad]
    _, ranks = group
    for out in (one_process, ranks[0]):
        np.testing.assert_allclose(out["jax_losses"], losses, rtol=LOSS_RTOL)
        got = np.split(out["jax_params_step1"], np.cumsum([k for _, k in named])[:-1])
        for (name, _), g in zip(named, got):
            if not name.startswith("pre_dense_cond"):  # the dead layer
                np.testing.assert_allclose(g, first[name], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                           err_msg=name)


def test_rank_rows_and_backend_checks():
    assert par.rank_rows(16) == slice(0, 16) and par.grad_backend() is None
    assert par.shard_global_multi_batch(np.zeros((3, 16))).shape == (3, 16)
    with pytest.raises(ValueError, match="backend"):
        par.init_distributed("file:///nonexistent", 1, 0, backend="mpi")


# ---------------------------------------------------------------------------
# The trainer CLI as processes
# ---------------------------------------------------------------------------

CONFIG = """
from dposer_tpu_torch.config import get_config as _base


def get_config():
    c = _base()
    c.OUTPUT_DIR = {out!r}
    c.model.HIDDEN_DIM, c.model.EMBED_DIM, c.model.N_BLOCKS = 64, 32, 1
    c.training.batch_size, c.training.n_iters = 16, {n_iters}
    c.training.log_freq, c.training.eval_freq, c.training.save_freq = 1, 10 ** 9, 3
    return c
"""
ENV = dict(os.environ, DPOSER_TENSORBOARD="0", OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def amass(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_amass")
    rng = np.random.default_rng(0)
    for subset, n in (("train", 160), ("test", 200)):
        d = root / "v1" / subset
        d.mkdir(parents=True)
        np.save(d / "pose_body.npy", (0.4 * rng.normal(size=(n, 63))).astype(np.float32))
    return str(root)


def _train_argv(cfg, data, *extra):
    return ["-m", "dposer_tpu_torch.train", "--config", cfg, "--dataset-folder", data,
            "--version", "v1", "--bodymodel-path", "", "--device", "cpu", "--seed", "3",
            "--train-kernel", "on", *extra]


def _losses(log: str) -> list:
    import re

    return [float(x) for x in re.findall(r"step_loss: ([\d.eE+-]+)", log)]


TRAIN = ("import runpy, sys; sys.argv = ['train'] + {argv!r}; "
         "runpy.run_module('dposer_tpu_torch.train', run_name='__main__')")


def _train_scripts(cfg, data, url, n, *extra):
    """The trainer as ``n`` processes of one group (one process alone when
    ``url`` is None)."""
    argv = _train_argv(cfg, data, *extra)[2:]
    if url is None:
        return [TRAIN.format(argv=argv)]
    return [TRAIN.format(argv=argv + ["--multihost", "--coordinator", url, "--num-processes",
                                      str(n), "--process-id", str(r)]) for r in range(n)]


def _write(path, out, n_iters):
    with open(path, "w") as f:
        f.write(CONFIG.format(out=str(out), n_iters=n_iters))
    return str(path)


def test_trainer_two_processes_equal_one(amass, tmp_path):
    """``python -m dposer_tpu_torch.train --multihost`` as two CPU processes,
    the kernel route's plain versions at dropout 0.1, at
    ``--steps-per-dispatch`` 1 and 3, against one process: every step's
    logged loss within 1e-4 relative (``tests/test_cli_parallel.py``'s
    bound), the route line naming the processes and the backend, a run
    directory and checkpoints a process; then a two-process resume from the
    step-3 checkpoint equals the one-process run's steps 4-6 within the same
    bound, its parameters within 1e-4 relative, 1e-6 absolute, and its
    ranks' checkpoints bit-equal."""
    scripts = _train_scripts(_write(tmp_path / "one.py", tmp_path / "one", 6), amass, None, 1)
    for k in (1, 3):
        scripts += _train_scripts(_write(tmp_path / f"k{k}.py", tmp_path / f"two_k{k}", 6),
                                  amass, f"file://{tmp_path / f'rdv{k}'}", 2,
                                  "--steps-per-dispatch", str(k))
    logs = run_processes(scripts, env=ENV)
    ref = _losses(logs[0])
    assert len(ref) == 6
    for k, pair in zip((1, 3), (logs[1:3], logs[3:5])):
        out = tmp_path / f"two_k{k}"
        for r, log in enumerate(pair):
            np.testing.assert_allclose(_losses(log), ref, rtol=1e-4, err_msg=f"K={k} rank {r}")
            assert (f"data-parallel: process {r} of 2 on cpu, gradient all-reduce over gloo, "
                    "8 of 16 rows a step") in log
            assert "data-parallel over 2 processes (gloo)" in log
        dirs = sorted(os.listdir(out / "amass_amass"))
        assert [d.rsplit("-", 1)[1] for d in dirs] == ["rank0", "rank1"]
        ck = [torch.load(out / "amass_amass" / d / "checkpoint-step6.pth", weights_only=True)
              for d in dirs]
        for name, v in ck[0]["model_state_dict"].items():
            assert torch.equal(v, ck[1]["model_state_dict"][name]), name
    # resume both ranks from rank 0's step-3 checkpoint of the K = 1 run
    k1 = tmp_path / "two_k1" / "amass_amass"
    first = str(k1 / sorted(os.listdir(k1))[0] / "checkpoint-step3.pth")
    logs = run_processes(_train_scripts(_write(tmp_path / "res.py", tmp_path / "res", 6), amass,
                                        f"file://{tmp_path / 'rdv_res'}", 2, "--restore-dir",
                                        first), env=ENV)
    for log in logs:
        assert "loaded checkpoint (step 3; optimizer state restored)" in log
        np.testing.assert_allclose(_losses(log), ref[3:], rtol=1e-4)
    one_dir = tmp_path / "one" / "amass_amass"
    (sub,) = os.listdir(one_dir)
    want = torch.load(one_dir / sub / "checkpoint-step6.pth", weights_only=True)
    res_dirs = sorted(os.listdir(tmp_path / "res" / "amass_amass"))
    got = [torch.load(tmp_path / "res" / "amass_amass" / d / "checkpoint-step6.pth",
                      weights_only=True) for d in res_dirs]
    for name, v in want["model_state_dict"].items():
        assert torch.equal(got[0]["model_state_dict"][name], got[1]["model_state_dict"][name])
        np.testing.assert_allclose(got[0]["model_state_dict"][name].numpy(), v.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)


def test_trainer_sigterm_on_one_rank_stops_both_at_one_step(amass, tmp_path):
    """A SIGTERM to rank 0 alone: the flag rides in a window's last
    all-reduce, so both ranks stop after the same step, write their
    preemption checkpoints there and exit 0."""
    cfg = _write(tmp_path / "c.py", tmp_path / "out", 10 ** 6)
    env = dict(ENV, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for script in _train_scripts(cfg, amass, f"file://{tmp_path / 'rdv'}", 2)]
    try:
        deadline = time.time() + JOIN_S
        for line in procs[0].stdout:
            if "Iter: [5/" in line or time.time() > deadline:
                break
        procs[0].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], outs[1][-3000:]
    steps = []
    for r, out in enumerate(outs):
        assert "preemption checkpoint saved" in out, out[-3000:]
        (d,) = [d for d in os.listdir(tmp_path / "out" / "amass_amass") if d.endswith(f"rank{r}")]
        steps.append(sorted(int(f[len("checkpoint-step"):-4]) for f in
                            os.listdir(tmp_path / "out" / "amass_amass" / d)
                            if f.startswith("checkpoint-step"))[-1])
    assert steps[0] == steps[1] >= 5


# ---------------------------------------------------------------------------
# The _params samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_params_samplers_after_a_weight_swap_equal_fresh_ones(shards):
    """A kernel sampler built once on one model's weights, run by the
    ``_params`` forms on another's (its operands rewritten in place, the
    eager loop on the plain versions here), against a sampler built fresh
    on the second model, on the same generator state: equal bit for bit,
    alone and on a mesh of two CPU devices, and for the hypothesis
    sampler."""
    sde = SubVPSDE(N=50)
    torch.manual_seed(1)
    first = ScoreModelFC(**TINY, dropout=0.0).eval()
    torch.manual_seed(2)
    second = ScoreModelFC(**TINY, dropout=0.0).eval()
    kw = dict(sde=sde, shape=(8, D), device="cpu", rng_mode="host", corrector="langevin",
              mesh=None if shards == 1 else Mesh(["cpu"] * shards))
    built = get_cuda_em_sampler(model=first, **kw)
    run = par.data_parallel_sampler_params(built)
    a = run(second, torch.Generator().manual_seed(5))
    b = get_cuda_em_sampler(model=second, **kw)(torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert not torch.equal(a, run(first, torch.Generator().manual_seed(5)))
    obs = torch.randn(4, D, generator=torch.Generator().manual_seed(6))
    mask = (torch.rand(4, D, generator=torch.Generator().manual_seed(7)) < 0.5).float()
    hkw = dict(kw, shape=(4, D))
    hypo = par.multi_hypothesis_imputation_sampler_params(
        get_cuda_em_hypo_sampler(model=first, hypo_num=2, **hkw))
    h = hypo(second, torch.Generator().manual_seed(8), obs, mask)
    ref = get_cuda_em_hypo_sampler(model=second, hypo_num=2, **hkw)(
        torch.Generator().manual_seed(8), obs, mask)
    assert h.shape == (4, 2, D) and torch.equal(h, ref)


def test_load_params_refuses_another_architecture():
    sde = SubVPSDE(N=1000)
    sampler = get_cuda_em_sampler(sde, ScoreModelFC(**TINY, dropout=0.0).eval(), (4, D),
                                  device="cpu", rng_mode="host")
    with pytest.raises(ValueError, match="does not fit|operands do not fit"):
        sampler.load_params(ScoreModelFC(**dict(TINY, hidden_dim=128), dropout=0.0).eval())



def test_data_parallel_benchmark_on_the_cpu():
    """``python -m dposer_tpu_torch.benchmarks.data_parallel --device cpu``
    (the pinned weights, two gloo ranks, a global batch of 8, 2 steps): its
    JSON line says the ranks are bit-equal and their first losses lie
    within 1e-4 relative of one process's, ``chip_smoke.py`` 5q's bound for
    this run at bf16 weights (the one-process step's rounding moves a bf16
    weight across a rounding boundary now and then; measured 4.1e-5 here),
    and the all-reduce timed inside a step takes a share of its wall above 0
    and at most 1."""
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.benchmarks.data_parallel",
                        "--device", "cpu", "--batch", "8", "--steps", "2", "--timeout",
                        str(JOIN_S)], cwd=REPO, env=dict(ENV, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=JOIN_S)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    import json

    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["ranks"] == 2 and out["backends"] == ["gloo", "gloo"]
    assert out["ranks_bit_equal"] and out["first_losses_max_rel"] <= 1e-4
    assert out["grad_bytes"] == 4 * 7227967  # the flagship's trained parameters
    for ms, share in zip(out["allreduce_in_step_ms"], out["allreduce_share"]):
        assert 0.0 < ms and 0.0 < share <= 1.0  # timed inside the step, so within its wall
