"""The port's serving over several devices (``dposer_tpu_torch.parallel``) on
a mesh of 8 CPU devices, against the port's single-device routes and JAX's
sharded interpret routes on the conftest's 8-device CPU mesh: the four
sharded kernel wrappers (EM sampler, completion solver, RK4 PF-ODE sampler,
likelihood) on their plain versions with injected inputs, the seed fold,
the hypothesis samplers, ``DPoserComp(mesh=)``, the kernel-free samplers'
data-parallel forms, and multi-process evaluation over gloo (two CPU
processes, each joined with a timeout). A one-block net at hidden 128."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu import parallel as jpar
from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.ops.pallas.fused_comp import get_pallas_comp_solver
from dposer_tpu.ops.pallas.fused_em import get_pallas_em_sampler
from dposer_tpu.ops.pallas.fused_lik import get_pallas_likelihood_fn
from dposer_tpu.ops.pallas.fused_ode import get_pallas_ode_sampler
from dposer_tpu_torch import completion as cli
from dposer_tpu_torch import demo
from dposer_tpu_torch import parallel as par
from dposer_tpu_torch.diffusion import few_step
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.ops.cuda.fused_comp import get_cuda_comp_solver
from dposer_tpu_torch.ops.cuda.fused_em import (get_cuda_em_hypo_sampler, get_cuda_em_sampler,
                                                launch_counts, reset_launch_counts)
from dposer_tpu_torch.ops.cuda.fused_lik import get_cuda_likelihood_fn
from dposer_tpu_torch.ops.cuda.fused_ode import get_cuda_ode_sampler
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.tasks import DPoserComp
from dposer_tpu_torch.utils.checkpoint import torch_parameter_order

from fixtures import make_stats_dir, make_synthetic_body_model
from test_torch_completion_cli import PART, workdir  # noqa: F401 (the CLI's fixture)
from test_torch_demo import TINY_CONFIG
from test_torch_model import SMALL, flax_and_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SHARDS, B, D = 8, 16, 63
R = B // N_SHARDS  # rows a shard
JOIN_S = 120  # the seconds a test waits for one of its processes


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Tiny tensors: one thread is the fastest, and the processes that the
    multi-process tests compare run on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """One block at hidden 128 (the JAX likelihood kernel needs hidden %
    128 == 0), sigma-scaled, 1000 sigma scales (the solver's strategy '3'
    stays inside the ladder at N = 500)."""
    return flax_and_torch(**dict(SMALL, n_blocks=1, scale_by_sigma=True, num_scales=1000))


@pytest.fixture(scope="module")
def ode_nets():
    """The PF-ODE tests' net (test_torch_ode.py, test_torch_likelihood.py):
    without the sigma scaling, whose untrained field the RK4 steps blow up."""
    return flax_and_torch(**dict(SMALL, n_blocks=1, scale_by_sigma=False))


@pytest.fixture(scope="module")
def mesh():
    return par.make_mesh(devices=["cpu"] * N_SHARDS)


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _obs_mask(rows=B, seed=13):
    mask = np.zeros((rows, D), np.float32)
    mask[:, 39:45] = 1.0
    return _normal(seed, (rows, D), 0.3), mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _scaled_close(out, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=rel * max(1.0, float(np.abs(ref).max())))


def _shard(x, r, axis=0):
    return x.narrow(axis, r * x.shape[axis] // N_SHARDS, x.shape[axis] // N_SHARDS).contiguous()


def test_pad_batch_and_eval_shards_match_jax():
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    for multiple in (8, 5, 1):
        (a, n), (b, m) = par.pad_batch_to_multiple(x, multiple), \
            jpar.pad_batch_to_multiple(x, multiple)
        assert n == m == 10
        np.testing.assert_array_equal(a, np.asarray(b))
    # even, ragged (13 batches over 8 processes), dropped tails, more processes than batches
    for n_poses, bs, pc in ((1000, 10, 8), (130, 10, 8), (3213, 100, 2), (30, 10, 4)):
        ranges = [par.shard_eval_batches(n_poses, bs, pi, pc) for pi in range(pc)]
        assert ranges == [jpar.shard_eval_batches(n_poses, bs, pi, pc) for pi in range(pc)]
        assert [i for r in ranges for i in r] == list(range(n_poses // bs))
    # one process, no group: the whole range, and the gather is the identity
    assert par.shard_eval_batches(1000, 10) == range(100)
    arr = np.asarray([1.0, 2.0, 3.0], np.float32)
    np.testing.assert_array_equal(par.allgather_ragged_1d(arr), arr)


def test_mesh_construction():
    m = par.make_mesh(devices=["cpu"] * 3)
    assert m.size == 3 and all(d == torch.device("cpu") for d in m.devices)
    if not torch.cuda.is_available():  # no silent CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            par.make_mesh()
    with pytest.raises(ValueError):
        par.Mesh([])
    # the fold is splitmix64's output r + 1 from the draw
    assert par.fold_seed(0, 0) == 0xE220A8397B1DCDAF
    assert len({par.fold_seed(7, r) for r in range(64)}) == 64


@pytest.mark.parametrize("visible,share,want", [
    (4, (0, 1), [0, 1, 2, 3]),   # no process group: every visible card
    (4, (1, 2), [2, 3]),         # two processes on a host of four cards
    (5, (0, 2), [0, 1, 2]),      # the first process takes the odd card
    (5, (1, 2), [3, 4]),
    (1, (1, 2), [0]),            # two processes share one card
    (2, (2, 3), [0]),            # three processes on two cards
], ids=["alone", "half", "odd-first", "odd-second", "shared-card", "more-processes"])
def test_make_mesh_takes_this_process_share_of_the_cards(monkeypatch, visible, share, want):
    """The default mesh holds this process's own cards: with a monkeypatched
    CUDA device count and host share, never another process's share of the
    host's cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(par.sharding, "host_share", lambda: share)
    assert par.make_mesh().devices == tuple(torch.device("cuda", i) for i in want)


@pytest.mark.parametrize("corrector,imputation", [("none", False), ("langevin", True)])
def test_sharded_sampler_matches_single_device_and_jax(nets, mesh, corrector, imputation):
    """EM at N = 20 with injected z and noise [N, K, B, D] (axis 2 sharded).
    Corrector-free, the sharded plain route equals the single-device one;
    under langevin the batch-mean norms are per shard, so shard r equals a
    single-device call at B/8 rows on r's rows (with imputation too). Both
    against JAX's sharded kernel in interpret mode at the bound of
    test_torch_kernels.py's parity test, 2e-2*max(1, |ref|max)."""
    fm, params, tm = nets
    n = 20
    k = (1 if corrector == "langevin" else 0) + (2 if imputation else 0) + 1
    z, noise = _normal(1, (B, D)), _normal(2, (n, k, B, D))
    obs, mask = _obs_mask()
    kw = dict(eps=1e-3, corrector=corrector, snr=0.16, n_corrector_steps=1,
              imputation=imputation)
    jio = dict(observation=jnp.asarray(obs), mask=jnp.asarray(mask)) if imputation else {}
    tio = dict(zip(("observation", "mask"), _t(obs, mask))) if imputation else {}
    _, ref = get_pallas_em_sampler(jsde.SubVPSDE(N=n), fm, params, (B, D), interpret=True,
                                   rng_mode="host", mesh=jpar.make_mesh(), **kw)(
        jax.random.PRNGKey(0), z=jnp.asarray(z), noise=jnp.asarray(noise), **jio)
    ts = tsde.SubVPSDE(N=n)
    tz, tnoise = _t(z, noise)
    reset_launch_counts()
    sharded = get_cuda_em_sampler(ts, tm, (B, D), plain=True, mesh=mesh, **kw)
    out = sharded(z=tz, noise=tnoise, **tio)
    assert len(sharded.shards) == N_SHARDS and len(sharded.loops) == N_SHARDS
    _scaled_close(out, ref, 2e-2)
    single = get_cuda_em_sampler(ts, tm, (R, D), device="cpu", plain=True, **kw)
    for r in range(N_SHARDS):
        part = single(z=_shard(tz, r), noise=_shard(tnoise, r, 2),
                      **{nm: _shard(t, r) for nm, t in tio.items()})
        assert torch.equal(_shard(out, r), part), r
    if corrector == "none":
        whole = get_cuda_em_sampler(ts, tm, (B, D), device="cpu", plain=True, **kw)(
            z=tz, noise=tnoise, **tio)
        assert torch.equal(out, whole)
    else:  # the observed dims stay pinned near the observation
        assert float(((out - tio["observation"]) * tio["mask"]).abs().max()) < 5e-2
    assert sum(launch_counts().values()) == 0  # CPU tensors: the plain versions


def test_sharded_comp_solver_matches_single_device_and_jax(nets, mesh):
    """The 1x5-step solver on 16 rows (2 a shard), injected noise [T, R, D]
    sharded along axis 1, n_elems global: exactly the single-device plain
    route (as tests/test_pallas_comp.py:145 holds JAX's), and JAX's sharded
    kernel in interpret mode at test_torch_completion.py's 5e-3 bound."""
    fm, params, tm = nets
    obs, mask = _obs_mask()
    noise = _normal(3, (5, B, D))
    kw = dict(iterations=1, steps_per_iter=5)
    ref = get_pallas_comp_solver(jsde.SubVPSDE(N=500), fm, params, (B, D), n_elems=B * D,
                                 interpret=True, mesh=jpar.make_mesh(), **kw)(
        jax.random.PRNGKey(2), jnp.asarray(obs), jnp.asarray(mask), noise=jnp.asarray(noise))
    ts = tsde.SubVPSDE(N=500)
    tobs, tmask, tnoise = _t(obs, mask, noise)
    out = get_cuda_comp_solver(ts, tm, (B, D), B * D, plain=True, mesh=mesh, **kw)(
        None, tobs, tmask, noise=tnoise)
    whole = get_cuda_comp_solver(ts, tm, (B, D), B * D, device="cpu", plain=True, **kw)(
        None, tobs, tmask, noise=tnoise)
    np.testing.assert_array_equal(out.numpy(), whole.numpy())
    _scaled_close(out, ref, 5e-3)
    # the fused loop (K6's perturbation fold on the CPU) shards the same way
    fused = get_cuda_comp_solver(ts, tm, (B, D), B * D, mesh=mesh, **kw)(
        None, tobs, tmask, noise=tnoise)
    np.testing.assert_array_equal(fused.numpy(), get_cuda_comp_solver(
        ts, tm, (B, D), B * D, device="cpu", **kw)(None, tobs, tmask, noise=tnoise).numpy())
    np.testing.assert_array_equal(out.numpy() * mask, obs * mask)


def test_dposer_comp_mesh(nets, mesh):
    """``DPoserComp(backend="cuda", mesh=)``: 6 poses x 4 hypotheses as 24
    rows over 8 shards, the observed dims pasted exactly; with injected
    noise on 16 rows (2 a shard) it equals the unsharded solver exactly; the
    autograd backend and rows that do not divide the mesh refuse."""
    _, _, tm = nets
    ts = tsde.SubVPSDE(N=500)
    obs, mask = _t(*_obs_mask(6, seed=21))
    kw = dict(iterations=1, steps_per_iter=4, backend="cuda", model=tm)
    comp = DPoserComp(ts, mesh=mesh, **kw)
    hyp = comp.optimize_hypos(obs, mask, 4, torch.Generator().manual_seed(0))
    assert hyp.shape == (6, 4, D) and torch.isfinite(hyp).all()
    assert torch.equal(hyp * mask[:, None], (obs * mask)[:, None].expand_as(hyp))
    assert float((hyp[:, 0] - hyp[:, 1]).abs().max()) > 1e-4  # hypotheses differ
    (solver,) = comp.cuda_solvers()
    assert len(solver.loops) == N_SHARDS
    obs16, mask16 = _t(*_obs_mask(seed=22))
    noise = torch.from_numpy(_normal(4, (4, B, D)))
    a = comp.optimize(obs16, mask16, noise=noise)
    b = DPoserComp(ts, device="cpu", **kw).optimize(obs16, mask16, noise=noise)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        comp.optimize(obs, mask, noise=noise[:, :6])  # 6 rows on 8 shards
    with pytest.raises(ValueError):
        DPoserComp(ts, model=tm, mesh=mesh)  # the autograd solver is one device's


def test_sharded_ode_and_likelihood_match_single_device_and_jax(ode_nets, mesh):
    """RK4 PF-ODE sampling (20 steps, z injected) and the likelihood (25
    steps at eps 1e-4, the probe injected as JAX's shards draw it:
    Rademacher from the key folded by the shard's index), the settings of
    test_torch_ode.py's and test_torch_likelihood.py's parity tests: equal
    to the single-device plain routes, and to JAX's sharded kernels in
    interpret mode at those tests' bounds (5e-3*max(1, |ref|max); z
    3e-2*max(1, |ref|max), 0.1 bits/dim)."""
    fm, params, tm = ode_nets
    js, ts = jsde.SubVPSDE(N=100), tsde.SubVPSDE(N=100)
    jmesh = jpar.make_mesh()
    z = _normal(5, (B, D))
    nfe_ref, ref = get_pallas_ode_sampler(js, fm, params, (B, D), n_steps=20, eps=1e-3,
                                          interpret=True, mesh=jmesh)(jax.random.PRNGKey(1),
                                                                      z=jnp.asarray(z))
    nfe, out = get_cuda_ode_sampler(ts, tm, (B, D), n_steps=20, eps=1e-3, plain=True,
                                    mesh=mesh)(z=torch.from_numpy(z))
    assert nfe == nfe_ref == 80
    _, whole = get_cuda_ode_sampler(ts, tm, (B, D), n_steps=20, eps=1e-3, device="cpu",
                                    plain=True)(
        z=torch.from_numpy(z))
    assert torch.equal(out, whole)
    _scaled_close(out, ref, 5e-3)

    data = _normal(6, (B, D), 0.5)
    key = jax.random.PRNGKey(5)
    epsv = np.concatenate([np.asarray(jax.random.rademacher(jax.random.fold_in(key, r), (R, D),
                                                            jnp.float32))
                           for r in range(N_SHARDS)])
    bpd_ref, z_ref, nfe_ref = get_pallas_likelihood_fn(js, fm, params, (B, D), n_steps=25,
                                                       eps=1e-4, interpret=True,
                                                       mesh=jmesh)(key, jnp.asarray(data))
    lik = get_cuda_likelihood_fn(ts, tm, (B, D), n_steps=25, eps=1e-4, plain=True, mesh=mesh)
    bpd, zl, nfe = lik(None, torch.from_numpy(data), epsilon=torch.from_numpy(epsv))
    assert nfe == nfe_ref == 100 and bpd.shape == (B,) and len(lik.loops) == N_SHARDS
    bpd1, z1, _ = get_cuda_likelihood_fn(ts, tm, (B, D), n_steps=25, eps=1e-4, device="cpu",
                                         plain=True)(None, torch.from_numpy(data),
                                                     epsilon=torch.from_numpy(epsv))
    assert torch.equal(bpd, bpd1) and torch.equal(zl, z1)
    _scaled_close(zl, z_ref, 3e-2)
    np.testing.assert_allclose(bpd.numpy(), np.asarray(bpd_ref), rtol=0, atol=0.1)


def test_seed_fold(nets, mesh):
    """Shard r's draws come from a generator seeded with ``fold_seed`` of
    one 64-bit draw of the caller's: each shard equals a single-device call
    with that generator (the prior and host normals of the sampler, the
    likelihood's probe), and the shards' draws differ."""
    _, _, tm = nets
    ts = tsde.SubVPSDE(N=20)
    out = get_cuda_em_sampler(ts, tm, (B, D), plain=True, mesh=mesh)(
        torch.Generator().manual_seed(3))
    gens = par.shard_generators(mesh, torch.Generator().manual_seed(3))
    single = get_cuda_em_sampler(ts, tm, (R, D), device="cpu", plain=True)
    for r in range(N_SHARDS):
        assert torch.equal(_shard(out, r), single(gens[r])), r
    assert float((_shard(out, 0) - _shard(out, 1)).abs().max()) > 1e-3
    data = torch.from_numpy(_normal(7, (B, D), 0.3))
    bpd, _, _ = get_cuda_likelihood_fn(ts, tm, (B, D), n_steps=2, plain=True, mesh=mesh)(
        torch.Generator().manual_seed(4), data)
    gens = par.shard_generators(mesh, torch.Generator().manual_seed(4))
    lik1 = get_cuda_likelihood_fn(ts, tm, (R, D), n_steps=2, device="cpu", plain=True)
    for r in range(N_SHARDS):
        assert torch.equal(_shard(bpd, r), lik1(gens[r], _shard(data, r))[0]), r


@pytest.mark.parametrize("what", ["em", "comp", "ode", "lik"])
def test_indivisible_batch_raises_and_a_mesh_of_one_is_the_single_route(nets, mesh, what):
    _, _, tm = nets
    ts = tsde.SubVPSDE(N=20)
    build = dict(em=lambda shape, **k: get_cuda_em_sampler(ts, tm, shape, **k),
                 comp=lambda shape, **k: get_cuda_comp_solver(ts, tm, shape, shape[0] * D,
                                                              iterations=1,
                                                              steps_per_iter=2, **k),
                 ode=lambda shape, **k: get_cuda_ode_sampler(ts, tm, shape, n_steps=2, **k),
                 lik=lambda shape, **k: get_cuda_likelihood_fn(ts, tm, shape, n_steps=2, **k),
                 )[what]
    with pytest.raises(ValueError, match="divisible by the mesh size 8"):
        build((B + 4, D), mesh=mesh)
    one = build((B, D), mesh=par.make_mesh(devices=["cpu"]))
    assert not hasattr(one, "shards") and len(one.loops) == 1


def test_sharded_hypothesis_samplers(nets, mesh):
    """The pc, DDIM and hybrid hypothesis samplers with ``mesh=``: 4 poses x
    4 hypotheses tiled hypothesis-major into 16 rows over 8 shards, equal to
    the unsharded samplers on the same z and noise in the tiled row space,
    the observed dims pinned."""
    _, _, tm = nets
    ts = tsde.SubVPSDE(N=50)
    obs, mask = _t(*_obs_mask(4, seed=31))
    z = torch.from_numpy(_normal(8, (B, D)))
    builds = {
        "pc": (lambda **k: get_cuda_em_hypo_sampler(ts, tm, (4, D), 4, **k),
               lambda s, **k: s(None, obs, mask, **k),
               dict(noise=torch.from_numpy(_normal(9, (50, 3, B, D))))),
        "ddim": (lambda **k: few_step.get_cuda_ddim_hypo_sampler(ts, tm, (4, D), 4,
                                                                 n_steps=4, **k),
                 lambda s, **k: s(None, obs, mask, **k)[1],
                 dict(noise=torch.from_numpy(_normal(10, (5, 3, B, D))))),
        "hybrid": (lambda **k: few_step.get_cuda_hybrid_hypo_sampler(ts, tm, (4, D), 4,
                                                                     n_head=3, m_tail=10, **k),
                   lambda s, **k: s(None, obs, mask, **k)[1],
                   dict(noise=(torch.from_numpy(_normal(11, (3, 3, B, D))),
                               torch.from_numpy(_normal(12, (10, 3, B, D)))))),
    }
    for name, (build, call, inj) in builds.items():
        sharded = build(mesh=mesh, plain=True)
        out = call(sharded, z=z, **inj)
        assert out.shape == (4, 4, D), name
        assert torch.equal(out, call(build(device="cpu", plain=True), z=z, **inj)), name
        assert float(((out - obs[:, None]) * mask[:, None]).abs().max()) < 5e-2, name
        assert len(sharded.loops) in (N_SHARDS, 2 * N_SHARDS), name


def test_data_parallel_kernel_free_samplers(nets, mesh):
    """DPM-Solver++ (no kernel in either package) through
    ``data_parallel_sampler``: 50 rows on 8 shards run padded to 56 and
    trimmed, equal to the unsharded sampler on the same z;
    ``multi_hypothesis_imputation_sampler`` tiles 5 poses x 3 hypotheses."""
    _, _, tm = nets
    ts = tsde.SubVPSDE(N=1000)

    def factory(dev, shape, **k):
        return few_step.get_dpm_sampler(ts, tm, shape, n_steps=4, device=dev, **k)

    z = torch.from_numpy(_normal(13, (50, D)))
    nfe, out = par.data_parallel_sampler(factory, mesh, (50, D))(z=z)
    nfe1, ref = factory("cpu", (50, D))(z=z)
    assert nfe == nfe1 and out.shape == (50, D)
    assert torch.equal(out, ref)
    _, drawn = par.data_parallel_sampler(factory, mesh, (50, D))(torch.Generator().manual_seed(1))
    assert drawn.shape == (50, D) and torch.isfinite(drawn).all()
    obs, mask = _t(*_obs_mask(5, seed=41))
    run = par.multi_hypothesis_imputation_sampler(
        lambda dev, shape: factory(dev, shape, imputation=True), mesh, (5, D), 3)
    nfe, hyp = run(torch.Generator().manual_seed(2), obs, mask)
    assert hyp.shape == (5, 3, D) and torch.isfinite(hyp).all()
    assert float(((hyp - obs[:, None]) * mask[:, None]).abs().max()) < 5e-2
    assert float((hyp[:, 0] - hyp[:, 1]).abs().max()) > 1e-3


def _run_processes(scripts, timeout=JOIN_S):
    """Start one ``python -c`` process a script, all at once, from the
    repository root; wait for each with a timeout (a hang fails the test);
    return their outputs."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", s], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for s in scripts]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, out
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


GATHER = """
import datetime, numpy as np
from dposer_tpu_torch import parallel as par
par.init_distributed({url!r}, 2, {rank}, timeout=datetime.timedelta(seconds=60))
out = par.allgather_ragged_1d(np.arange({n}, dtype=np.float32) + 10 * {rank})
print("GATHERED", out.tolist(), par.process_index(), par.process_count(),
      *par.sharding.host_share())
"""


def test_allgather_ragged_over_two_processes(tmp_path):
    url = f"file://{tmp_path / 'rendezvous'}"
    outs = _run_processes([GATHER.format(url=url, rank=r, n=n) for r, n in ((0, 3), (1, 5))])
    want = [0.0, 1.0, 2.0, 10.0, 11.0, 12.0, 13.0, 14.0]
    for rank, out in enumerate(outs):
        line = next(ln for ln in out.splitlines() if ln.startswith("GATHERED"))
        assert line == f"GATHERED {want} {rank} 2 {rank} 2", out  # one host, two processes


CLI_RANK = """
import numpy as np, torch
torch.set_num_threads(1)
from dposer_tpu_torch import completion as cli
r = cli.run(cli.parse_args({argv!r}))
np.savez({out!r}, mpjpe=r["mpjpe_body"], mpvpe=r["mpvpe_all"], batches=r["batch_indices"])
"""


def test_completion_cli_two_processes_equal_one(workdir, tmp_path, capsys):  # noqa: F811
    """``python -m dposer_tpu_torch.completion --multihost`` as two CPU
    processes over a file:// rendezvous (3 batches of 4 poses: ragged, 2 and
    1): the gathered per-sample MPJPE and MPVPE equal the one-process run
    sample by sample, and only rank 0 prints the averages."""
    w = workdir
    common = ["--device", "cpu", "--config-path", str(w["tmp"] / "torch_config.py"),
              "--ckpt-path", w["ckpt"], "--dataset-folder", w["root"], "--version",
              "version1", "--bodymodel-path", w["body"], "--part", PART, "--hypo", "1",
              "--batch_size", "4", "--steps", "50", "--sample", "256"]
    url = f"file://{tmp_path / 'rendezvous'}"
    scripts = [CLI_RANK.format(argv=common + ["--multihost", "--coordinator", url,
                                              "--num-processes", "2", "--process-id",
                                              str(r)],
                               out=str(tmp_path / f"rank{r}.npz")) for r in range(2)]
    outs = _run_processes(scripts)
    one = cli.run(cli.parse_args(common))
    assert one["n_batches"] == 3 and "The average of" in capsys.readouterr().out
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    assert [list(f["batches"]) for f in ranks] == [[0, 1], [2]]
    for f in ranks:  # every process holds every sample, in batch order
        np.testing.assert_array_equal(f["mpjpe"], one["mpjpe_body"])
        np.testing.assert_array_equal(f["mpvpe"], one["mpvpe_all"])
    assert "The average of mpjpe_body" in outs[0]
    assert "The average of" not in outs[1]


def test_init_distributed_checks_its_arguments(monkeypatch):
    for k in par.sharding.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE"):
        par.init_distributed()
    with pytest.raises(ValueError, match="--process-id"):
        par.init_distributed("127.0.0.1:1", num_processes=2)
    with pytest.raises(ValueError, match="out of range"):
        par.init_distributed("127.0.0.1:1", num_processes=2, process_id=2)
    assert par.process_index() == 0 and par.process_count() == 1


@pytest.fixture(scope="module")
def demo_dir(tmp_path_factory):
    """tests/test_torch_demo.py's tiny config and checkpoint (hidden 64, N =
    50), identity-like stats, the synthetic bodies and 7 poses."""
    tmp = tmp_path_factory.mktemp("torch_demo_mesh")
    (tmp / "tiny_config.py").write_text(TINY_CONFIG)
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=64, embed_dim=32, n_blocks=1,
                         scale_by_sigma=False, num_scales=50)
    sd = model.state_dict()
    torch.save({"model_state_dict": sd, "optimizer_state_dict": {}, "epoch": 0, "step": 7,
                "ema": {"decay": 0.999, "num_updates": 7,
                        "shadow_params": [sd[n].clone() for n in torch_parameter_order(1)]}},
               tmp / "tiny.pth")
    np.savez(tmp / "poses.npz", pose_samples=0.1 + 0.2 * _normal(0, (7, D)))
    return dict(tmp=tmp, stats=make_stats_dir(tmp / "stats", mean=np.full(D, 0.1),
                                              std=np.full(D, 0.2)),
                smpl=make_synthetic_body_model(tmp / "smpl.npz", "smpl")[0],
                smplx=make_synthetic_body_model(tmp / "smplx.npz", "smplx")[0])


@pytest.mark.parametrize("task,extra,n_dev,sharded", [
    ("generation", ["--metrics"], 3, True),
    ("generation", ["--sampler", "dpm", "--sampler-steps", "3"], 3, False),
    ("completion", [], 2, True),
    ("completion2", ["--sampler", "pc"], 2, True),
    ("completion2", ["--sampler", "ddim", "--sampler-steps", "3"], 2, True),
    ("completion2", ["--sampler", "hybrid", "--sampler-steps", "3", "--hybrid-tail", "5"], 2,
     True),
    ("completion2", ["--sampler", "dpm", "--sampler-steps", "3"], 2, False),
    ("completion", [], 3, False),
], ids=["generation-metrics", "generation-dpm", "completion", "completion2-pc",
        "completion2-ddim", "completion2-hybrid", "completion2-dpm", "completion-indivisible"])
def test_demo_tasks_on_a_mesh(demo_dir, task, extra, n_dev, sharded, capsys):
    """The demo's routes on a mesh of CPU devices, sharded where the JAX demo
    shards: the generation and metrics sampler on 3 devices, its 50 and 500
    samples padded and trimmed; the solver and the pc, DDIM and hybrid
    hypothesis samplers on 2, which 7 poses x 2 hypotheses divide, and the
    solver on one device when 3 does not divide them; DPM-Solver++ on one
    device. The outputs keep their shapes, the solver pastes the observed
    dims, and each route says whether it ran over the shards."""
    w = demo_dir
    out = w["tmp"] / f"out_{task}_{'_'.join(extra)}_{n_dev}"
    args = demo.parse_args(["--task", task, "--device", "cpu",
                            "--config-path", str(w["tmp"] / "tiny_config.py"),
                            "--ckpt-path", str(w["tmp"] / "tiny.pth"), "--stats-dir", w["stats"],
                            "--output-path", str(out), "--seed", "3", "--hypo", "2",
                            "--file-path", str(w["tmp"] / "poses.npz"), "--bodymodel-path",
                            w["smplx"], "--smpl-path", w["smpl"], *extra])
    res = demo.run(args, mesh=par.make_mesh(devices=["cpu"] * n_dev))
    printed = capsys.readouterr().out
    assert f"[mesh] sharding over {n_dev} devices" in printed
    assert (f"over {n_dev} shards" in printed) == sharded, printed
    if task == "generation":
        with np.load(res["samples_file"]) as f:
            assert f["pose_samples"].shape == (50, D) and np.isfinite(f["pose_samples"]).all()
        if "--metrics" in extra:
            assert np.isfinite(res["apd"]) and res["apd"] > 0 and 0 <= res["si"] <= 100
        return
    with np.load(res["hypotheses_file"]) as f:
        hypos, mask, gts = f["pose_hypotheses"], f["mask"], f["gts"]
    assert hypos.shape == (7, 2, D) and np.isfinite(hypos).all()
    assert np.isfinite(res["mpjpe"]) and res["mpjpe"] > 0
    if task == "completion":
        np.testing.assert_allclose(hypos[:, 1] * mask, gts * mask, atol=1e-6)
