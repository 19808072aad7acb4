"""The loops that the card replays as CUDA graphs (``ops/cuda/graph_loop.py``),
run on the CPU as the graph captures them: on static buffers, with the
kernels' plain versions.

For each of the four loops (the EM sampler, the completion solver, the RK4
PF-ODE sampler, the likelihood) one loop is built and called twice in a row
on different inputs. Each call must match the TPU kernel in interpret mode on
the same inputs, at the bounds the existing kernel-path tests hold the same
comparison to, and be bit-equal to the call of a freshly built loop on the
same inputs: a buffer left unreset between calls would show there. Beside
them: the seed tensor of in-kernel normals keys the plain Philox stream as
its int does, the replay accounting of ``GraphLoop`` (its CUDA calls stood
in for), the refusals of ``loop="graph"`` off the card, and distinct
results from consecutive calls. Hidden 128, embed 64, 2 blocks, 8 rows.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.diffusion.score_fn import get_score_fn as jax_get_score_fn
from dposer_tpu.ops.pallas.fused_em import get_pallas_em_sampler
from dposer_tpu.ops.pallas.fused_lik import get_pallas_likelihood_fn
from dposer_tpu.ops.pallas.fused_ode import get_pallas_ode_sampler
from dposer_tpu.tasks import DPoserComp as JaxDPoserComp
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.ops.cuda import fused_em, graph_loop, philox, score_net
from dposer_tpu_torch.ops.cuda.fused_comp import get_cuda_comp_solver
from dposer_tpu_torch.ops.cuda.fused_em import (get_cuda_em_hypo_sampler,
                                                get_cuda_em_sampler, launch_counts,
                                                reset_launch_counts, route_counts)
from dposer_tpu_torch.ops.cuda.fused_lik import get_cuda_likelihood_fn
from dposer_tpu_torch.ops.cuda.fused_ode import get_cuda_ode_sampler

from test_torch_model import SMALL, flax_and_torch

SHAPE = (8, 63)
KEYS = (jax.random.PRNGKey(1), jax.random.PRNGKey(2))


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Tiny tensors through thousands of small calls: one thread is the
    fastest beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(ref):
    return max(1.0, float(np.abs(np.asarray(ref)).max()))


def _obs_mask(seed):
    rng = np.random.default_rng(seed)
    obs = (0.3 * rng.normal(size=SHAPE)).astype(np.float32)
    mask = np.zeros(SHAPE, np.float32)
    mask[:, 39 + seed % 6:45 + seed % 6] = 1.0
    return obs, mask


# ---------------------------------------------------------------------------
# the four loops: two calls of one loop against JAX and against a fresh loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corrector,imputation", [("none", False), ("langevin", False),
                                                  ("none", True), ("langevin", True)])
def test_em_sampler_static_buffers_across_calls(corrector, imputation):
    """The kernel sampler's loop on its static buffers, two calls with other
    z, noise (and observation and mask), against the TPU kernel in interpret
    mode at test_torch_kernels.py's bound for this comparison (2e-2 of the
    largest magnitude: bf16 operands, summed in another order), and bit-equal
    to a freshly built sampler on the same inputs."""
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    n = 20
    k = (1 if corrector == "langevin" else 0) + (2 if imputation else 0) + 1
    kw = dict(eps=1e-3, corrector=corrector, snr=0.16, n_corrector_steps=1,
              imputation=imputation)
    jax_sampler = get_pallas_em_sampler(jsde.SubVPSDE(N=n), fm, params, SHAPE, interpret=True,
                                        rng_mode="host", **kw)
    sampler = get_cuda_em_sampler(tsde.SubVPSDE(N=n), tm, SHAPE, device="cpu", **kw)
    assert [lp.graph for lp in sampler.loops] == [False]
    for call in range(2):
        rng = np.random.default_rng(30 + call)
        z = rng.normal(size=SHAPE).astype(np.float32)
        noise = rng.normal(size=(n, k) + SHAPE).astype(np.float32)
        io = dict(zip(("observation", "mask"), _obs_mask(call))) if imputation else {}
        _, ref = jax_sampler(KEYS[0], z=jnp.asarray(z), noise=jnp.asarray(noise),
                             **{nm: jnp.asarray(v) for nm, v in io.items()})
        ref = np.asarray(ref)
        args = dict(z=torch.from_numpy(z), noise=torch.from_numpy(noise),
                    **{nm: torch.from_numpy(v) for nm, v in io.items()})
        out = sampler(**args)
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-2 * _scaled(ref))
        fresh = get_cuda_em_sampler(tsde.SubVPSDE(N=n), tm, SHAPE, device="cpu", **kw)(**args)
        assert torch.equal(out, fresh)


@pytest.mark.parametrize("time_strategy", ["3", "2"])
def test_comp_solver_static_buffers_across_calls(time_strategy):
    """The kernel solver's loop on its static buffers, two calls with other
    observation, mask and noise, against the TPU kernel in interpret mode at
    test_torch_completion.py's bound (5e-3 of the largest magnitude), and
    bit-equal to a freshly built solver on the same inputs; x, m1 and v start
    afresh at every call."""
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True, num_scales=1000))
    js, ts = jsde.SubVPSDE(N=500), tsde.SubVPSDE(N=500)
    jscore = jax_get_score_fn(js, lambda x, t: fm.apply({"params": params}, x, t),
                              continuous=True)
    kw = dict(iterations=2, steps_per_iter=8, time_strategy=time_strategy)
    if time_strategy == "2":
        kw["sample_time"] = 400  # in range for N = 500
    pal = JaxDPoserComp(js, jscore, backend="pallas", model=fm, params=params, interpret=True,
                        **kw)
    n_elems = SHAPE[0] * SHAPE[1]
    solve = get_cuda_comp_solver(ts, tm, SHAPE, n_elems, device="cpu", **kw)
    for call in range(2):
        obs, mask = _obs_mask(call)
        noise = np.random.default_rng(7 + call).normal(size=(16,) + SHAPE).astype(np.float32)
        ref = np.asarray(pal.optimize(KEYS[call], jnp.asarray(obs), jnp.asarray(mask),
                                      noise=jnp.asarray(noise)))
        args = (None, torch.from_numpy(obs), torch.from_numpy(mask))
        out = solve(*args, noise=torch.from_numpy(noise))
        np.testing.assert_allclose(out.numpy(), ref, atol=5e-3 * _scaled(ref))
        np.testing.assert_array_equal(out.numpy() * mask, obs * mask)
        fresh = get_cuda_comp_solver(ts, tm, SHAPE, n_elems, device="cpu", **kw)(
            *args, noise=torch.from_numpy(noise))
        assert torch.equal(out, fresh)


@pytest.fixture(scope="module")
def pf_nets():
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=False))
    return fm, params, tm, jsde.SubVPSDE(N=100), tsde.SubVPSDE(N=100)


@pytest.mark.parametrize("denoise", [False, True])
def test_ode_sampler_static_buffers_across_calls(pf_nets, denoise):
    """The kernel RK4 sampler's loop on its static buffers, two calls with
    other z, against the TPU kernel in interpret mode at test_torch_ode.py's
    bound (5e-3 of the largest magnitude), and bit-equal to a freshly built
    sampler."""
    fm, params, tm, js, ts = pf_nets
    kw = dict(n_steps=20, eps=1e-3, denoise=denoise)
    jax_sampler = get_pallas_ode_sampler(js, fm, params, SHAPE, interpret=True, **kw)
    sampler = get_cuda_ode_sampler(ts, tm, SHAPE, device="cpu", **kw)
    for call in range(2):
        z = np.random.default_rng(8 + call).normal(size=SHAPE).astype(np.float32)
        _, ref = jax_sampler(KEYS[0], z=jnp.asarray(z))
        nfe, out = sampler(z=torch.from_numpy(z))
        assert nfe == 80
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-3 * _scaled(ref))
        _, fresh = get_cuda_ode_sampler(ts, tm, SHAPE, device="cpu", **kw)(
            z=torch.from_numpy(z))
        assert torch.equal(out, fresh)


def test_likelihood_static_buffers_across_calls(pf_nets):
    """The kernel likelihood's loop on its static buffers, two calls with
    other data and probe, against the TPU kernel in interpret mode at
    test_torch_lik_handoff.py's bounds (3e-2 of the largest magnitude on z,
    0.1 bits/dim), and bit-equal to a freshly built likelihood: Delta-logp
    starts from zero at every call."""
    fm, params, tm, js, ts = pf_nets
    kw = dict(n_steps=25, eps=1e-4)
    jax_fn = get_pallas_likelihood_fn(js, fm, params, SHAPE, interpret=True, **kw)
    fn = get_cuda_likelihood_fn(ts, tm, SHAPE, device="cpu", **kw)
    for call in range(2):
        data = (0.5 * np.random.default_rng(1 + call).normal(size=SHAPE)).astype(np.float32)
        epsv = np.array(jax.random.rademacher(KEYS[call], SHAPE, jnp.float32))
        bpd_ref, z_ref, _ = jax_fn(KEYS[call], jnp.asarray(data))
        args = (None, torch.from_numpy(data))
        bpd, z, nfe = fn(*args, epsilon=torch.from_numpy(epsv))
        assert nfe == 100
        np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=3e-2 * _scaled(z_ref))
        np.testing.assert_allclose(bpd.numpy(), np.asarray(bpd_ref), atol=0.1)
        bpd_f, z_f, _ = get_cuda_likelihood_fn(ts, tm, SHAPE, device="cpu", **kw)(
            *args, epsilon=torch.from_numpy(epsv))
        assert torch.equal(z, z_f) and torch.equal(bpd, bpd_f)


def test_consecutive_calls_return_distinct_tensors():
    """A call returns fresh tensors: a later call neither overwrites nor
    aliases an earlier result (callers keep them)."""
    _, _, tm = flax_and_torch(**SMALL)
    sampler = get_cuda_em_sampler(tsde.SubVPSDE(N=20), tm, SHAPE, device="cpu")
    a = sampler(torch.Generator().manual_seed(1))
    kept = a.clone()
    b = sampler(torch.Generator().manual_seed(2))
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, kept) and not torch.equal(a, b)
    hypo = get_cuda_em_hypo_sampler(tsde.SubVPSDE(N=20), tm, (2, 63), 4, device="cpu")
    assert hypo.loops == hypo.loops[:1] and not hypo.loops[0].graph


# ---------------------------------------------------------------------------
# the seed tensor, the replay accounting, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 61 + 12345, 2 ** 63 + 5, 2 ** 64 - 1])
def test_seed_tensor_keys_the_same_stream(seed):
    """The kernels read their seed as a one-element int64 tensor (its 64
    bits: seeds at and above 2**63 are negative there); the plain Philox
    stream keyed by that tensor is the stream keyed by the int."""
    t = fused_em.seed_tensor(seed, torch.device("cpu"))
    assert t.dtype == torch.int64 and tuple(t.shape) == (1,)
    assert philox.seed_bits(t) == seed
    for per_group in (False, True):
        want = philox.normals_grid(seed, 3, 1, 5, 63, per_group=per_group)
        got = philox.normals_grid(t, 3, 1, 5, 63, per_group=per_group)
        assert torch.equal(got, want)
    assert fused_em.seed_tensor(t, torch.device("cpu")) is t
    with pytest.raises(TypeError):
        fused_em.seed_tensor(t.int(), torch.device("cpu"))


class _Stand:
    """Stands in for a CUDA stream or event: waits are no-ops."""

    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay counts itself. The
    test's body counts launches only where a real capture records them."""

    def __init__(self, keep_graph=False):
        self.replays = 0
        self.keep_graph, self.instantiated = keep_graph, False

    def instantiate(self):
        self.instantiated = True

    def replay(self):
        assert self.instantiated or not self.keep_graph
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """Replace the CUDA calls of ``GraphLoop``'s capture by stand-ins, so its
    accounting runs on the CPU. ``state["capturing"]`` is True inside the
    stand-in of ``torch.cuda.graph``."""
    state = dict(capturing=False, graphs=[])

    @contextlib.contextmanager
    def graph(g):
        state["capturing"] = True
        state["graphs"].append(g)
        try:
            yield
        finally:
            state["capturing"] = False

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _Stand())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _Stand())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    return state


def test_replay_accounting_adds_the_captured_counts_per_replay(fake_cuda):
    """The warm-up (with the throwaway seed, the caller's seed restored after
    it) and the capture count nothing; every replay adds what the capture
    recorded, launches, routes and programmatic launches; the outputs are
    fresh clones."""
    seeds_seen = []
    out = torch.zeros(3)
    inputs = dict(z=torch.zeros(3), seed=torch.zeros(1, dtype=torch.int64))

    def body(warm_up=False):
        seeds_seen.append((int(inputs["seed"]), warm_up))
        out.copy_(inputs["z"] * 2)
        fused_em.head_em.launches += 3
        fused_em.head_em.programmatic += 3
        score_net.dense_gn_silu.launches += 5
        score_net.dense_gn_silu_jvp.routes["wgmma"] += 4
        return out

    runner = graph_loop.GraphLoop(body, inputs, graph=True)
    reset_launch_counts()
    a = runner(dict(z=torch.ones(3), seed=torch.tensor([41])))
    # the warm-up (its few steps), then the capture (the whole loop)
    assert seeds_seen == [(graph_loop.THROWAWAY_SEED, True), (41, False)]
    assert int(inputs["seed"]) == 41
    assert fake_cuda["graphs"][0].replays == 1
    counts = launch_counts()
    assert (counts["head_em"], counts["dense_gn_silu"]) == (3, 5)
    assert route_counts()["dense_gn_silu_jvp"]["wgmma"] == 4
    assert fused_em.programmatic_counts()["head_em"] == 3
    assert runner.launches == dict(head_em=3, dense_gn_silu=5)
    assert runner.warmup_s >= 0 and runner.capture_s >= 0 and runner.instantiate_s >= 0
    b = runner(dict(z=torch.full((3,), 2.0), seed=torch.tensor([42])))
    c = runner(dict(z=torch.full((3,), 3.0), seed=torch.tensor([43])))
    assert len(seeds_seen) == 2 and fake_cuda["graphs"][0].replays == 3
    assert len(fake_cuda["graphs"]) == 1  # captured once
    counts = launch_counts()
    assert (counts["head_em"], counts["dense_gn_silu"]) == (9, 15)
    assert route_counts()["dense_gn_silu_jvp"]["wgmma"] == 12
    assert fused_em.programmatic_counts()["head_em"] == 9
    assert int(inputs["seed"]) == 43
    assert a.data_ptr() != b.data_ptr() != c.data_ptr() and a is not out
    with pytest.raises(ValueError):  # a replay cannot draw from a generator
        runner(dict(z=torch.ones(3)), generator=torch.Generator())
    with pytest.raises(ValueError):
        runner(dict(z=torch.ones(4)))
    reset_launch_counts()


def test_failed_capture_restores_the_counts(fake_cuda):
    def body(warm_up=False):
        fused_em.head_em.launches += 1
        if fake_cuda["capturing"]:
            raise RuntimeError("capture failed")
        return torch.zeros(1)

    reset_launch_counts()
    runner = graph_loop.GraphLoop(body, dict(z=torch.zeros(1)), graph=True)
    with pytest.raises(RuntimeError, match="capture failed"):
        runner(dict(z=torch.ones(1)))
    assert launch_counts()["head_em"] == 0


def test_graph_loop_needs_the_card_and_the_kernels():
    """``loop="graph"`` on a CPU device or with ``plain=True`` raises; the
    default there is the eager loop."""
    _, _, tm = flax_and_torch(**dict(SMALL, num_scales=1000))
    sde = tsde.SubVPSDE(N=500)
    makers = [
        lambda **kw: get_cuda_em_sampler(sde, tm, SHAPE, **kw),
        lambda **kw: get_cuda_comp_solver(sde, tm, SHAPE, 504, iterations=1,
                                          steps_per_iter=2, **kw),
        lambda **kw: get_cuda_ode_sampler(sde, tm, SHAPE, n_steps=2, **kw),
        lambda **kw: get_cuda_likelihood_fn(sde, tm, SHAPE, n_steps=2, **kw),
    ]
    for build in makers:
        assert [lp.graph for lp in build(device="cpu").loops] == [False]
        for kw in (dict(device="cpu", loop="graph"), dict(device="cpu", plain=True, loop="graph"),
                   dict(device="cpu", loop="replay")):
            with pytest.raises(ValueError):
                build(**kw)
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert graph_loop.resolve_loop(None, cuda, False) == "graph"
    assert graph_loop.resolve_loop(None, cuda, False, in_kernel_normals=False) == "eager"
    assert graph_loop.resolve_loop(None, cuda, True) == "eager"
    assert graph_loop.resolve_loop(None, cpu, False) == "eager"
    with pytest.raises(ValueError):
        graph_loop.resolve_loop("graph", cuda, True)
