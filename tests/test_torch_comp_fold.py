"""The completion solver's perturbation folded into K6's epilogue
(``head_adam_perturb``, the perturbing instantiation of ``csrc/head_adam.cu``)
and the kernel solver's loop order around it.

On the CPU the wrappers run the plain versions: the fused plain K6 is held
bit for bit to the sequence it replaces (K6 at the step, then K5 at the
next), the folded solver to the unfused ``plain=True`` loop on injected and
generator-drawn normals and to ``DPoserComp(backend="pallas",
interpret=True)`` on the same weights and noise, and its launches to one K5
a solve. The CUDA kernel is held to K6 -> K5 on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.tasks import DPoserComp as JaxDPoserComp
from dposer_tpu_torch.benchmarks import solver_wall
from dposer_tpu_torch.ops.cuda import fused_comp
from dposer_tpu_torch.ops.cuda.fused_comp import (comp_perturb_plain_into,
                                                  get_cuda_comp_solver, head_adam,
                                                  head_adam_perturb,
                                                  head_adam_perturb_plain_into,
                                                  head_adam_plain_into)
from dposer_tpu_torch.ops.cuda.fused_em import launch_counts, reset_launch_counts
from dposer_tpu_torch.ops.cuda.score_net import HEAD_COLS
from dposer_tpu_torch.tasks import DPoserComp

from test_torch_completion import B, DIM, ITERS, SPI, _close, _kw, setup  # noqa: F401

T = ITERS * SPI


def _adam_inputs(R, H, seed=31, n_steps=5):
    """K6's operands [R, H] and [R, 63] fp32 (w_post bf16), the step table
    [n_steps, 8], and the next step's host normals, from numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32))
    w_post = torch.zeros(H, HEAD_COLS)
    w_post[:, :DIM] = f(H, DIM, s=H ** -0.5)
    b_post = torch.zeros(HEAD_COLS)
    b_post[:DIM] = f(DIM)
    coefs = torch.from_numpy(rng.uniform(0.1, 1.5, size=(n_steps, 8)).astype(np.float32))
    x, pert, obs, zn = f(R, DIM), f(R, DIM), f(R, DIM), f(R, DIM)
    mask = torch.from_numpy((rng.random((R, DIM)) < 0.4).astype(np.float32))
    m1, v = f(R, DIM, s=0.1), f(R, DIM, s=0.01).abs()
    return (f(R, H), w_post.to(torch.bfloat16), b_post, coefs), (x, pert, obs, mask, m1, v), zn


@pytest.mark.parametrize("wrapper", ["plain", "head_adam_perturb", "head_adam"])
@pytest.mark.parametrize("H", [64, 1024])
@pytest.mark.parametrize("R", [1, 17, 1000])
def test_fold_equals_head_adam_then_comp_perturb(wrapper, H, R):
    """K6 at step 2 with step 3's perturbation, against plain K6 -> plain K5
    at step 3 on the same host normals: the same bits in x, m1, v and pert."""
    args, state, zn = _adam_inputs(R, H)
    step = 2
    got = [t.clone() for t in state]
    if wrapper == "plain":
        head_adam_perturb_plain_into(*args, step, *got, noise=zn)
    elif wrapper == "head_adam_perturb":
        head_adam_perturb(*args, step, *got, noise=zn)
    else:
        head_adam(*args, step, *got, perturb_next=dict(noise=zn, seed=None, slab=0))
    want = [t.clone() for t in state]
    head_adam_plain_into(*args, step, *want)
    comp_perturb_plain_into(want[0], want[1], args[3], step + 1, noise=zn)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[1], state[1])  # pert is the next step's now
    assert torch.equal(got[1], args[3][step + 1, 0] * got[0] + args[3][step + 1, 1] * zn)


@pytest.mark.parametrize("bad", ["last_step", "next_noise_shape", "both", "neither",
                                 "seed_on_cpu", "alias", "paste", "meta"])
def test_fold_wrapper_rejects_bad_operands(bad):
    args, state, zn = _adam_inputs(4, 64, seed=32)
    step, nz = 1, dict(noise=zn)
    state = list(state)
    if bad == "last_step":  # step + 1 must be a row of the table
        step = args[3].shape[0] - 1
    elif bad == "next_noise_shape":
        nz = dict(noise=zn[:3])
    elif bad == "both":
        nz = dict(noise=zn, seed=7)
    elif bad == "neither":
        nz = {}
    elif bad == "seed_on_cpu":  # in-kernel normals need the card
        nz = dict(seed=7)
    elif bad == "alias":  # the kernel reads x and pert
        state[1] = state[0]
    elif bad == "meta":
        args = tuple(t.to("meta") for t in args)
        state = [t.to("meta") for t in state]
        nz = dict(noise=zn.to("meta"))
    before = [t.clone() for t in state] if bad != "meta" else None
    reset_launch_counts()
    with pytest.raises(ValueError):
        if bad == "paste":  # the paste step perturbs no next step
            head_adam(*args, step, *state, True, perturb_next=nz)
        else:
            head_adam_perturb(*args, step, *state, **nz)
    assert launch_counts()["head_adam_perturb"] == 0
    if before is not None:  # nothing was written
        assert all(torch.equal(a, b) for a, b in zip(state, before))


def _solver(s, plain=False, rows=B, n_elems=B * DIM, time_strategy="3"):
    return get_cuda_comp_solver(s["ts"], s["tm"], (rows, DIM), n_elems, device="cpu",
                                plain=plain, **_kw(time_strategy))


@pytest.mark.parametrize("time_strategy", ["3", "2"])
@pytest.mark.parametrize("source", ["injected", "generator"])
@pytest.mark.parametrize("hypo", [1, 3])
def test_folded_solver_equals_plain_loop(setup, time_strategy, source, hypo):  # noqa: F811
    """The folded solver (through the wrappers on CPU tensors) against the
    unfused plain loop, K5 then K6 every step: the same bits, on injected
    noise and on a generator's draws (drawn one step early, in step order),
    with hypotheses as extra rows."""
    s = setup
    rows = hypo * B
    obs = torch.from_numpy(s["obs"]).repeat(hypo, 1)
    mask = torch.from_numpy(s["mask"]).repeat(hypo, 1)
    kw = dict(rows=rows, time_strategy=time_strategy)
    fold, plain = _solver(s, **kw), _solver(s, plain=True, **kw)
    if source == "injected":
        noise = torch.from_numpy(np.random.default_rng(33).normal(size=(T, rows, DIM))
                                 .astype(np.float32))
        got, want = fold(None, obs, mask, noise=noise), plain(None, obs, mask, noise=noise)
    else:
        got = fold(torch.Generator().manual_seed(34), obs, mask)
        want = plain(torch.Generator().manual_seed(34), obs, mask)
        g = torch.Generator().manual_seed(34)  # one torch.randn a step, in step order
        noise = torch.stack([torch.randn((rows, DIM), generator=g) for _ in range(T)])
        assert torch.equal(got, fold(None, obs, mask, noise=noise))
    assert torch.equal(got, want)
    assert torch.equal(got * mask, obs * mask)
    assert float((got - obs).abs().max()) > 1e-3  # it moved


def _counting(monkeypatch, names):
    """Replace ``fused_comp``'s ``names`` by wrappers that record the
    arguments of each call and then run the original."""
    calls = {n: [] for n in names}

    def wrap(name):
        fn = getattr(fused_comp, name)

        def wrapped(*a, **kw):
            calls[name].append((a, kw))
            return fn(*a, **kw)
        return wrapped

    for n in names:
        monkeypatch.setattr(fused_comp, n, wrap(n))
    return calls


def test_folded_solver_matches_pallas_interpret(setup, monkeypatch):  # noqa: F811
    """The folded solver on CPU tensors against the TPU kernel in interpret
    mode at test_kernel_solver_matches_pallas_interpret's bound, with the
    observed dims pasted exactly; and it did fold: K5 at step 0 only, K6's
    perturbing instantiation at steps 0 .. T - 2, the paste at T - 1."""
    s = setup
    noise = np.random.default_rng(7).normal(size=(T, B, DIM)).astype(np.float32)
    pal = JaxDPoserComp(s["js"], s["jscore"], backend="pallas", model=s["fm"],
                        params=s["params"], interpret=True, **_kw("3"))
    ref = np.asarray(pal.optimize(jax.random.PRNGKey(3), jnp.asarray(s["obs"]),
                                  jnp.asarray(s["mask"]), noise=jnp.asarray(noise)))
    calls = _counting(monkeypatch, ("comp_perturb", "head_adam", "head_adam_perturb"))
    out = DPoserComp(s["ts"], model=s["tm"], backend="cuda", device="cpu", **_kw("3")).optimize(
        torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"]), noise=torch.from_numpy(noise))
    _close(out, ref, 5e-3)
    np.testing.assert_array_equal(out.numpy() * s["mask"], s["obs"] * s["mask"])
    assert [a[3] for a, _ in calls["comp_perturb"]] == [0]
    assert [a[4] for a, _ in calls["head_adam_perturb"]] == list(range(T - 1))
    assert [(a[4], a[11]) for a, _ in calls["head_adam"]] == [(T - 1, True)]
    # each fold gets the next step's injected slab
    for i, (_, kw) in enumerate(calls["head_adam_perturb"]):
        assert np.array_equal(kw["noise"].numpy(), noise[i + 1]) and kw["seed"] is None


@pytest.mark.parametrize("plain", [False, True])
def test_solver_launches_k5_once_a_solve(setup, monkeypatch, plain):  # noqa: F811
    """Mock-counted, a 2x8-step solve: K5 1, K6's perturbing instantiation
    T - 1, K6 with the paste 1, K1 5T; ``plain=True`` keeps the unfused loop
    (K5 and K6 every step)."""
    s = setup
    names = ("comp_perturb", "head_adam", "head_adam_perturb", "dense_gn_silu",
             "comp_perturb_plain_into", "head_adam_plain_into",
             "head_adam_perturb_plain_into", "dense_gn_silu_plain_into")
    calls = _counting(monkeypatch, names)
    noise = torch.zeros(T, B, DIM)
    _solver(s, plain=plain)(None, torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"]),
                            noise=noise)
    n = {k: len(v) for k, v in calls.items()}
    if plain:
        assert (n["comp_perturb_plain_into"], n["dense_gn_silu_plain_into"],
                n["head_adam_perturb_plain_into"], n["head_adam_plain_into"]) == (T, 5 * T, 0, T)
        assert n["comp_perturb"] == n["head_adam"] == n["head_adam_perturb"] == 0
    else:
        assert (n["comp_perturb"], n["dense_gn_silu"], n["head_adam_perturb"],
                n["head_adam"]) == (1, 5 * T, T - 1, 1)
        assert [(a[4], a[11]) for a, _ in calls["head_adam"]] == [(T - 1, True)]
        assert [a[3] for a, _ in calls["comp_perturb"]] == [0]


def test_adam_step_with_in_kernel_normals_hands_k6_the_seed(setup, monkeypatch):  # noqa: F811
    """Mock-recorded, in-kernel normals (seed=): no host slab exists, so K5
    (first step only) and K6's perturbing instantiation get the seed, and
    the paste step gets none of it."""
    s = setup
    net, coefs = fused_comp.build_solver_operands(s["ts"], s["tm"], B * DIM, 0.1, 1, 3, "3",
                                                  5.0, 900, 1e-3, "cpu")
    calls = []
    monkeypatch.setattr(fused_comp, "comp_perturb",
                        lambda *a, **kw: calls.append(("K5", a[3], kw["seed"])))
    monkeypatch.setattr(fused_comp, "head_adam_perturb", lambda *a, **kw: calls.append(
        ("K6+K5", a[4], kw["seed"], kw["noise"])))
    monkeypatch.setattr(fused_comp, "head_adam",
                        lambda *a, **kw: calls.append(("K6", a[4], a[11])))
    monkeypatch.setattr(fused_comp, "network_hidden", lambda *a, **kw: None)
    x = torch.zeros(B, DIM)
    scratch = fused_comp.solver_scratch(net, B, "cpu")
    for i in range(3):
        fused_comp.adam_step(net, coefs, i, x, x, x, x, x, scratch, None, seed=5,
                             paste=i == 2, perturbed=i > 0, perturb_next=i < 2)
    assert calls == [("K5", 0, 5), ("K6+K5", 0, 5, None), ("K6+K5", 1, 5, None),
                     ("K6", 2, True)]
    with pytest.raises(ValueError):  # the paste step perturbs no next step
        fused_comp.adam_step(net, coefs, 2, x, x, x, x, x, scratch, None, seed=5, paste=True,
                             perturb_next=True)


def test_solver_wall_arguments_and_tiny_run(capsys):
    """``benchmarks/solver_wall.py``: its defaults are the 5c solve (100
    poses x 10 hypotheses, 2x100 steps) and its size options apply, in a
    tiny run of the kernels' plain versions on the CPU."""
    a = solver_wall.parse_args([])
    assert (a.calls, a.poses, a.hypo, a.iterations, a.steps_per_iter, a.device) == \
        (5, 100, 10, 2, 100, "cuda")
    assert a.ckpt_path.endswith("axis-zscore-400k-synth.pth")
    res = solver_wall.main(["--device", "cpu", "--calls", "2", "--poses", "2", "--hypo", "3",
                            "--iterations", "1", "--steps-per-iter", "2"])
    assert (res["rows"], res["steps"], len(res["walls_ms"])) == (6, 2, 2)
    assert res["launches"] == {}  # CPU tensors: the plain versions, no launch
    assert res["best_ms"] <= res["median_ms"]
    out = capsys.readouterr().out
    assert out.count("[solver_wall] call") == 3 and '"walls_ms"' in out
