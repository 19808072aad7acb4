"""The port's pose-completion slice against the JAX package on the same
weights, inputs and injected noise (CPU; hidden 128, embed 64, 2 blocks,
6 rows): masks, the time strategies, the DPoser prior loss, the autograd
solver against the JAX XLA solver, and the kernel solver's path (the plain
versions of K5, K1 and K6 on CPU tensors) against the JAX Pallas solver in
interpret mode."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.body_model.part_indices import BodyPartIndices as JaxParts
from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.diffusion.score_fn import get_score_fn as jax_get_score_fn
from dposer_tpu.tasks import DPoserComp as JaxDPoserComp
from dposer_tpu.tasks.prior import DPoserPrior as JaxDPoserPrior
from dposer_tpu.tasks.prior import multi_step_denoise as jax_multi_step_denoise
from dposer_tpu.tasks.prior import sample_quan_t as jax_sample_quan_t
from dposer_tpu.utils.masks import create_mask as jax_create_mask
from dposer_tpu.utils.masks import part_mask_indices as jax_part_mask_indices
from dposer_tpu_torch.body_model.part_indices import BodyPartIndices
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.score_fn import get_score_fn
from dposer_tpu_torch.ops.cuda.fused_comp import get_cuda_comp_solver
from dposer_tpu_torch.ops.cuda.fused_em import launch_counts, reset_launch_counts
from dposer_tpu_torch.tasks import DPoserComp, DPoserPrior
from dposer_tpu_torch.tasks.prior import multi_step_denoise, sample_quan_t
from dposer_tpu_torch.utils.masks import create_mask, part_mask_indices

from test_torch_model import SMALL, flax_and_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, DIM = 6, 63
ITERS, SPI = 2, 8  # 2x8 Adam steps keep the interpret-mode run short


@pytest.fixture(scope="module")
def setup():
    """N = 500 under num_scales 1000, as tests/test_pallas_comp.py: strategy
    '3' then stays inside the sigma ladder."""
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True, num_scales=1000))
    js, ts = jsde.SubVPSDE(N=500), tsde.SubVPSDE(N=500)
    jscore = jax_get_score_fn(js, lambda x, t: fm.apply({"params": params}, x, t),
                              continuous=True)
    rng = np.random.default_rng(1)
    obs = (0.3 * rng.normal(size=(B, DIM))).astype(np.float32)
    mask = np.zeros((B, DIM), np.float32)
    mask[:, 39:45] = 1.0
    return dict(fm=fm, params=params, tm=tm, js=js, ts=ts, jscore=jscore, obs=obs, mask=mask)


def _close(out, ref, tol):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("part", JaxParts.PARTS)
def test_part_masks_match_jax(part):
    assert BodyPartIndices.PARTS == JaxParts.PARTS
    assert getattr(BodyPartIndices, part) == getattr(JaxParts, part)
    for rot_n in (3, 6):
        np.testing.assert_array_equal(part_mask_indices(part, rot_n),
                                      jax_part_mask_indices(part, rot_n))
    poses = np.random.default_rng(0).normal(size=(5, 63)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jmask, jobs = jax_create_mask(key, jnp.asarray(poses), part=part)
    n_idx = len(part_mask_indices(part, 3))
    fill = np.array(jax.random.normal(key, (5, n_idx), jnp.float32))  # the key's draw
    mask, obs = create_mask(torch.from_numpy(poses), part=part, fill=torch.from_numpy(fill))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    assert int((1 - mask[0]).sum()) == n_idx


def test_create_mask_draws_and_mean_fill():
    poses = torch.zeros(4, 63)
    m1, o1 = create_mask(poses, "legs", generator=torch.Generator().manual_seed(0))
    m2, o2 = create_mask(poses, "legs", generator=torch.Generator().manual_seed(0))
    assert torch.equal(o1, o2) and float(o1[m1 == 0].std()) > 0.5
    assert float((o1 * m1).abs().max()) == 0  # observed dims untouched
    mean = torch.arange(63.0)
    _, o3 = create_mask(poses, "hands", observation_type="mean", mean_observation=mean)
    idx = part_mask_indices("hands", 3)
    assert torch.equal(o3[:, idx], mean[idx].expand(4, len(idx)))
    with pytest.raises(ValueError):
        create_mask(torch.zeros(4, 60), "legs")


@pytest.mark.parametrize("time_strategy", ["2", "3"])
@pytest.mark.parametrize("total_steps,sde_n", [(200, 1000), (16, 500), (30, 77)])
def test_sample_quan_t_matches_jax(time_strategy, total_steps, sde_n):
    kw = dict(sample_trun=5.0, sample_time=min(900, sde_n - 1), offset=2)
    ref = [int(jax_sample_quan_t(jax.random.PRNGKey(0), jnp.int32(i), total_steps, sde_n,
                                 time_strategy, **kw)) for i in range(total_steps)]
    out = [sample_quan_t(i, total_steps, sde_n, time_strategy, **kw)
           for i in range(total_steps)]
    assert out == ref


def test_sample_quan_t_bounds_and_random():
    with pytest.raises(ValueError):
        sample_quan_t(0, 10, 500, "2", sample_time=900)
    with pytest.raises(NotImplementedError):
        sample_quan_t(0, 10, 500, "4")
    g = torch.Generator().manual_seed(0)
    draws = {sample_quan_t(0, 10, 500, "1", generator=g) for _ in range(50)}
    assert len(draws) > 10 and all(0 <= d < 500 for d in draws)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum_per_batch"])
def test_prior_loss_matches_jax(setup, weighted, reduction):
    """The loss and its gradient in x0 (the denoised estimate detached)."""
    s = setup
    rng = np.random.default_rng(2)
    x0 = (0.5 * rng.normal(size=(B, DIM))).astype(np.float32)
    z = rng.normal(size=(B, DIM)).astype(np.float32)
    t = rng.uniform(0.2, 0.9, size=(B,)).astype(np.float32)

    def jloss(x):
        return JaxDPoserPrior(s["js"], s["jscore"]).loss(
            jax.random.PRNGKey(0), x, jnp.asarray(t), weighted=weighted,
            reduction=reduction, z=jnp.asarray(z))

    ref, gref = jax.value_and_grad(jloss)(jnp.asarray(x0))
    prior = DPoserPrior(s["ts"], get_score_fn(s["ts"], s["tm"]), device="cpu")
    tx = torch.from_numpy(x0).requires_grad_(True)
    out = prior.loss(tx, torch.from_numpy(t), weighted=weighted, reduction=reduction,
                     z=torch.from_numpy(z))
    (g,) = torch.autograd.grad(out, tx)
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref), rtol=1e-4,
                               atol=1e-5 * float(np.abs(gref).max()))


def test_multi_step_denoise_and_red_diff_match_jax(setup):
    s = setup
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, DIM)).astype(np.float32)
    z = rng.normal(size=(B, DIM)).astype(np.float32)
    t = rng.uniform(0.3, 0.9, size=(B,)).astype(np.float32)
    ref, snr_ref = jax_multi_step_denoise(s["js"], s["jscore"], jnp.asarray(x), jnp.asarray(t),
                                          jnp.asarray(t / 20.0), N=10)
    out, snr = multi_step_denoise(s["ts"], get_score_fn(s["ts"], s["tm"]),
                                  torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(t / 20.0), N=10)
    _close(out, ref, 1e-4)
    np.testing.assert_allclose(snr.numpy(), np.asarray(snr_ref), rtol=1e-5)
    # red_diff_loss draws z from its key: inject the key's own draw
    key = jax.random.PRNGKey(9)
    zk = np.array(jax.random.normal(key, (B, DIM), jnp.float32))
    ref = JaxDPoserPrior(s["js"], s["jscore"]).red_diff_loss(key, jnp.asarray(x), jnp.asarray(t))
    out = DPoserPrior(s["ts"], get_score_fn(s["ts"], s["tm"]), device="cpu").red_diff_loss(
        torch.from_numpy(x), torch.from_numpy(t), z=torch.from_numpy(zk))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-4, atol=1e-6)


def _kw(time_strategy):
    kw = dict(iterations=ITERS, steps_per_iter=SPI, time_strategy=time_strategy)
    if time_strategy == "2":
        kw["sample_time"] = 400  # in range for N = 500
    return kw


@pytest.mark.parametrize("time_strategy", ["3", "2"])
def test_torch_solver_matches_jax_xla_solver(setup, time_strategy):
    s = setup
    noise = np.random.default_rng(7).normal(size=(ITERS * SPI, B, DIM)).astype(np.float32)
    ref = JaxDPoserComp(s["js"], s["jscore"], **_kw(time_strategy)).optimize(
        jax.random.PRNGKey(3), jnp.asarray(s["obs"]), jnp.asarray(s["mask"]),
        noise=jnp.asarray(noise))
    comp = DPoserComp(s["ts"], get_score_fn(s["ts"], s["tm"]), backend="torch",
                      device="cpu", **_kw(time_strategy))
    out = comp.optimize(torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"]),
                        noise=torch.from_numpy(noise))
    # fp32 both sides, 16 contractive Adam steps
    _close(out, ref, 1e-4)
    np.testing.assert_array_equal(out.numpy() * s["mask"], s["obs"] * s["mask"])


@pytest.mark.parametrize("time_strategy", ["3", "2"])
def test_kernel_solver_matches_pallas_interpret(setup, time_strategy):
    """The port's kernel path on CPU tensors (plain K5, K1, K6) against the
    TPU kernel in interpret mode, at the bound the JAX package holds its
    kernel to its XLA solver with (tests/test_pallas_comp.py)."""
    s = setup
    noise = np.random.default_rng(7).normal(size=(ITERS * SPI, B, DIM)).astype(np.float32)
    pal = JaxDPoserComp(s["js"], s["jscore"], backend="pallas", model=s["fm"],
                        params=s["params"], interpret=True, **_kw(time_strategy))
    ref = np.asarray(pal.optimize(jax.random.PRNGKey(3), jnp.asarray(s["obs"]),
                                  jnp.asarray(s["mask"]), noise=jnp.asarray(noise)))
    reset_launch_counts()
    comp = DPoserComp(s["ts"], model=s["tm"], backend="cuda", device="cpu",
                      **_kw(time_strategy))
    out = comp.optimize(torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"]),
                        noise=torch.from_numpy(noise))
    _close(out, ref, 5e-3)
    np.testing.assert_array_equal(out.numpy() * s["mask"], s["obs"] * s["mask"])
    assert sum(launch_counts().values()) == 0  # CPU tensors: the plain versions
    # and the port's own autograd solver, the semantic reference
    fp32 = DPoserComp(s["ts"], model=s["tm"], backend="torch", device="cpu",
                      **_kw(time_strategy)).optimize(
        torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"]), noise=torch.from_numpy(noise))
    _close(out, fp32, 5e-3)


def test_kernel_solver_tables_match_pallas_solver(setup):
    """The [T, 8] table, column by column, against the formulas of
    fused_comp.py:206-244 evaluated with the JAX SDE."""
    from dposer_tpu_torch.ops.cuda.fused_comp import build_solver_operands

    s = setup
    total, n_elems, lr = ITERS * SPI, B * DIM, 0.1
    _, coefs = build_solver_operands(s["ts"], s["tm"], n_elems, lr, ITERS, SPI, "3", 5.0,
                                     900, 1e-3, "cpu")
    js = s["js"]
    steps = np.arange(total)
    quan_t = np.array([int(jax_sample_quan_t(None, jnp.int32(i), total, js.N, "3"))
                       for i in steps])
    t = js.timesteps(1e-3)[quan_t]
    alpha, sigma = js.return_alpha_sigma(t)
    alpha = np.asarray(alpha).reshape(total)
    sigma = np.asarray(sigma)
    sig_ladder = np.asarray(s["tm"].sigmas.numpy())[np.asarray(t * 999).astype(np.int64)]
    score_scale = -1.0 / np.asarray(js.marginal_prob(jnp.zeros(total), t)[1]) / sig_ladder
    it = steps // SPI
    want = np.stack([np.asarray(js.marginal_prob(jnp.ones(total), t)[0]),
                     np.asarray(js.marginal_prob(jnp.zeros(total), t)[1]),
                     1.0 / alpha, sigma ** 2 * score_scale / alpha,
                     2.0 * (100.0 / (1.0 + it)) / n_elems,
                     0.1 * (it + 1.0) * np.sqrt(1.0 + alpha / sigma) / n_elems,
                     lr / (1.0 - 0.9 ** (steps + 1.0)),
                     1.0 / (1.0 - 0.999 ** (steps + 1.0))], axis=1)
    np.testing.assert_allclose(coefs.numpy(), want, rtol=2e-5)


def test_kernel_solver_hypos_are_rows(setup):
    """Hypothesis-flattened rows equal each hypothesis run alone: the
    per-hypothesis mean-loss divisor survives the flattening
    (tests/test_pallas_comp.py:64-81)."""
    s = setup
    obs, mask = torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"])
    noise1 = torch.from_numpy(np.random.default_rng(11).normal(size=(6, B, DIM))
                              .astype(np.float32))
    kw = dict(iterations=1, steps_per_iter=6, device="cpu")
    single = get_cuda_comp_solver(s["ts"], s["tm"], (B, DIM), B * DIM, **kw)(
        None, obs, mask, noise=noise1)
    flat = get_cuda_comp_solver(s["ts"], s["tm"], (2 * B, DIM), B * DIM, **kw)(
        None, obs.repeat(2, 1), mask.repeat(2, 1), noise=torch.cat([noise1, noise1], 1))
    torch.testing.assert_close(flat[:B], single, rtol=0, atol=1e-5)
    torch.testing.assert_close(flat[B:], single, rtol=0, atol=1e-5)
    wrong = get_cuda_comp_solver(s["ts"], s["tm"], (2 * B, DIM), 2 * B * DIM, **kw)(
        None, obs.repeat(2, 1), mask.repeat(2, 1), noise=torch.cat([noise1, noise1], 1))
    assert float((wrong[:B] - single).abs().max()) > 1e-4  # the divisor matters
    comp = DPoserComp(s["ts"], model=s["tm"], backend="cuda", iterations=1,
                      steps_per_iter=4, device="cpu")
    out = comp.optimize_hypos(obs, mask, 3, torch.Generator().manual_seed(0))
    assert out.shape == (B, 3, DIM)
    assert torch.equal(out * mask[:, None], (obs * mask)[:, None].expand(B, 3, DIM))
    assert float((out[:, 0] - out[:, 1]).abs().max()) > 1e-4


def test_torch_solver_hypos_and_random_strategy(setup):
    s = setup
    obs, mask = torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"])
    comp = DPoserComp(s["ts"], model=s["tm"], backend="torch", iterations=1,
                      steps_per_iter=3, time_strategy="1", device="cpu")
    a = comp.optimize_hypos(obs, mask, 2, torch.Generator().manual_seed(5))
    b = comp.optimize_hypos(obs, mask, 2, torch.Generator().manual_seed(5))
    assert a.shape == (B, 2, DIM) and torch.equal(a, b)
    assert torch.equal(a * mask[:, None], (obs * mask)[:, None].expand(B, 2, DIM))


@pytest.mark.parametrize("bad", ["strategy1", "discrete", "kernel_rng_cpu", "noise_shape",
                                 "no_model", "backend"])
def test_solver_guards(setup, bad):
    s = setup
    obs, mask = torch.from_numpy(s["obs"]), torch.from_numpy(s["mask"])
    kw = dict(iterations=1, steps_per_iter=2, device="cpu")
    if bad == "strategy1":
        with pytest.raises(NotImplementedError):
            DPoserComp(s["ts"], model=s["tm"], backend="cuda", time_strategy="1",
                       **kw).optimize(obs, mask)
    elif bad == "discrete":
        with pytest.raises(NotImplementedError):
            DPoserComp(s["ts"], model=s["tm"], backend="cuda", continuous=False,
                       **kw).optimize(obs, mask)
    elif bad == "kernel_rng_cpu":
        with pytest.raises(ValueError):
            get_cuda_comp_solver(s["ts"], s["tm"], (B, DIM), B * DIM, rng_mode="kernel", **kw)
    elif bad == "noise_shape":
        with pytest.raises(ValueError):
            get_cuda_comp_solver(s["ts"], s["tm"], (B, DIM), B * DIM, **kw)(
                None, obs, mask, noise=torch.zeros(3, B, DIM))
    elif bad == "no_model":
        with pytest.raises(ValueError):
            DPoserComp(s["ts"], get_score_fn(s["ts"], s["tm"]), backend="cuda", **kw)
    else:
        with pytest.raises(ValueError):
            DPoserComp(s["ts"], model=s["tm"], backend="pallas", **kw)


def test_port_sources_import_no_jax():
    """No file of the port, and not chip_smoke.py, imports jax,
    ml_collections, absl or anything of the JAX package."""
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|ml_collections|absl|"
                     r"dposer_tpu|configs|run)(?:\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "dposer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = {os.path.relpath(f, REPO): pat.findall(open(f).read()) for f in files}
    assert not {f: m for f, m in bad.items() if m}
