"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
torch, numpy and the port only, so it runs where JAX is not installed:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from dposer_tpu_torch.diffusion import fast_sampler as tfs
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.ops.cuda import fused_comp, fused_em, fused_lik, fused_ode, score_net
from dposer_tpu_torch.ops.cuda.fused_comp import (comp_perturb, get_cuda_comp_solver,
                                                  head_adam)
from dposer_tpu_torch.ops.cuda.fused_em import (get_cuda_em_sampler, head_em,
                                                langevin_update, launch_counts,
                                                masked_renoise, reset_launch_counts)
from dposer_tpu_torch.ops.cuda.fused_lik import get_cuda_likelihood_fn, head_rk4_jvp
from dposer_tpu_torch.ops.cuda.fused_ode import get_cuda_ode_sampler, head_rk4
from dposer_tpu_torch.ops.cuda.score_net import (HEAD_COLS, dense_gn_silu,
                                                 dense_gn_silu_jvp)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _t(rng, shape, dev, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(dev)


@pytest.mark.parametrize("K", [63, 1024])
@pytest.mark.parametrize("with_residual", [False, True])
def test_dense_gn_silu(dev, K, with_residual):
    rng = np.random.default_rng(K)
    B, N = 500, 1024
    a = _t(rng, (B, K), dev)
    w = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16)
    tp, gamma, beta = (_t(rng, (N,), dev) for _ in range(3))
    res = _t(rng, (B, N), dev) if with_residual else None
    want = score_net.dense_gn_silu_plain(a, w, tp, gamma, beta, res)
    reset_launch_counts()
    out = dense_gn_silu(a, w, tp, gamma, beta, residual=res)
    torch.cuda.synchronize()
    assert launch_counts()["dense_gn_silu"] == 1
    # same bf16 operands, fp32 sums in another order: rounding only
    torch.testing.assert_close(out, want, rtol=0, atol=1e-3)


def _head(dev, B=500, H=1024, D=63, seed=0):
    rng = np.random.default_rng(seed)
    h = _t(rng, (B, H), dev)
    w_post = torch.zeros(H, HEAD_COLS, device=dev)
    w_post[:, :D] = _t(rng, (H, D), dev, H ** -0.5)
    b_post = torch.zeros(HEAD_COLS, device=dev)
    b_post[:D] = _t(rng, (D,), dev)
    coefs = torch.from_numpy(rng.uniform(0.1, 1.5, size=(4, fused_em.N_COEFS))
                             .astype(np.float32)).to(dev)
    return h, w_post.to(torch.bfloat16), b_post, coefs, _t(rng, (B, D), dev), _t(rng, (B, D), dev)


def test_head_em_host_noise(dev):
    h, w_post, b_post, coefs, x, z = _head(dev)
    x_new_ref, x_mean_ref = fused_em.head_em_plain(h, w_post, b_post, coefs, 2, "em",
                                                   63, x=x, noise=z)
    x_mean = torch.empty_like(x)
    head_em(h, w_post, b_post, coefs, 2, "em", x=x, x_mean=x_mean, noise=z)
    score, sq = torch.empty_like(x), torch.empty(x.shape[0], device=dev)
    head_em(h, w_post, b_post, coefs, 1, "score", score=score, score_sq=sq)
    torch.cuda.synchronize()
    torch.testing.assert_close(x_mean, x_mean_ref, rtol=0, atol=1e-3)
    torch.testing.assert_close(x, x_new_ref, rtol=0, atol=1e-3)
    s_ref, sq_ref = fused_em.head_em_plain(h, w_post, b_post, coefs, 1, "score", 63)
    torch.testing.assert_close(score, s_ref, rtol=0, atol=1e-3)
    torch.testing.assert_close(sq, sq_ref, rtol=1e-4, atol=1e-3)


def test_in_kernel_normals_are_standard(dev):
    """The Philox + Box-Muller draw: recover z from the EM update."""
    h, w_post, b_post, coefs, x, _ = _head(dev)
    coefs[:, 2] = 1.0
    x_mean = torch.empty_like(x)
    zs = []
    for step in range(4):
        xs = x.clone()
        head_em(h, w_post, b_post, coefs, step, "em", x=xs, x_mean=x_mean, seed=1234)
        zs.append(xs - x_mean)
    z = torch.stack(zs)
    assert z.numel() >= 1e5
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    assert float((zs[0] - zs[1]).abs().min()) > 0  # steps draw different streams


@pytest.mark.parametrize("B", [500, 1000])
def test_langevin_update(dev, B):
    rng = np.random.default_rng(5)
    x, score, z = (_t(rng, (B, 63), dev) for _ in range(3))
    coefs = torch.rand(3, fused_em.N_COEFS, device=dev)
    sq = (score * score).sum(1)
    want, st_ref = fused_em.langevin_update_plain(x, score, sq, coefs, 1, 0.16, z)
    st = torch.empty(1, device=dev)
    langevin_update(x, score, sq, coefs, 1, 0.16, noise=z, step_out=st)
    torch.cuda.synchronize()
    torch.testing.assert_close(st[0], st_ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(x, want, rtol=0, atol=1e-4)


def test_kernel_sampler_matches_fp32_sampler(dev):
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=256, embed_dim=64,
                         n_blocks=2, dropout=0.0).eval().to(dev)
    n, shape = 20, (40, 63)
    rng = np.random.default_rng(7)
    z, noise = _t(rng, shape, dev), _t(rng, (n, 2) + shape, dev)
    for corrector, nz in (("none", noise[:, 1:].contiguous()), ("langevin", noise)):
        ref = tfs.get_fast_pc_sampler(tsde.SubVPSDE(N=n), model, shape,
                                      corrector=corrector, device=dev)(z=z, noise=nz)
        reset_launch_counts()
        out = get_cuda_em_sampler(tsde.SubVPSDE(N=n), model, shape, corrector=corrector,
                                  device="cuda")(z=z, noise=nz)
        counts = launch_counts()
        assert counts["dense_gn_silu"] == n * 5 * (2 if corrector == "langevin" else 1)
        assert counts["langevin_update"] == (n if corrector == "langevin" else 0)
        scale = max(1.0, float(ref.abs().max()))
        torch.testing.assert_close(out, ref, rtol=0, atol=2e-2 * scale)


def _masked(dev, B=1000, D=63, seed=8):
    rng = np.random.default_rng(seed)
    x, obs, z = (_t(rng, (B, D), dev) for _ in range(3))
    mask = torch.ones(B, D, device=dev)
    mask[:, 0:12] = 0.0
    coefs = torch.from_numpy(rng.uniform(0.1, 1.5, size=(4, fused_em.N_COEFS))
                             .astype(np.float32)).to(dev)
    return x, obs, mask, z, coefs


def test_masked_renoise(dev):
    x, obs, mask, z, coefs = _masked(dev)
    want = fused_em.masked_renoise_plain(x, obs, mask, coefs, 2, z)
    reset_launch_counts()
    masked_renoise(x, obs, mask, coefs, 2, noise=z)
    torch.cuda.synchronize()
    assert launch_counts()["masked_renoise"] == 1
    torch.testing.assert_close(x, want, rtol=0, atol=1e-4)
    # in-kernel normals: with mean coefficient 0 and std 1 the observed dims are the draw
    coefs[:, 5], coefs[:, 6] = 0.0, 1.0
    draws = []
    for step in range(3):
        xs = torch.zeros_like(x)
        masked_renoise(xs, obs, torch.ones_like(mask), coefs, step, seed=77, slab=2)
        draws.append(xs)
    zk = torch.stack(draws)
    assert zk.numel() >= 1e5
    assert abs(float(zk.mean())) < 0.01 and abs(float(zk.std()) - 1.0) < 0.01
    assert float((draws[0] - draws[1]).abs().min()) > 0


def test_comp_perturb(dev):
    x, _, _, z, coefs = _masked(dev, seed=9)
    pert = torch.empty_like(x)
    reset_launch_counts()
    comp_perturb(x, pert, coefs, 1, noise=z)
    torch.cuda.synchronize()
    assert launch_counts()["comp_perturb"] == 1
    torch.testing.assert_close(pert, fused_comp.comp_perturb_plain(x, coefs, 1, z),
                               rtol=0, atol=1e-4)
    coefs[:, 0], coefs[:, 1] = 0.0, 1.0
    draws = []
    for step in range(3):
        comp_perturb(x, pert, coefs, step, seed=5)
        draws.append(pert.clone())
    zk = torch.stack(draws)
    assert abs(float(zk.mean())) < 0.01 and abs(float(zk.std()) - 1.0) < 0.01


@pytest.mark.parametrize("paste", [False, True])
def test_head_adam(dev, paste):
    h, w_post, b_post, coefs, x, pert = _head(dev, B=1000, seed=10)
    rng = np.random.default_rng(10)
    obs = _t(rng, x.shape, dev)
    mask = (torch.rand(x.shape, device=dev) < 0.5).float()
    m1, v = _t(rng, x.shape, dev, 0.1), _t(rng, x.shape, dev, 0.01).abs()
    want = fused_comp.head_adam_plain(h, w_post, b_post, coefs, 2, x, pert, obs, mask,
                                      m1, v, paste)
    reset_launch_counts()
    head_adam(h, w_post, b_post, coefs, 2, x, pert, obs, mask, m1, v, paste)
    torch.cuda.synchronize()
    assert launch_counts()["head_adam"] == 1
    # each output to a thousandth of its own range: the moments are far below 1
    floors = (1.0, 0.0, 0.0)
    for got, ref, floor in zip((x, m1, v), want, floors):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-3 * max(floor, float(ref.abs().max())))
    if paste:
        assert torch.equal(x * mask, obs * mask)


def _small_model(dev, **kw):
    torch.manual_seed(0)
    return ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=256, embed_dim=64,
                        n_blocks=2, dropout=0.0, **kw).eval().to(dev)


def test_kernel_solver_matches_plain_loop(dev):
    model = _small_model(dev)
    rows, steps = 70, 16  # no multiple of K1's or K6's row tile
    rng = np.random.default_rng(11)
    obs, noise = _t(rng, (rows, 63), dev, 0.3), _t(rng, (steps, rows, 63), dev)
    mask = torch.ones(rows, 63, device=dev)
    mask[:, 0:12] = 0.0
    kw = dict(iterations=2, steps_per_iter=8, device="cuda")
    sde = tsde.SubVPSDE(N=1000)
    ref = get_cuda_comp_solver(sde, model, (rows, 63), rows * 63, plain=True, **kw)(
        None, obs, mask, noise=noise)
    reset_launch_counts()
    out = get_cuda_comp_solver(sde, model, (rows, 63), rows * 63, **kw)(
        None, obs, mask, noise=noise)
    counts = launch_counts()
    assert (counts["comp_perturb"], counts["dense_gn_silu"], counts["head_adam"]) == \
        (steps, 5 * steps, steps)
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-3 * max(1.0, float(ref.abs().max())))
    assert torch.equal(out * mask, obs * mask)
    g = torch.Generator(device=dev).manual_seed(1)
    a = get_cuda_comp_solver(sde, model, (rows, 63), rows * 63, rng_mode="kernel", **kw)(
        g, obs, mask)
    assert torch.isfinite(a).all() and torch.equal(a * mask, obs * mask)


def test_imputation_sampler_steps_match_plain(dev):
    """Step by step from the plain trajectory's state, corrector none and
    langevin, and the launch counts of one imputation step."""
    model = _small_model(dev)
    n, shape = 20, (70, 63)
    rng = np.random.default_rng(12)
    z, noise = _t(rng, shape, dev), _t(rng, (n, 4) + shape, dev)
    obs = _t(rng, shape, dev, 0.3)
    mask = torch.zeros(shape, device=dev)
    mask[:, 12:] = 1.0
    sde = tsde.SubVPSDE(N=n)
    net, coefs = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", dev)
    for n_corr, nz in ((0, noise[:, 1:].contiguous()), (1, noise)):
        sk, sp = (fused_em.pc_scratch(net, shape[0], n_corr, dev) for _ in range(2))
        xp = z.clone()
        reset_launch_counts()
        for i in range(n):
            xk = xp.clone()
            kw = dict(n_corr=n_corr, snr=0.16, observed=(obs, mask))
            fused_em.pc_step(net, coefs, i, xk, sk, nz[i], **kw)
            fused_em.pc_step(net, coefs, i, xp, sp, nz[i], plain=True, **kw)
            torch.testing.assert_close(xk, xp, rtol=0,
                                       atol=2e-2 * max(1.0, float(xp.abs().max())))
            # the observed dims went through no network
            torch.testing.assert_close(xk * mask, xp * mask, rtol=0, atol=1e-5)
        counts = launch_counts()
        assert counts["masked_renoise"] == 2 * n
        assert counts["dense_gn_silu"] == 5 * n * (1 + n_corr)


def test_step_range_split_draws_the_full_runs_normals(dev):
    """In-kernel normals are keyed by the grid's own step index: head then
    tail under one seed is the full run, bit for bit."""
    model = _small_model(dev)
    n, cut, shape = 20, 13, (40, 63)
    rng = np.random.default_rng(13)
    z, obs = _t(rng, shape, dev), _t(rng, shape, dev, 0.3)
    mask = torch.zeros(shape, device=dev)
    mask[:, 12:] = 1.0
    sde = tsde.SubVPSDE(N=n)
    kw = dict(corrector="langevin", imputation=True, rng_mode="kernel", device="cuda")
    io = dict(observation=obs, mask=mask)

    def gen():
        return torch.Generator(device=dev).manual_seed(3)

    full = get_cuda_em_sampler(sde, model, shape, **kw)(gen(), z=z, **io)
    x = get_cuda_em_sampler(sde, model, shape, denoise=False, step_range=(0, cut), **kw)(
        gen(), z=z, **io)
    split = get_cuda_em_sampler(sde, model, shape, step_range=(cut, n), **kw)(gen(), z=x, **io)
    assert torch.equal(split, full)


@pytest.mark.parametrize("B", [50, 70])
@pytest.mark.parametrize("K", [63, 1024])
@pytest.mark.parametrize("with_residual", [False, True])
def test_dense_gn_silu_jvp(dev, B, K, with_residual):
    rng = np.random.default_rng(K + B)
    N = 1024
    a, da = _t(rng, (B, K), dev), _t(rng, (B, K), dev)
    w = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16)
    tp, gamma, beta = (_t(rng, (N,), dev) for _ in range(3))
    res = (_t(rng, (B, N), dev), _t(rng, (B, N), dev)) if with_residual else (None, None)
    want = score_net.dense_gn_silu_jvp_plain(a, da, w, tp, gamma, beta, *res)
    reset_launch_counts()
    out, dout = dense_gn_silu_jvp(a, da, w, tp, gamma, beta, residual=res[0],
                                  dresidual=res[1])
    torch.cuda.synchronize()
    assert launch_counts()["dense_gn_silu_jvp"] == 1
    # same bf16 operands, fp32 sums in another order: rounding only; the
    # tangent passes through 1/std of the group, so it scales with its own range
    torch.testing.assert_close(out, want[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(dout, want[1], rtol=0,
                               atol=1e-3 * max(1.0, float(want[1].abs().max())))
    if with_residual:  # in place, as the block's second layer runs it
        dense_gn_silu_jvp(a, da, w, tp, gamma, beta, residual=res[0], dresidual=res[1],
                          out=res[0], dout=res[1])
        torch.cuda.synchronize()
        torch.testing.assert_close(res[0], out, rtol=0, atol=0)
        torch.testing.assert_close(res[1], dout, rtol=0, atol=0)


def _rk4_state(dev, B, seed, D=63):
    rng = np.random.default_rng(seed)
    h, w_post, b_post, _, x, xs = _head(dev, B=B, seed=seed)
    coefs = torch.from_numpy(rng.uniform(-1.0, 1.0, size=(7, fused_ode.N_COEFS))
                             .astype(np.float32)).to(dev)
    return h, w_post, b_post, coefs, x, xs, _t(rng, (B, D), dev)


@pytest.mark.parametrize("stage", [0, 1, 2, 3, fused_ode.DENOISE])
def test_head_rk4(dev, stage):
    h, w_post, b_post, coefs, x, xs, acc = _rk4_state(dev, 500, 20 + stage)
    want = fused_ode.head_rk4_plain(h, w_post, b_post, coefs, 5, stage, x, xs, acc)
    reset_launch_counts()
    head_rk4(h, w_post, b_post, coefs, 5, stage, x, xs, acc)
    torch.cuda.synchronize()
    assert launch_counts()["head_rk4"] == 1
    for got, ref in zip((x, xs, acc), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 * max(1.0, float(ref.abs().max())))


@pytest.mark.parametrize("B", [50, 70])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_head_rk4_jvp(dev, B, stage):
    h, w_post, b_post, coefs, x, xs, acc = _rk4_state(dev, B, 30 + stage)
    rng = np.random.default_rng(40 + stage)
    dh = _t(rng, h.shape, dev)
    eps = torch.sign(_t(rng, x.shape, dev))
    lp, lacc = _t(rng, (B,), dev), _t(rng, (B,), dev)
    want = fused_lik.head_rk4_jvp_plain(h, dh, w_post, b_post, coefs, 5, stage, x, xs, acc,
                                        eps, lp, lacc)
    reset_launch_counts()
    head_rk4_jvp(h, dh, w_post, b_post, coefs, 5, stage, x, xs, acc, eps, lp, lacc)
    torch.cuda.synchronize()
    assert launch_counts()["head_rk4_jvp"] == 1
    for got, ref in zip((x, xs, acc, lp, lacc), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 * max(1.0, float(ref.abs().max())))


@pytest.mark.parametrize("denoise", [False, True])
def test_kernel_ode_sampler_matches_plain_loop(dev, denoise):
    model = _small_model(dev)
    shape, n = (70, 63), 10
    z = _t(np.random.default_rng(50), shape, dev)
    sde = tsde.SubVPSDE(N=1000)
    kw = dict(n_steps=n, eps=1e-3, denoise=denoise, device="cuda")
    nfe, ref = get_cuda_ode_sampler(sde, model, shape, plain=True, **kw)(z=z)
    reset_launch_counts()
    nfe_k, out = get_cuda_ode_sampler(sde, model, shape, **kw)(z=z)
    counts = launch_counts()
    extra = 1 if denoise else 0
    assert nfe == nfe_k == 4 * n
    assert (counts["dense_gn_silu"], counts["head_rk4"]) == (5 * (4 * n + extra), 4 * n + extra)
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-3 * max(1.0, float(ref.abs().max())))


def test_kernel_likelihood_matches_plain_loop(dev):
    # without the sigma output scaling the untrained field stays tame (bits/dim
    # near 10, not 500), so the absolute limits of the CPU tests apply
    model = _small_model(dev, scale_by_sigma=False)
    shape, n = (70, 63), 10
    rng = np.random.default_rng(51)
    data, eps = _t(rng, shape, dev, 0.5), torch.sign(_t(rng, shape, dev))
    sde = tsde.SubVPSDE(N=1000)
    kw = dict(n_steps=n, eps=1e-3, device="cuda")
    bpd_ref, z_ref, _ = get_cuda_likelihood_fn(sde, model, shape, plain=True, **kw)(
        None, data, epsilon=eps)
    reset_launch_counts()
    bpd, z, nfe = get_cuda_likelihood_fn(sde, model, shape, **kw)(None, data, epsilon=eps)
    counts = launch_counts()
    assert nfe == 4 * n
    assert (counts["dense_gn_silu_jvp"], counts["head_rk4_jvp"]) == (20 * n, 4 * n)
    torch.testing.assert_close(z, z_ref, rtol=0, atol=3e-2 * max(1.0, float(z_ref.abs().max())))
    torch.testing.assert_close(bpd, bpd_ref, rtol=0, atol=0.1)
    g = torch.Generator(device=dev).manual_seed(2)
    drawn = get_cuda_likelihood_fn(sde, model, shape, **kw)(g, data)[0]
    assert torch.isfinite(drawn).all()


def test_pf_euler_kernel_decode_matches_plain_loop(dev):
    model = _small_model(dev)
    n, shape = 50, (70, 63)
    z = _t(np.random.default_rng(52), shape, dev)
    sde = tsde.SubVPSDE(N=n)
    ref = get_cuda_em_sampler(sde, model, shape, eps=1e-5, probability_flow=True,
                              device="cuda", plain=True)(z=z)
    reset_launch_counts()
    out = get_cuda_em_sampler(sde, model, shape, eps=1e-5, probability_flow=True,
                              rng_mode="kernel", device="cuda")(
        torch.Generator(device=dev).manual_seed(1), z=z)
    counts = launch_counts()
    assert (counts["dense_gn_silu"], counts["head_em"]) == (5 * n, n)
    # deterministic: the in-kernel normals meet a zero coefficient
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-3 * max(1.0, float(ref.abs().max())))
