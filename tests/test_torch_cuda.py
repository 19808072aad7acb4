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


# ---------------------------------------------------------------------------
# K10-K12: the DSM train step's kernels (ops/cuda/fused_train.py)
# ---------------------------------------------------------------------------

def _bf16_close(got, want, rel=1e-2):
    """bf16 outputs: the kernel and the plain version round fp32 values that
    differ in their last bits, so an element may land one bf16 ulp apart."""
    got, want = got.float(), want.float()
    assert float((got - want).abs().max()) <= rel * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("K", [63, 1024])
@pytest.mark.parametrize("with_residual", [False, True])
def test_dense_gn_silu_train(dev, K, with_residual):
    from dposer_tpu_torch.ops.cuda import fused_train as ft

    rng = np.random.default_rng(K + 7)
    B, N = 1280, 1024
    a = _t(rng, (B, K), dev)
    w = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16)
    proj = _t(rng, (B, N), dev, 0.3).to(torch.bfloat16)
    gamma, beta = 1 + _t(rng, (N,), dev, 0.1), _t(rng, (N,), dev, 0.1)
    res = _t(rng, (B, N), dev) if with_residual else None
    want = ft.dense_gn_silu_train_plain(a, w, proj, gamma, beta, 99, 3, 0.9, res)
    reset_launch_counts()
    got = ft.dense_gn_silu_train(a, w, proj, gamma, beta, 99, 3, 0.9, residual=res)
    torch.cuda.synchronize()
    assert launch_counts()["dense_gn_silu_train"] == 1
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-3)  # the same mask
    _bf16_close(got[1], want[1])
    _bf16_close(got[2], want[2])
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=1e-5)


def test_head_dsm(dev):
    from dposer_tpu_torch.ops.cuda import fused_train as ft

    h, w_post, b_post, _, z, _ = _head(dev, B=1280)
    rng = np.random.default_rng(1)
    coefs = torch.from_numpy(np.stack([-rng.uniform(0.1, 2, 1280), rng.uniform(0.5, 2, 1280),
                                       np.full(1280, 1 / (63 * 1280))], 1)
                             .astype(np.float32)).to(dev)
    want = ft.head_dsm_plain(h, w_post, b_post, coefs, z)
    got = ft.head_dsm(h, w_post, b_post, coefs, z)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("K", [64, 1024])
@pytest.mark.parametrize("with_g_res", [False, True])
def test_dense_gn_silu_bwd(dev, K, with_g_res):
    from dposer_tpu_torch.ops.cuda import fused_train as ft

    rng = np.random.default_rng(K + 11)
    B, N = 1280, 1024
    dh_next = _t(rng, (B, K), dev, 1e-3).to(torch.bfloat16)
    w_t = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16)
    xhat = _t(rng, (B, N), dev).to(torch.bfloat16)
    rstd = torch.from_numpy(rng.uniform(0.5, 2, (B, 32)).astype(np.float32)).to(dev)
    gamma, beta = 1 + _t(rng, (N,), dev, 0.1), _t(rng, (N,), dev, 0.1)
    g_res = _t(rng, (B, N), dev, 1e-3) if with_g_res else None
    want = ft.dense_gn_silu_bwd_plain(dh_next, w_t, xhat, rstd, gamma, beta, 5, 2, 0.9, g_res)
    g_out = torch.empty(B, N, device=dev)
    got = ft.dense_gn_silu_bwd(dh_next, w_t, xhat, rstd, gamma, beta, 5, 2, 0.9, g_res=g_res,
                               g_out=g_out)
    torch.cuda.synchronize()
    _bf16_close(got[0], want[0])
    scale = float(want[1].abs().max())
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-3 * scale)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3 * float(w.abs().max()))
    # a step is deterministic: the dgamma/dbeta sums take a fixed order
    again = ft.dense_gn_silu_bwd(dh_next, w_t, xhat, rstd, gamma, beta, 5, 2, 0.9,
                                 g_res=g_res, g_out=g_out)
    assert all(torch.equal(a, b) for a, b in zip(got[2:], again[2:]))


def test_train_route_matches_plain_route(dev):
    from dposer_tpu_torch.diffusion.sde import SubVPSDE
    from dposer_tpu_torch.ops.cuda import fused_train as ft

    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3).to(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    batch = torch.randn(1280, 63, generator=g, device=dev)
    noise = dict(t=torch.rand(1280, generator=g, device=dev) * 0.99 + 0.01,
                 z=torch.randn(1280, 63, generator=g, device=dev), dropout_seed=31)
    (lk, gk), (lp, gp) = (ft.get_cuda_train_loss_and_grad(SubVPSDE(N=1000), model,
                                                          reduce_mean=True, plain=plain)(
        batch, **noise) for plain in (False, True))
    torch.testing.assert_close(lk, lp, rtol=1e-3, atol=0)
    for n in gk:
        rel = float((gk[n] - gp[n]).norm() / (gp[n].norm() + 1e-12))
        assert rel < 2e-2, f"{n}: relative error {rel}"


# ---------------------------------------------------------------------------
# the int8 serving mode (K13) and the microbenchmarks' kernel (K14)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [63, 1024])
@pytest.mark.parametrize("with_residual", [False, True])
def test_dense_gn_silu_int8(dev, K, with_residual):
    from dposer_tpu_torch.ops.cuda.score_net import (dense_gn_silu_int8,
                                                     dense_gn_silu_int8_plain)
    rng = np.random.default_rng(K + 1)
    B, N = 500, 1024
    a = _t(rng, (B, K), dev)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(N, K)).astype(np.int8)).to(dev)
    qinv = torch.from_numpy(rng.uniform(10, 60, size=K).astype(np.float32)).to(dev)
    qs = torch.from_numpy(rng.uniform(1e-5, 1e-4, size=N).astype(np.float32)).to(dev)
    tp, gamma, beta = (_t(rng, (N,), dev) for _ in range(3))
    res = _t(rng, (B, N), dev) if with_residual else None
    want = dense_gn_silu_int8_plain(a, wq, qinv, qs, tp, gamma, beta, res)
    reset_launch_counts()
    out = dense_gn_silu_int8(a, wq, qinv, qs, tp, gamma, beta, residual=res)
    torch.cuda.synchronize()
    assert launch_counts()["dense_gn_silu_int8"] == 1
    # the same int32 sums, the epilogue's fp32 in another order
    torch.testing.assert_close(out, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", ["bf16", "bf16-out", "int8", "gn-silu"])
@pytest.mark.parametrize("update", [False, True])
def test_chain_link(dev, mode, update):
    from dposer_tpu_torch.ops.cuda import chain_link as cl
    rng = np.random.default_rng(21)
    B, H = 512, 1024
    a = _t(rng, (B, H), dev)
    if mode == "int8":
        w = torch.from_numpy(rng.integers(-30, 31, size=(H, H)).astype(np.int8)).to(dev)
        rows = cl.int8_rows(H, H, dev)
    else:
        w, rows = _t(rng, (H, H), dev, H ** -0.5).to(torch.bfloat16), {}
    x = _t(rng, (B, H), dev)
    want = cl.chain_link_plain_into(a, w, mode, out=x.clone(), update=update, **rows)
    reset_launch_counts()
    out = cl.chain_link(a, w, mode, out=x, update=update, **rows)
    torch.cuda.synchronize()
    assert launch_counts()["chain_link"] == 1
    scale = max(1.0, float(want.abs().max()))
    # fp32 sums against the plain version's exact ones; a bf16 output may
    # round to the neighbouring value
    torch.testing.assert_close(out, want, rtol=0,
                               atol=(8e-3 if mode == "bf16-out" else 1e-3) * scale)


@pytest.mark.parametrize("scheme", ["tensor", "channel"])
def test_int8_kernel_sampler_steps_match_plain(dev, scheme):
    """The int8 kernel sampler against its plain loop, step by step from
    the plain trajectory's state, and free-running within the bf16 sampler's
    bound; K13 carries every hidden layer."""
    from dposer_tpu_torch.ops.cuda import quant
    model = _small_model(dev)
    n, shape = 20, (40, 63)
    sde = tsde.SubVPSDE(N=n)
    calib = quant.calibrate_act_amax_per_channel if scheme == "channel" else \
        quant.calibrate_act_amax
    amax = calib(sde, model, (64, 63), torch.Generator(device=dev).manual_seed(0),
                 device=dev)
    rng = np.random.default_rng(23)
    z, noise = _t(rng, shape, dev), _t(rng, (n, 1) + shape, dev)
    net, coefs = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", dev,
                                                 quant="int8", act_amax=amax)
    sk, sp = (fused_em.pc_scratch(net, shape[0], 0, dev) for _ in range(2))
    xp = z.clone()
    reset_launch_counts()
    for i in range(n):
        xk = xp.clone()
        fused_em.pc_step(net, coefs, i, xk, sk, noise[i], n_corr=0, snr=0.16)
        fused_em.pc_step(net, coefs, i, xp, sp, noise[i], n_corr=0, snr=0.16, plain=True)
        torch.testing.assert_close(xk, xp, rtol=0, atol=2e-2 * max(1.0, float(xp.abs().max())))
    counts = launch_counts()
    assert counts["dense_gn_silu_int8"] == 5 * n and counts["dense_gn_silu"] == 0
    out = get_cuda_em_sampler(sde, model, shape, quant="int8", act_amax=amax,
                              device="cuda")(z=z, noise=noise)
    ref = get_cuda_em_sampler(sde, model, shape, quant="int8", act_amax=amax, device="cuda",
                              plain=True)(z=z, noise=noise)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-2 * max(1.0, float(ref.abs().max())))


def test_mixed_sampler_draws_the_full_runs_normals(dev):
    """Under in-kernel normals the int8 head and the bf16 tail draw with the
    one seed a full run draws: the mixed run is its two parts run with the
    generator's state restored between them."""
    from dposer_tpu_torch.ops.cuda import quant
    model = _small_model(dev)
    n, shape = 20, (40, 63)
    sde = tsde.SubVPSDE(N=n)
    amax = quant.calibrate_act_amax(sde, model, (64, 63),
                                    torch.Generator(device=dev).manual_seed(0), device=dev)
    kw = dict(rng_mode="kernel", device="cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    mixed = get_cuda_em_sampler(sde, model, shape, quant="int8", act_amax=amax,
                                bf16_tail_steps=n - 1, **kw)(gen)
    full_int8_first = get_cuda_em_sampler(sde, model, shape, quant="int8", act_amax=amax,
                                          denoise=False, step_range=(0, 1), **kw)
    tail = get_cuda_em_sampler(sde, model, shape, step_range=(1, n), **kw)
    g = torch.Generator(device=dev).manual_seed(5)
    z = sde.prior_sampling(shape, g, dev)
    state = g.get_state()
    x = full_int8_first(g, z=z)
    g.set_state(state)
    assert torch.equal(mixed, tail(g, z=x))


def test_microbenchmarks_run_on_the_card(dev, monkeypatch):
    from dposer_tpu_torch.benchmarks import ilp_probe, mxu_micro
    args = ["--steps", "3", "--m-pipe", "2", "--rounds", "1"]
    reset_launch_counts()
    rows = mxu_micro.main(args)
    assert all(r["ms"] > 0 and np.isfinite(r["checksum"]) for r in rows)
    splits = ilp_probe.main(args)
    assert [s["bitwise_equal_whole"] for s in splits] == [None, True, True]
    assert launch_counts()["chain_link"] > 0
