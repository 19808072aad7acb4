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
from dposer_tpu_torch.ops.cuda import fused_em, score_net
from dposer_tpu_torch.ops.cuda.fused_em import (get_cuda_em_sampler, head_em,
                                                langevin_update, launch_counts,
                                                reset_launch_counts)
from dposer_tpu_torch.ops.cuda.score_net import HEAD_COLS, dense_gn_silu

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


def test_langevin_update(dev):
    rng = np.random.default_rng(5)
    x, score, z = (_t(rng, (500, 63), dev) for _ in range(3))
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
