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
from dposer_tpu_torch.ops.cuda import (fused_comp, fused_em, fused_lik, fused_ode, philox,
                                       score_net)
from dposer_tpu_torch.ops.cuda.fused_comp import (comp_perturb, get_cuda_comp_solver,
                                                  head_adam, head_adam_perturb)
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


# rows: one, a likelihood batch, generation's 500 (a ragged last tile; the
# deep ring) and completion's 1,000 (the shallow ring at N = 1024, more
# blocks than SMs); K: the pre layer's 63 and 64 (the pre route from fp32 A:
# one wgmma stage from shared memory) and 1024 (the bf16 route, from A's
# bf16 copy); N = 32 x the group size; the residual absent, given, or
# aliased by out
@pytest.mark.parametrize("B", [1, 50, 500, 1000])
@pytest.mark.parametrize("K", [63, 64, 1024])
@pytest.mark.parametrize("gs", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("residual", ["none", "given", "aliased"])
def test_dense_gn_silu(dev, B, K, gs, residual):
    rng = np.random.default_rng(K)
    N = 32 * gs
    a = _t(rng, (B, K), dev)
    w = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16)
    tp, gamma, beta = (_t(rng, (N,), dev) for _ in range(3))
    res = _t(rng, (B, N), dev) if residual != "none" else None
    want = score_net.dense_gn_silu_plain(a, w, tp, gamma, beta, res)
    a_b = a.to(torch.bfloat16) if K > 64 else None
    reset_launch_counts()
    out = dense_gn_silu(a, w, tp, gamma, beta, residual=res,
                        out=res if residual == "aliased" else None, a_b=a_b)
    torch.cuda.synchronize()
    assert launch_counts()["dense_gn_silu"] == 1
    if residual == "aliased":
        assert out is res
    # same bf16 operands, fp32 sums in another order: rounding only
    torch.testing.assert_close(out, want, rtol=0, atol=1e-3)


def _route_counts(bf16=0, pre=0):
    return {"wgmma_bf16": bf16, "pre_wgmma": pre}


# the bf16 route, from the copy the layer before wrote: rows one, a
# likelihood batch, generation's 500 (a ragged last tile; the deep ring) and
# completion's 1,000 (more CTAs than SMs at N = 1024: the shallow ring); K
# one stage and the hidden 1024; against the route the wrapper takes from
# fp32 A at K = 64 (the pre route: the same products in the same order, so
# the same bits) and the plain version
@pytest.mark.parametrize("B", [1, 50, 500, 1000])
@pytest.mark.parametrize("K", [64, 1024])
@pytest.mark.parametrize("gs", [2, 8, 32])
@pytest.mark.parametrize("residual", ["none", "given", "aliased"])
def test_dense_gn_silu_bf16_route(dev, B, K, gs, residual):
    rng = np.random.default_rng(K + B)
    N = 32 * gs
    a = _t(rng, (B, K), dev)
    w = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16)
    tp, gamma, beta = (_t(rng, (N,), dev) for _ in range(3))
    res = _t(rng, (B, N), dev) if residual != "none" else None
    want = score_net.dense_gn_silu_plain(a, w, tp, gamma, beta, res)
    reset_launch_counts()
    ref = dense_gn_silu(a, w, tp, gamma, beta, residual=res) if K <= 64 else None
    out_b = torch.empty((B, N), dtype=torch.bfloat16, device=dev)
    res_in = None if res is None else res.clone()
    out = dense_gn_silu(None, w, tp, gamma, beta, residual=res,
                        out=res if residual == "aliased" else None, a_b=a.to(torch.bfloat16),
                        out_b=out_b)
    torch.cuda.synchronize()
    assert fused_em.route_counts()["dense_gn_silu"] == _route_counts(bf16=1, pre=int(K <= 64))
    if residual == "aliased":
        assert out is res
    assert ref is None or torch.equal(out, ref)
    # the copy is __float2bfloat16_rn of what the epilogue stored: torch's
    # round to nearest even
    assert torch.equal(out_b, out.to(torch.bfloat16))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-3)
    only_b = torch.empty_like(out_b)
    got = dense_gn_silu(None, w, tp, gamma, beta, residual=res_in, a_b=a.to(torch.bfloat16),
                        out_b=only_b, write_out=False)
    torch.cuda.synchronize()
    assert got is only_b and torch.equal(only_b, out_b)


def test_dense_gn_silu_pre_layer_writes_the_copy(dev):
    """The pre layer (K = 63, the pre route) with ``out_b``: its bf16
    copy byte for byte is its fp32 output rounded, and the output is the one
    it writes without the copy."""
    rng = np.random.default_rng(63)
    B, K, N = 500, 63, 1024
    a = _t(rng, (B, K), dev)
    w = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16)
    tp, gamma, beta = (_t(rng, (N,), dev) for _ in range(3))
    ref = dense_gn_silu(a, w, tp, gamma, beta)
    out_b = torch.empty((B, N), dtype=torch.bfloat16, device=dev)
    reset_launch_counts()
    out = dense_gn_silu(a, w, tp, gamma, beta, out_b=out_b)
    torch.cuda.synchronize()
    assert fused_em.route_counts()["dense_gn_silu"] == _route_counts(pre=1)
    assert torch.equal(out, ref) and torch.equal(out_b, out.to(torch.bfloat16))


def _misaligned_like(t):
    """A copy of ``t`` whose data starts 4 bytes past a 16-byte boundary."""
    base = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    skip = next(s for s in range(1, 16) if (base.data_ptr() + 4 * s) % 16 == 4)
    out = base[skip:skip + t.numel()].view(t.shape)
    return out.copy_(t)


# the pre layer's shapes: rows 40 and 70 (one CTA row, one and a half),
# generation's 500 and completion's 1,000 (a bulk copy a row block, the last
# ragged), 1,001 (a last block of one row: 63 values, no 16-byte multiple);
# A 16-byte aligned (the bulk copy) or not (every thread's loads)
@pytest.mark.parametrize("B", [40, 70, 500, 1000, 1001])
@pytest.mark.parametrize("aligned", [True, False])
def test_k1_pre_route(dev, B, aligned):
    """The pre route (K = 63 from the fp32 state, as the pre layer writes
    ``out`` and ``out_b``) is bit-equal to itself on the operands
    zero-padded to K = 64 (column 63 and W's row 63 read as zeros either
    way, and the same k16 chunks are summed in the same order) and within
    the plain version's tolerance."""
    rng = np.random.default_rng(B)
    K, N = 63, 1024
    a = _t(rng, (B, K), dev)
    if not aligned:
        a = _misaligned_like(a)
    assert (a.data_ptr() % 16 == 0) == aligned
    w = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16)
    tp, gamma, beta = (_t(rng, (N,), dev) for _ in range(3))
    want = score_net.dense_gn_silu_plain(a, w, tp, gamma, beta)
    a64 = torch.zeros(B, 64, device=dev)
    a64[:, :K] = a
    w64 = torch.zeros(64, N, dtype=torch.bfloat16, device=dev)
    w64[:K] = w
    out_b = torch.empty((B, N), dtype=torch.bfloat16, device=dev)
    reset_launch_counts()
    out = dense_gn_silu(a, w, tp, gamma, beta, out_b=out_b)
    assert fused_em.route_counts()["dense_gn_silu"] == _route_counts(pre=1)
    padded_b = torch.empty_like(out_b)
    padded = dense_gn_silu(a64, w64, tp, gamma, beta, out_b=padded_b)
    torch.cuda.synchronize()
    assert fused_em.route_counts()["dense_gn_silu"] == _route_counts(pre=2)
    assert torch.equal(out, padded) and torch.equal(out_b, padded_b)
    assert torch.equal(out_b, out.to(torch.bfloat16))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("B", [40, 500, 1000, 1001])
def test_k1_pre_route_launch_info(dev, B):
    """The pre route's registers (at most 128 a thread) and shared memory let
    two CTAs share an SM, with no local memory (no spills); a grid that fits
    the SMs once (40 and 500 rows at N = 1024) reserves the shared memory
    that holds it to one CTA an SM, a larger one to two."""
    info = score_net.dense_gn_silu_pre_launch_info(B, 1024)
    assert info["threads"] == 256 and info["registers"] <= 128, info
    assert info["local_bytes"] == 0, info
    one_wave = 16 * -(-B // 64) <= torch.cuda.get_device_properties(dev).multi_processor_count
    assert info["ctas_per_sm"] == (1 if one_wave else 2), info


def test_k1_routes_a_forward(dev):
    """A generation call and a completion solve, each replayed from its
    graph, run every forward as 4 layers on the bf16 route and the pre layer
    on the pre route."""
    model = _small_model(dev)
    n = 6
    sampler = get_cuda_em_sampler(tsde.SubVPSDE(N=n), model, (40, 63), rng_mode="kernel",
                                  device="cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sampler(g)  # captures
    reset_launch_counts()
    x = sampler(g)
    torch.cuda.synchronize()
    assert torch.isfinite(x).all()
    assert fused_em.route_counts()["dense_gn_silu"] == _route_counts(bf16=4 * n, pre=n)
    rows, steps = 70, 8
    rng = np.random.default_rng(12)
    obs, mask = _t(rng, (rows, 63), dev, 0.3), torch.ones(rows, 63, device=dev)
    mask[:, 0:12] = 0.0
    solve = get_cuda_comp_solver(tsde.SubVPSDE(N=1000), model, (rows, 63), rows * 63,
                                 iterations=2, steps_per_iter=steps // 2, rng_mode="kernel",
                                 device="cuda")
    solve(g, obs, mask)  # captures
    reset_launch_counts()
    x = solve(g, obs, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(x).all()
    assert fused_em.route_counts()["dense_gn_silu"] == _route_counts(bf16=4 * steps,
                                                                     pre=steps)


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


# K2's tiles: one row, a partial 16-row tile (37), generation's 500 and the
# completion hypotheses' 1,000
@pytest.mark.parametrize("B", [1, 37, 500, 1000])
def test_head_em_host_noise(dev, B):
    h, w_post, b_post, coefs, x, z = _head(dev, B=B)
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


@pytest.mark.parametrize("kernel", ["head_em", "langevin_update"])
def test_in_kernel_normals_follow_the_plain_philox_stream(dev, kernel):
    """Element by element: K2 draws philox_normal per element, K3
    philox_normal4 per group of four columns, keyed by (seed, step, slab,
    row, column); recovered from the updates (K2 with cnoise = 1, K3 from
    x = 0)."""
    h, w_post, b_post, coefs, x, _ = _head(dev)
    B, D = x.shape
    for step, slab in ((0, 1), (3, 2)):
        if kernel == "head_em":
            coefs[:, 2] = 1.0
            xs, x_mean = x.clone(), torch.empty_like(x)
            head_em(h, w_post, b_post, coefs, step, "em", x=xs, x_mean=x_mean, seed=77,
                    slab=slab)
            z = xs - x_mean
        else:
            score = x.clone()
            xs, st = torch.zeros_like(x), torch.empty(1, device=dev)
            langevin_update(xs, score, (score * score).sum(1), coefs, step, 0.16, seed=77,
                            slab=slab, step_out=st)
            z = (xs - st * score) / torch.sqrt(2 * st)
        want = philox.normals_grid(77, step, slab, B, D,
                                   per_group=kernel == "langevin_update", device=dev)
        torch.testing.assert_close(z, want, rtol=0, atol=1e-5)


# K3's batches: one row, fewer rows than its cluster has CTAs x warps, the
# flagship's 500, 1,000, and the largest it takes (its normals kept in
# registers up to 2,048 rows, redrawn past them)
@pytest.mark.parametrize("B", [1, 37, 500, 1000, 12288])
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


@pytest.mark.parametrize("B", [37, 1000, 12288])
def test_langevin_update_in_kernel_normals_at_every_batch(dev, B):
    """In-kernel normals, kept in registers (up to 2,048 rows) or redrawn
    (past them), against the plain version fed the plain Philox stream."""
    rng = np.random.default_rng(6)
    x, score = (_t(rng, (B, 63), dev) for _ in range(2))
    coefs = torch.rand(3, fused_em.N_COEFS, device=dev)
    sq = (score * score).sum(1)
    z = philox.normals_grid(11, 2, 0, B, 63, per_group=True, device=dev)
    want, st_ref = fused_em.langevin_update_plain(x, score, sq, coefs, 2, 0.16, z)
    st = torch.empty(1, device=dev)
    langevin_update(x, score, sq, coefs, 2, 0.16, seed=11, slab=0, step_out=st)
    torch.cuda.synchronize()
    torch.testing.assert_close(st[0], st_ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(x, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["head_em-em", "head_em-score", "langevin_update", "head_rk4",
                                  "head_rk4-denoise", "head_dsm-fp32", "head_dsm-bf16"])
@pytest.mark.parametrize("B", [37, 500])
def test_repeated_calls_are_bit_identical(dev, case, B):
    """The split-K partials (K2, K8, K11) and the batch sums (K3) meet in a
    fixed order through distributed shared memory: no atomics, the same
    bits."""
    from dposer_tpu_torch.ops.cuda import fused_train as ft

    h, w_post, b_post, coefs, x, _ = _head(dev, B=B)
    score = x.flip(1).contiguous()
    sq = (score * score).sum(1)
    dsm_coefs = torch.rand(B, 3, device=dev)
    outs = []
    for _ in range(10):
        if case.startswith("head_rk4"):
            st = [x.clone(), score.clone(), x.flip(0).contiguous()]
            head_rk4(h, w_post, b_post, coefs, 1, fused_ode.DENOISE if case.endswith("denoise")
                     else 1, *st)
            outs.append(st)
        elif case.startswith("head_dsm"):
            hh = h.to(torch.bfloat16) if case.endswith("bf16") else h
            outs.append(ft.head_dsm(hh, w_post, b_post, dsm_coefs, score))
        elif case == "head_em-em":
            xs, xm = x.clone(), torch.empty_like(x)
            head_em(h, w_post, b_post, coefs, 2, "em", x=xs, x_mean=xm, seed=3)
            outs.append((xs, xm))
        elif case == "head_em-score":
            s, q = torch.empty_like(x), torch.empty(B, device=dev)
            head_em(h, w_post, b_post, coefs, 1, "score", score=s, score_sq=q)
            outs.append((s, q))
        else:
            xs, st = x.clone(), torch.empty(1, device=dev)
            langevin_update(xs, score, sq, coefs, 1, 0.16, seed=3, step_out=st)
            outs.append((xs, st))
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


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


# K5 on host normals: the same bits as its plain version (no contraction)
@pytest.mark.parametrize("B", [1, 37, 1000])
def test_comp_perturb_bit_equal_to_plain(dev, B):
    rng = np.random.default_rng(B)
    x, z = _t(rng, (B, 63), dev), _t(rng, (B, 63), dev)
    coefs = torch.from_numpy(rng.uniform(0.1, 1.5, size=(4, 8)).astype(np.float32)).to(dev)
    pert = torch.empty_like(x)
    comp_perturb(x, pert, coefs, 2, noise=z)
    torch.cuda.synchronize()
    assert torch.equal(pert, fused_comp.comp_perturb_plain(x, coefs, 2, z))


def _adam_operands(dev, B, seed=18):
    h, w_post, b_post, coefs, x, pert = _head(dev, B=B, seed=seed)
    rng = np.random.default_rng(seed)
    obs, zn = _t(rng, x.shape, dev), _t(rng, x.shape, dev)
    mask = (torch.rand(x.shape, device=dev) < 0.5).float()
    m1, v = _t(rng, x.shape, dev, 0.1), _t(rng, x.shape, dev, 0.01).abs()
    return (h, w_post, b_post, coefs), [x, pert, obs, mask, m1, v], zn


# K6's tiles, as test_head_adam, with one pose and generation's 500 rows;
# host slabs and in-kernel draws
@pytest.mark.parametrize("B", [1, 37, 500, 1000])
@pytest.mark.parametrize("rng_mode", ["host", "kernel"])
def test_head_adam_perturb_is_head_adam_then_comp_perturb(dev, B, rng_mode):
    """K6's perturbing instantiation against K6 -> K5 at the next step on
    the same normals: the same bits in x, m1, v and pert (the perturbation
    rounds each operation on its own in both kernels)."""
    args, state, zn = _adam_operands(dev, B)
    step, slab = 1, 0
    nz = dict(noise=zn) if rng_mode == "host" else dict(seed=4243)
    got = [t.clone() for t in state]
    reset_launch_counts()
    head_adam_perturb(*args, step, *got, slab=slab, **nz)
    torch.cuda.synchronize()
    c = launch_counts()
    assert (c["head_adam_perturb"], c["head_adam"], c["comp_perturb"]) == (1, 0, 0)
    want = [t.clone() for t in state]
    head_adam(*args, step, *want)
    comp_perturb(want[0], want[1], args[3], step + 1, slab=slab, **nz)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and the plain version on the same host slab, within K6's bound
    if rng_mode == "host":
        ref = [t.clone() for t in state]
        fused_comp.head_adam_perturb_plain_into(*args, step, *ref, noise=zn)
        for a, b, floor in zip(got, ref, (1.0, 1.0, 1.0, 1.0, 0.0, 0.0)):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-3 * max(floor, float(b.abs().max())))


# K6's tiles: a ragged one (37 rows: 2 whole tiles and 5 poses) and the
# solver's 1,000 rows (63 tiles, the last of 8 poses)
@pytest.mark.parametrize("B", [37, 1000])
@pytest.mark.parametrize("paste", [False, True])
def test_head_adam(dev, paste, B):
    h, w_post, b_post, coefs, x, pert = _head(dev, B=B, seed=10)
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
    # K5 at the first step only: K6 writes every later step's perturbation
    assert (counts["comp_perturb"], counts["dense_gn_silu"], counts["head_adam_perturb"],
            counts["head_adam"]) == (1, 5 * steps, steps - 1, 1)
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
        # a step called alone re-noises before its predictor in K4, after it in K2
        assert (counts["masked_renoise"], counts["head_em_impute"]) == (n, n)
        assert counts["head_em"] == n * n_corr
        assert counts["dense_gn_silu"] == 5 * n * (1 + n_corr)


def _impute_operands(dev, B, seed=14):
    h, w_post, b_post, coefs, x, z = _head(dev, B=B, seed=seed)
    rng = np.random.default_rng(seed)
    obs, zp, zn = (_t(rng, (B, 63), dev) for _ in range(3))
    mask = torch.zeros(B, 63, device=dev)
    mask[:, 12:] = 1.0
    return (h, w_post, b_post, coefs), x, z, (obs, mask), zp, zn


# K2's tiles, as test_head_em_host_noise; one re-noise (the call's last step)
# or two (the next step's too); host slabs and in-kernel draws
@pytest.mark.parametrize("B", [1, 37, 500, 1000])
@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("rng_mode", ["host", "kernel"])
def test_head_em_impute_is_head_em_then_masked_renoise(dev, B, passes, rng_mode):
    """K2's imputation epilogue against K2 -> K4 (-> K4 at the next step)
    on the same normals: the same bits (the re-noise rounds each operation
    on its own in both kernels), and x_mean the state before the re-noise."""
    args, x, z, observed, zp, zn = _impute_operands(dev, B)
    step, slab = 1, 1
    host = rng_mode == "host"
    nz = dict(noise=z) if host else dict(seed=4242)
    x_f, xm_f = x.clone(), torch.empty_like(x)
    reset_launch_counts()
    head_em(*args, step, "em", x=x_f, x_mean=xm_f, slab=slab, observed=observed,
            renoise_noise=((zp, zn)[:passes] if host else None),
            renoise_next=0 if passes == 2 else None, **nz)
    torch.cuda.synchronize()
    assert launch_counts()["head_em_impute"] == 1 and launch_counts()["head_em"] == 0
    x_u, xm_u = x.clone(), torch.empty_like(x)
    head_em(*args, step, "em", x=x_u, x_mean=xm_u, slab=slab, **nz)
    masked_renoise(x_u, *observed, args[3], step, slab=slab + 1,
                   **(dict(noise=zp) if host else nz))
    if passes == 2:
        masked_renoise(x_u, *observed, args[3], step + 1, slab=0,
                       **(dict(noise=zn) if host else nz))
    torch.cuda.synchronize()
    assert torch.equal(xm_f, xm_u)
    assert torch.equal(x_f, x_u)
    # and the plain version on the same host slabs, within K2's bound
    if host:
        want = x.clone()
        fused_em.head_em_plain_into(*args, step, "em", x=want, noise=z, slab=slab,
                                    observed=observed, renoise_noise=(zp, zn)[:passes],
                                    renoise_next=0 if passes == 2 else None)
        torch.testing.assert_close(x_f, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kernel", ["head_adam", "head_em_impute", "head_adam_perturb"])
def test_cluster_heads_50_calls_bit_identical(dev, kernel):
    """K6, K2's imputation epilogue and K6's perturbing instantiation: 50
    calls, the same bits."""
    outs = []
    if kernel == "head_adam_perturb":
        args, state, _ = _adam_operands(dev, 1000, seed=19)
        for _ in range(50):
            st = [t.clone() for t in state]
            head_adam_perturb(*args, 2, *st, seed=9)
            outs.append(st)
    elif kernel == "head_adam":
        h, w_post, b_post, coefs, x, pert = _head(dev, B=1000, seed=15)
        rng = np.random.default_rng(15)
        obs = _t(rng, x.shape, dev)
        mask = (torch.rand(x.shape, device=dev) < 0.5).float()
        m1, v = _t(rng, x.shape, dev, 0.1), _t(rng, x.shape, dev, 0.01).abs()
        for _ in range(50):
            st = [x.clone(), m1.clone(), v.clone()]
            head_adam(h, w_post, b_post, coefs, 2, st[0], pert, obs, mask, st[1], st[2], True)
            outs.append(st)
    else:
        args, x, _, observed, _, _ = _impute_operands(dev, 500, seed=16)
        for _ in range(50):
            st = [x.clone(), torch.empty_like(x)]
            head_em(*args, 1, "em", x=st[0], x_mean=st[1], seed=9, slab=1,
                    observed=observed, renoise_next=0)
            outs.append(st)
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


@pytest.mark.parametrize("corrector", ["none", "langevin"])
def test_imputation_sampler_launches_masked_renoise_once_without_corrector(dev, corrector):
    """A whole call: without a corrector K4 runs once (the first step's
    re-noise) and K2's imputation epilogue every step; after the corrector
    K4 runs once a step."""
    model = _small_model(dev)
    n, shape = 20, (40, 63)
    rng = np.random.default_rng(17)
    z, obs = _t(rng, shape, dev), _t(rng, shape, dev, 0.3)
    mask = torch.zeros(shape, device=dev)
    mask[:, 12:] = 1.0
    for rng_mode in ("host", "kernel"):
        sampler = get_cuda_em_sampler(tsde.SubVPSDE(N=n), model, shape, corrector=corrector,
                                      imputation=True, rng_mode=rng_mode, device="cuda")
        reset_launch_counts()
        out = sampler(torch.Generator(device=dev).manual_seed(1), observation=obs, mask=mask,
                      z=z)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["masked_renoise"] == (1 if corrector == "none" else n)
        assert counts["head_em_impute"] == n
        assert torch.isfinite(out).all()


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


# rows: one, a ragged tile, the likelihood's 50, one whole 64-pose tile, a
# tile and a ragged one, two whole tiles, 500 (eight tiles); K: the pre
# layer's 63 (the register route) and 1024 on both routes: the register
# route rounding fp32 A and dA, the Hopper route on their bf16 copies
JVP_ROWS = [1, 17, 50, 64, 70, 128, 500]


def _jvp_operands(dev, B, K, with_residual, N=1024, seed=0):
    rng = np.random.default_rng(K + B + seed)
    a, da = _t(rng, (B, K), dev), _t(rng, (B, K), dev)
    w = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16)
    tp, gamma, beta = (_t(rng, (N,), dev) for _ in range(3))
    res = (_t(rng, (B, N), dev), _t(rng, (B, N), dev)) if with_residual else (None, None)
    return a, da, w, tp, gamma, beta, res


def _hold_jvp(out, dout, want):
    # same bf16 operands, fp32 sums in another order: rounding only; the
    # tangent passes through 1/std of the group, so it scales with its own range
    torch.testing.assert_close(out, want[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(dout, want[1], rtol=0,
                               atol=1e-3 * max(1.0, float(want[1].abs().max())))


@pytest.mark.parametrize("B", JVP_ROWS)
@pytest.mark.parametrize("K,route", [(63, "register"), (1024, "register"), (1024, "wgmma")])
@pytest.mark.parametrize("with_residual", [False, True])
def test_dense_gn_silu_jvp(dev, B, K, route, with_residual):
    a, da, w, tp, gamma, beta, res = _jvp_operands(dev, B, K, with_residual)
    want = score_net.dense_gn_silu_jvp_plain(a, da, w, tp, gamma, beta, *res)
    kw = {}
    if route == "wgmma":
        kw = dict(a_b=a.to(torch.bfloat16), da_b=da.to(torch.bfloat16))
        a = da = None
    N = w.shape[1]
    ob, dob = (torch.empty((B, N), dtype=torch.bfloat16, device=dev) for _ in range(2))
    reset_launch_counts()
    out, dout = dense_gn_silu_jvp(a, da, w, tp, gamma, beta, residual=res[0],
                                  dresidual=res[1], out_b=ob, dout_b=dob, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["dense_gn_silu_jvp"] == 1
    assert fused_em.route_counts()["dense_gn_silu_jvp"][route] == 1
    _hold_jvp(out, dout, want)
    # the copies are the stored values rounded to bf16
    assert torch.equal(ob, out.to(torch.bfloat16)) and torch.equal(dob, dout.to(torch.bfloat16))
    if with_residual:  # in place, as the block's second layer runs it
        dense_gn_silu_jvp(a, da, w, tp, gamma, beta, residual=res[0], dresidual=res[1],
                          out=res[0], dout=res[1], **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(res[0], out, rtol=0, atol=0)
        torch.testing.assert_close(res[1], dout, rtol=0, atol=0)


# the Hopper route's cluster sizes through the depths that take them (1 at
# K 64-256, 2 at 384 and 512, 4 at 1024, 8 at 2048) and group sizes 8
# (N = 256) and 32
@pytest.mark.parametrize("K", [64, 128, 256, 384, 512, 1024, 2048])
@pytest.mark.parametrize("N", [256, 1024])
def test_dense_gn_silu_jvp_clusters(dev, K, N):
    B = 70
    a, da, w, tp, gamma, beta, res = _jvp_operands(dev, B, K, True, N=N, seed=1)
    want = score_net.dense_gn_silu_jvp_plain(a, da, w, tp, gamma, beta, *res)
    out, dout = dense_gn_silu_jvp(None, None, w, tp, gamma, beta, residual=res[0],
                                  dresidual=res[1], a_b=a.to(torch.bfloat16),
                                  da_b=da.to(torch.bfloat16))
    torch.cuda.synchronize()
    _hold_jvp(out, dout, want)


def test_likelihood_kernels_bit_identical(dev):
    """K7's Hopper route and K9 sum their split-K partials in rank order: 50
    repeated calls give the same bits."""
    B, K = 50, 1024
    a, da, w, tp, gamma, beta, res = _jvp_operands(dev, B, K, True, seed=2)
    kw = dict(a_b=a.to(torch.bfloat16), da_b=da.to(torch.bfloat16))
    first = [t.clone() for t in dense_gn_silu_jvp(None, None, w, tp, gamma, beta, *res, **kw)]
    for _ in range(49):
        again = dense_gn_silu_jvp(None, None, w, tp, gamma, beta, *res, **kw)
        assert all(torch.equal(x, y) for x, y in zip(again, first))
    h, w_post, b_post, coefs, x, xs, acc = _rk4_state(dev, B, 60)
    rng = np.random.default_rng(61)
    dh, eps = _t(rng, h.shape, dev), torch.sign(_t(rng, x.shape, dev))
    lp, lacc = _t(rng, (B,), dev), _t(rng, (B,), dev)
    outs = []
    for _ in range(50):
        st = [t.clone() for t in (x, xs, acc, lp, lacc)]
        head_rk4_jvp(h, dh, w_post, b_post, coefs, 5, 1, *st[:3], eps, *st[3:])
        outs.append(st)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for st in outs[1:] for p, q in zip(st, outs[0]))


def _rk4_state(dev, B, seed, D=63, H=1024):
    rng = np.random.default_rng(seed)
    h, w_post, b_post, _, x, xs = _head(dev, B=B, H=H, seed=seed)
    coefs = torch.from_numpy(rng.uniform(-1.0, 1.0, size=(7, fused_ode.N_COEFS))
                             .astype(np.float32)).to(dev)
    return h, w_post, b_post, coefs, x, xs, _t(rng, (B, D), dev)


# rows: one, a partial tile (15), one whole tile (16), one past it (17) and
# ODE sampling's 500; H 1024 cuts into 256-deep slices, H 64 into one k-step
# a CTA
@pytest.mark.parametrize("B", [1, 15, 16, 17, 500])
@pytest.mark.parametrize("stage", [0, 1, 2, 3, fused_ode.DENOISE])
@pytest.mark.parametrize("H", [64, 1024])
def test_head_rk4(dev, B, stage, H):
    h, w_post, b_post, coefs, x, xs, acc = _rk4_state(dev, B, 20 + stage, H=H)
    want = fused_ode.head_rk4_plain(h, w_post, b_post, coefs, 5, stage, x, xs, acc)
    reset_launch_counts()
    head_rk4(h, w_post, b_post, coefs, 5, stage, x, xs, acc)
    torch.cuda.synchronize()
    assert launch_counts()["head_rk4"] == 1
    for got, ref in zip((x, xs, acc), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 * max(1.0, float(ref.abs().max())))


@pytest.mark.parametrize("B", JVP_ROWS)
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
# H 1024 splits over clusters of 8 CTAs, H 192 over clusters of 4
@pytest.mark.parametrize("H", [1024, 192])
def test_head_rk4_jvp(dev, B, stage, H):
    h, w_post, b_post, coefs, x, xs, acc = _rk4_state(dev, B, 30 + stage, H=H)
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
    # a stage: the pre layer on the register route, the four block layers on
    # the Hopper route (the bf16 handoff)
    assert fused_em.route_counts()["dense_gn_silu_jvp"] == {"wgmma": 16 * n, "register": 4 * n}
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


# rows: one, one past a tile, the train batch; H 1024 and the smallest, 64
@pytest.mark.parametrize("B", [1, 17, 1280])
@pytest.mark.parametrize("H", [64, 1024])
def test_head_dsm_on_stash(dev, B, H):
    """K11 on the bf16 stash (its bf16 instantiation: half the bytes, no
    rounding in registers) against K11 on fp32 h (the fp32 instantiation):
    bit-equal, since the stash is h rounded as the head rounds it; both
    within the plain version's tolerances."""
    from dposer_tpu_torch.ops.cuda import fused_train as ft

    h, w_post, b_post, _, z, _ = _head(dev, B=B, H=H)
    rng = np.random.default_rng(B)
    coefs = torch.from_numpy(np.stack([-rng.uniform(0.1, 2, B), rng.uniform(0.5, 2, B),
                                       np.full(B, 1 / (63 * B))], 1).astype(np.float32)).to(dev)
    want = ft.head_dsm_plain(h, w_post, b_post, coefs, z)
    reset_launch_counts()
    got32 = ft.head_dsm(h, w_post, b_post, coefs, z)
    got16 = ft.head_dsm(h.to(torch.bfloat16), w_post, b_post, coefs, z)
    torch.cuda.synchronize()
    assert launch_counts()["head_dsm"] == 2
    for a, b in zip(got16, got32):
        assert torch.equal(a, b)
    torch.testing.assert_close(got16[0], want[0], rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(got16[1], want[1], rtol=0, atol=1e-3 * float(want[1].abs().max()))


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


def _k10_operands(dev, B, K, N, seed):
    rng = np.random.default_rng(seed)
    a = _t(rng, (B, K), dev)
    w = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16)
    proj = _t(rng, (B, N), dev, 0.3).to(torch.bfloat16)
    gamma, beta = 1 + _t(rng, (N,), dev, 0.1), _t(rng, (N,), dev, 0.1)
    return a, w, proj, gamma, beta, _t(rng, (B, N), dev)


def _k10_close(got, want):
    """K10's tolerances (chip_smoke.py phase 3): out 1e-3 absolute, the bf16
    stash and xhat one bf16 ulp, rstd 1e-3 relative (a group of 2 features
    has a variance that cancels)."""
    if got[0] is not None:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-3)
    _bf16_close(got[1], want[1])
    _bf16_close(got[2], want[2])
    torch.testing.assert_close(got[3], want[3], rtol=1e-3, atol=0)


# rows: one, a ragged 37, generation's 500, the train batch 1,280 and 2,000
# (more tiles than three CTAs an SM hold at once); N = 32 x the group size;
# the layer kinds of a step: the pre layer (fp32 A at K = 63, the register
# route), a block's first layer (the stash as A, no fp32 output) and its
# second (the residual given, or updated in place)
@pytest.mark.parametrize("B", [1, 37, 500, 1280, 2000])
@pytest.mark.parametrize("gs", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("layer", ["pre", "block", "block_no_out", "block_residual",
                                   "block_residual_in_place"])
def test_dense_gn_silu_train_hopper_route(dev, B, gs, layer):
    from dposer_tpu_torch.ops.cuda import fused_train as ft

    N, K = 32 * gs, 63 if layer == "pre" else 1024
    a, w, proj, gamma, beta, res = _k10_operands(dev, B, K, N, B + gs)
    res = res if layer.startswith("block_residual") else None
    want = ft.dense_gn_silu_train_plain(a, w, proj, gamma, beta, 99, 3, 0.9, res)
    kw = dict(residual=res)
    if layer != "pre":
        kw["a_b"] = a.to(torch.bfloat16)
    if layer == "block_no_out":
        kw["write_out"] = False
    if layer == "block_residual_in_place":
        kw["out"] = res.clone()
        kw["residual"] = kw["out"]
    reset_launch_counts()
    got = ft.dense_gn_silu_train(None if layer != "pre" else a, w, proj, gamma, beta, 99, 3, 0.9,
                                 **kw)
    torch.cuda.synchronize()
    route = "register" if layer == "pre" else "wgmma"
    assert fused_em.route_counts()["dense_gn_silu_train"] == {
        "wgmma": int(route == "wgmma"), "register": int(route == "register")}
    assert launch_counts()["dense_gn_silu_train"] == 1
    if layer == "block_no_out":
        assert got[0] is None
    if layer == "block_residual_in_place":
        assert got[0] is kw["out"]
    _k10_close(got, want)  # out to 1e-3 holds the kernel to the plain version's mask


@pytest.mark.parametrize("B", [37, 1280])
@pytest.mark.parametrize("K", [72, 1024])
def test_dense_gn_silu_train_routes_agree(dev, B, K):
    """The stash as A (the Hopper route; K = 72 ends on a ragged 64-deep box,
    whose columns past K read as zeros) against fp32 A (the register route),
    both rounding to the same bf16 operands: on the card within the plain
    version's tolerances of each other, since wgmma and the register loop's
    mma sum in different orders; the plain version gives the same bits
    either way. 10 repeated calls of each route give the same bits."""
    from dposer_tpu_torch.ops.cuda import fused_train as ft

    a, w, proj, gamma, beta, res = _k10_operands(dev, B, K, 1024, K)
    a_b = a.to(torch.bfloat16)
    plain = ft.dense_gn_silu_train_plain(a, w, proj, gamma, beta, 7, 1, 0.9, res)
    plain_b = ft.dense_gn_silu_train_plain(None, w, proj, gamma, beta, 7, 1, 0.9, res, a_b=a_b)
    assert all(torch.equal(x, y) for x, y in zip(plain, plain_b))
    reset_launch_counts()
    runs = {route: [ft.dense_gn_silu_train(a if route == "register" else None, w, proj, gamma,
                                           beta, 7, 1, 0.9, residual=res,
                                           a_b=a_b if route == "wgmma" else None)
                    for _ in range(10)] for route in ("wgmma", "register")}
    torch.cuda.synchronize()
    assert fused_em.route_counts()["dense_gn_silu_train"] == {"wgmma": 10, "register": 10}
    for outs in runs.values():
        _k10_close(outs[0], plain)
        assert all(torch.equal(x, y) for o in outs[1:] for x, y in zip(o, outs[0]))
    _k10_close(runs["wgmma"][0], runs["register"][0])


@pytest.mark.parametrize("B", [1, 37, 500, 1280, 2000])
@pytest.mark.parametrize("gs", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("K", [64, 1024])
@pytest.mark.parametrize("g_res", ["none", "given", "in_place"])
def test_dense_gn_silu_bwd_hopper_route(dev, B, gs, K, g_res):
    """Every hop on the Hopper loop: the first (K = 64, the zero-padded
    dout), a hidden one, with the carried gradient given or updated in place
    (g_out is g_res); the tolerances of test_dense_gn_silu_bwd; dgamma and
    dbeta bit-identical over 10 calls."""
    from dposer_tpu_torch.ops.cuda import fused_train as ft

    rng = np.random.default_rng(B + gs + K)
    N = 32 * gs
    dh_next = _t(rng, (B, K), dev, 1e-3).to(torch.bfloat16)
    w_t = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16)
    xhat = _t(rng, (B, N), dev).to(torch.bfloat16)
    rstd = torch.from_numpy(rng.uniform(0.5, 2, (B, 32)).astype(np.float32)).to(dev)
    gamma, beta = 1 + _t(rng, (N,), dev, 0.1), _t(rng, (N,), dev, 0.1)
    gr = _t(rng, (B, N), dev, 1e-3) if g_res != "none" else None
    want = ft.dense_gn_silu_bwd_plain(dh_next, w_t, xhat, rstd, gamma, beta, 5, 2, 0.9, gr)
    args = (dh_next, w_t, xhat, rstd, gamma, beta, 5, 2, 0.9)
    reset_launch_counts()
    runs = []
    for _ in range(10):
        res_in = None if gr is None else gr.clone()
        g_out = res_in if g_res == "in_place" else torch.empty(B, N, device=dev)
        runs.append(ft.dense_gn_silu_bwd(*args, g_res=res_in, g_out=g_out))
    torch.cuda.synchronize()
    assert fused_em.route_counts()["dense_gn_silu_bwd"] == {"wgmma": 10}
    got = runs[0]
    _bf16_close(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-3 * float(want[1].abs().max()))
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3 * float(w.abs().max()))
    for r in runs[1:]:
        assert torch.equal(r[0], got[0]) and torch.equal(r[1], got[1])
        assert torch.equal(r[2], got[2]) and torch.equal(r[3], got[3])


def test_dense_gn_silu_bwd_ragged_depth(dev):
    """K = 72: the second 64-deep box is ragged and reads zeros past K."""
    from dposer_tpu_torch.ops.cuda import fused_train as ft

    rng = np.random.default_rng(72)
    B, K, N = 300, 72, 1024
    args = (_t(rng, (B, K), dev, 1e-3).to(torch.bfloat16),
            _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16),
            _t(rng, (B, N), dev).to(torch.bfloat16),
            torch.from_numpy(rng.uniform(0.5, 2, (B, 32)).astype(np.float32)).to(dev),
            1 + _t(rng, (N,), dev, 0.1), _t(rng, (N,), dev, 0.1), 5, 2, 0.9)
    want = ft.dense_gn_silu_bwd_plain(*args)
    got = ft.dense_gn_silu_bwd(*args)
    torch.cuda.synchronize()
    _bf16_close(got[0], want[0])
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3 * float(w.abs().max()))


def test_train_step_routes(dev):
    """One flagship-width step through the kernels: K10 runs its four K =
    1024 layers on the Hopper route and the pre layer on the register route,
    K12 its five hops on the Hopper route."""
    from dposer_tpu_torch.diffusion.sde import SubVPSDE
    from dposer_tpu_torch.ops.cuda import fused_train as ft

    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3).to(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    batch = torch.randn(1280, 63, generator=g, device=dev)
    reset_launch_counts()
    ft.get_cuda_train_loss_and_grad(SubVPSDE(N=1000), model, reduce_mean=True)(batch,
                                                                                generator=g)
    torch.cuda.synchronize()
    routes = fused_em.route_counts()
    assert routes["dense_gn_silu_train"] == {"wgmma": 4, "register": 1}
    assert routes["dense_gn_silu_bwd"] == {"wgmma": 5}
    assert launch_counts()["head_dsm"] == 1


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
@pytest.mark.parametrize("B", [1, 50, 500, 1000])
@pytest.mark.parametrize("K", [63, 64, 1024])
@pytest.mark.parametrize("gs", [2, 4, 8, 16, 32])
def test_chain_link(dev, mode, update, B, K, gs):
    from dposer_tpu_torch.ops.cuda import chain_link as cl
    rng = np.random.default_rng(21)
    N = 32 * gs
    a = _t(rng, (B, K), dev)
    if mode == "int8":
        w = torch.from_numpy(rng.integers(-30, 31, size=(N, K)).astype(np.int8)).to(dev)
        rows = cl.int8_rows(K, N, dev)
    else:
        w, rows = _t(rng, (K, N), dev, K ** -0.5).to(torch.bfloat16), {}
    x = _t(rng, (B, N), dev)
    if K % 16:
        # the kernel takes K in multiples of 16: the wrapper raises, no launch
        reset_launch_counts()
        with pytest.raises(ValueError):
            cl.chain_link(a, w, mode, out=x, update=update, **rows)
        assert launch_counts()["chain_link"] == 0
        return
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


def _int8(rng, shape, dev, lo=-127, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(np.int8)).to(dev)


def test_int8_loop_first_tile_is_exact(dev):
    """The Hopper int8 loop (csrc/dense_wgmma_int8.cuh) on one [64,128] x
    [128,64] tile, both operands through TMA and wgmma s8 descriptors: the
    int32 sums exactly (qs = 1), then with a rescale row, bit for bit."""
    from dposer_tpu_torch.ops.cuda.quant import int8_matmul
    rng = np.random.default_rng(31)
    a_q, wq = _int8(rng, (64, 128), dev), _int8(rng, (64, 128), dev)
    want = int8_matmul(a_q.float(), wq.t())
    got = score_net.int8_loop_product(a_q, wq, torch.ones(64, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    qs = torch.from_numpy(rng.uniform(1e-5, 1e-3, size=64).astype(np.float32)).to(dev)
    assert torch.equal(score_net.int8_loop_product(a_q, wq, qs), want * qs)


@pytest.mark.parametrize("B", [1, 500, 1000])
@pytest.mark.parametrize("K", [16, 128, 1024])
def test_int8_loop_product_is_exact(dev, B, K):
    """The loop's product at a ragged row count, one partial stage (K 16),
    one stage and the eight stages of K = 1024, extreme values included:
    bit-equal to the exact sums times the rescale row."""
    from dposer_tpu_torch.ops.cuda.quant import int8_matmul
    rng = np.random.default_rng(K + B)
    N = 1024
    a_q, wq = _int8(rng, (B, K), dev), _int8(rng, (N, K), dev)
    a_q[0, :] = 127
    if K == 1024:  # the largest sums, |sum| = 1024 * 127^2 < 2^24
        wq = torch.where(wq > 0, 127, -127).to(torch.int8)
    qs = torch.from_numpy(rng.uniform(1e-5, 1e-4, size=N).astype(np.float32)).to(dev)
    got = score_net.int8_loop_product(a_q, wq, qs)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_matmul(a_q.float(), wq.t()) * qs)


@pytest.mark.parametrize("B", [1, 500])
@pytest.mark.parametrize("K", [128, 1024])
@pytest.mark.parametrize("residual", ["none", "given", "aliased"])
@pytest.mark.parametrize("copy", [False, True])
def test_dense_gn_silu_int8_hopper_route(dev, B, K, residual, copy):
    """K13 on an int8 ``a_q`` (the Hopper loop) against its plain version on
    the fp32 ``a`` that ``a_q`` quantizes: the same int32 sums, the epilogue's
    fp32 in another order (1e-3, as the register route); the int8 copy it
    writes is ``quantize_act`` of its own fp32 output, byte for byte."""
    from dposer_tpu_torch.ops.cuda.quant import quantize_act
    rng = np.random.default_rng(7 * K + B)
    N = 1024
    a = _t(rng, (B, K), dev)
    wq = _int8(rng, (N, K), dev)
    qinv = torch.from_numpy(rng.uniform(10, 60, size=K).astype(np.float32)).to(dev)
    qs = torch.from_numpy(rng.uniform(1e-5, 1e-4, size=N).astype(np.float32)).to(dev)
    tp, gamma, beta = (_t(rng, (N,), dev) for _ in range(3))
    res = _t(rng, (B, N), dev) if residual != "none" else None
    qnext = torch.from_numpy(rng.uniform(10, 60, size=N).astype(np.float32)).to(dev)
    out_q = torch.empty((B, N), dtype=torch.int8, device=dev) if copy else None
    want = score_net.dense_gn_silu_int8_plain(a, wq, qinv, qs, tp, gamma, beta, res)
    a_q = quantize_act(a, qinv).to(torch.int8)
    reset_launch_counts()
    out = score_net.dense_gn_silu_int8(None, wq, qinv, qs, tp, gamma, beta, residual=res,
                                       out=res if residual == "aliased" else None, a_q=a_q,
                                       qinv_next=qnext if copy else None, out_q=out_q)
    torch.cuda.synchronize()
    assert fused_em.route_counts()["dense_gn_silu_int8"] == _k13_routes(hopper=1)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-3)
    if copy:
        assert torch.equal(out_q, quantize_act(out, qnext).to(torch.int8))


def test_dense_gn_silu_int8_register_route_writes_the_copy(dev):
    """The pre layer (K = 63, the fp32 state; the pre route since it came,
    the register-staged loop before) with the int8 copy for the first block:
    ``quantize_act`` of its output."""
    from dposer_tpu_torch.ops.cuda.quant import quantize_act
    rng = np.random.default_rng(64)
    B, K, N = 500, 63, 1024
    a = _t(rng, (B, K), dev)
    wq = _int8(rng, (N, K), dev)
    qinv = torch.from_numpy(rng.uniform(10, 60, size=K).astype(np.float32)).to(dev)
    qs = torch.from_numpy(rng.uniform(1e-5, 1e-4, size=N).astype(np.float32)).to(dev)
    tp, gamma, beta = (_t(rng, (N,), dev) for _ in range(3))
    qnext = torch.from_numpy(rng.uniform(10, 60, size=N).astype(np.float32)).to(dev)
    out_q = torch.empty((B, N), dtype=torch.int8, device=dev)
    want = score_net.dense_gn_silu_int8_plain(a, wq, qinv, qs, tp, gamma, beta)
    reset_launch_counts()
    out = score_net.dense_gn_silu_int8(a, wq, qinv, qs, tp, gamma, beta, qinv_next=qnext,
                                       out_q=out_q)
    torch.cuda.synchronize()
    assert fused_em.route_counts()["dense_gn_silu_int8"] == _k13_routes(pre=1)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-3)
    assert torch.equal(out_q, quantize_act(out, qnext).to(torch.int8))


def _k13_routes(hopper=0, pre=0, register=0):
    return {"wgmma_int8": hopper, "pre_wgmma8": pre, "register": register}


def _k13_pre_operands(dev, B, scheme, state, seed):
    """The pre layer's operands at B rows: the state (16-byte aligned, or A
    or Wq 4 bytes past a boundary), int8 Wq [1024, 63], a per-tensor or
    per-channel quantization row, the rescale, time and affine rows and the
    next layer's quantization row."""
    rng = np.random.default_rng(seed)
    K, N = 63, 1024
    a = _t(rng, (B, K), dev, 2.0)
    wq = _int8(rng, (N, K), dev)
    if state == "misaligned A":
        a = _misaligned_like(a)
    elif state == "misaligned Wq":
        base = torch.empty(wq.numel() + 16, dtype=torch.int8, device=dev)
        skip = next(s for s in range(1, 16) if (base.data_ptr() + s) % 16 == 4)
        wq = base[skip:skip + wq.numel()].view(N, K).copy_(wq)
    assert (a.data_ptr() % 16 == 0) == (state != "misaligned A")
    assert (wq.data_ptr() % 16 == 0) == (state != "misaligned Wq")
    if scheme == "tensor":
        qinv = torch.full((K,), 127.0 / 4.0, device=dev)
    else:
        qinv = torch.from_numpy(rng.uniform(10, 60, size=K).astype(np.float32)).to(dev)
    qs = torch.from_numpy(rng.uniform(1e-5, 1e-4, size=N).astype(np.float32)).to(dev)
    tp, gamma, beta = (_t(rng, (N,), dev) for _ in range(3))
    qnext = torch.from_numpy(rng.uniform(10, 60, size=N).astype(np.float32)).to(dev)
    return a, wq, qinv, qs, tp, gamma, beta, qnext


# the pre layer's shapes: one row, 63 (one ragged CTA row), generation's 500
# (one CTA an SM) and completion's 1,000 (two); the state 16-byte aligned
# (both spans by one bulk copy each), A misaligned (every thread's loads of
# the state) or Wq misaligned (every thread's loads of Wq's span); the
# per-tensor and the per-channel quantization row
@pytest.mark.parametrize("B", [1, 63, 500, 1000])
@pytest.mark.parametrize("state", ["aligned", "misaligned A", "misaligned Wq"])
@pytest.mark.parametrize("scheme", ["tensor", "channel"])
def test_k13_pre_route(dev, B, state, scheme):
    """K13's pre route (fp32 A at K = 63, writing ``out`` and ``out_q``) is
    byte for byte the register-staged loop on the operands zero-padded to
    K = 128 (the same exact int32 sums, the same rescale and epilogue), its
    copy is ``quantize_act`` of its own output, and it is within the plain
    version's tolerance."""
    from dposer_tpu_torch.ops.cuda.quant import quantize_act
    a, wq, qinv, qs, tp, gamma, beta, qnext = _k13_pre_operands(dev, B, scheme, state, B + 5)
    K, N = a.shape[1], wq.shape[0]
    want = score_net.dense_gn_silu_int8_plain(a, wq, qinv, qs, tp, gamma, beta)
    out_q = torch.empty((B, N), dtype=torch.int8, device=dev)
    reset_launch_counts()
    out = score_net.dense_gn_silu_int8(a, wq, qinv, qs, tp, gamma, beta, qinv_next=qnext,
                                       out_q=out_q)
    a128 = torch.zeros(B, 128, device=dev)
    a128[:, :K] = a
    wq128 = torch.zeros(N, 128, dtype=torch.int8, device=dev)
    wq128[:, :K] = wq
    qinv128 = torch.zeros(128, device=dev)
    qinv128[:K] = qinv
    reg_q = torch.empty_like(out_q)
    reg = score_net.dense_gn_silu_int8(a128, wq128, qinv128, qs, tp, gamma, beta,
                                       qinv_next=qnext, out_q=reg_q)
    torch.cuda.synchronize()
    assert fused_em.route_counts()["dense_gn_silu_int8"] == _k13_routes(pre=1, register=1)
    assert torch.equal(out, reg) and torch.equal(out_q, reg_q)
    assert torch.equal(out_q, quantize_act(out, qnext).to(torch.int8))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("B", [1, 500, 1000, 1001])
def test_k13_pre_route_launch_info(dev, B):
    """K13's pre route: at most 128 registers a thread (two CTAs an SM by
    registers), no local memory (no spills); a grid that fits the SMs once
    (1 and 500 rows at N = 1024) reserves the shared memory that holds it to
    one CTA an SM, a larger one to two."""
    info = score_net.dense_gn_silu_int8_pre_launch_info(B, 1024)
    assert info["threads"] == 256 and info["registers"] <= 128, info
    assert info["local_bytes"] == 0, info
    one_wave = 16 * -(-B // 64) <= torch.cuda.get_device_properties(dev).multi_processor_count
    assert info["ctas_per_sm"] == (1 if one_wave else 2), info


@pytest.mark.parametrize("scheme", ["tensor", "channel"])
def test_k13_routes_a_forward(dev, scheme):
    """``network_hidden`` on int8 operands runs a forward as the pre layer on
    the pre route and the four K = 1024 layers on the Hopper int8 loop, and
    gives its plain version's activation within the layers' tolerance."""
    from dposer_tpu_torch.ops.cuda import quant
    model = _small_model(dev)
    sde = tsde.SubVPSDE(N=6)
    calib = quant.calibrate_act_amax_per_channel if scheme == "channel" else \
        quant.calibrate_act_amax
    amax = calib(sde, model, (64, 63), torch.Generator(device=dev).manual_seed(0), device=dev)
    net, _ = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", dev,
                                             quant="int8", act_amax=amax)
    rng = np.random.default_rng(4)
    B, H = 70, net["hidden"]
    x = _t(rng, (B, 63), dev, 2.0)
    h, h1 = torch.empty(B, H, device=dev), torch.empty(B, H, device=dev)
    reset_launch_counts()
    got = score_net.network_hidden(net, x, 3, h, h1)
    torch.cuda.synchronize()
    assert fused_em.route_counts()["dense_gn_silu_int8"] == _k13_routes(hopper=4, pre=1)
    want = score_net.network_hidden(net, x, 3, torch.empty_like(h), torch.empty_like(h1),
                                    layer=score_net.hidden_layer(net, plain=True))
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("B", [1, 500, 512])
@pytest.mark.parametrize("K", [128, 1024])
@pytest.mark.parametrize("update", [False, True])
def test_chain_link_int8_handoff(dev, B, K, update):
    """K14's int8 mode on an int8 ``a_q`` (the Hopper loop): an inner link
    writes only the next link's ``q(h)``, a last link the state and
    ``q(x_new)``; both bit-equal to the plain link."""
    from dposer_tpu_torch.ops.cuda import chain_link as cl
    rng = np.random.default_rng(B + K)
    N = 1024
    a_q, w = _int8(rng, (B, K), dev), _int8(rng, (N, K), dev, -30, 31)
    rows = cl.int8_rows(K, N, dev)
    qnext = torch.full((N,), cl.INT8_QINV, device=dev)
    x = _t(rng, (B, N), dev) if update else None
    want_q = torch.empty((B, N), dtype=torch.int8, device=dev)
    want = cl.chain_link_plain_into(None, w, "int8", out=None if x is None else x.clone(),
                                    update=update, a_q=a_q, qinv_next=qnext, out_q=want_q,
                                    **rows)
    out_q = torch.empty_like(want_q)
    reset_launch_counts()
    got = cl.chain_link(None, w, "int8", out=x, update=update, a_q=a_q, qinv_next=qnext,
                        out_q=out_q, **rows)
    torch.cuda.synchronize()
    assert fused_em.route_counts()["chain_link"]["wgmma_int8"] == 1
    assert torch.equal(out_q, want_q)
    if update:
        assert got is x and torch.equal(x, want)
    else:
        assert got is out_q


def test_int8_chain_with_handoff_matches_plain_chain(dev):
    """The microbenchmark's int8 chain (6 links, 5 steps, [512, 1024]) on the
    card against its plain chain: bit-equal states; one register-route link
    (the call's first), the rest on the Hopper loop."""
    from dposer_tpu_torch.benchmarks import mxu_micro
    from dposer_tpu_torch.ops.cuda import chain_link as cl
    x0, _, ws_i8 = mxu_micro.make_inputs(dev, mxu_micro.B, mxu_micro.H)
    rows = cl.int8_rows(mxu_micro.H, mxu_micro.H, dev)
    reset_launch_counts()
    got = cl.run_chain(x0.clone(), ws_i8, "int8", 5, **rows)
    torch.cuda.synchronize()
    assert fused_em.route_counts()["chain_link"] == {"wgmma": 0, "wgmma_int8": 29,
                                                      "register": 1}
    want = cl.run_chain(x0.clone(), ws_i8, "int8", 5, link=cl.chain_link_plain_into, **rows)
    assert torch.equal(got, want)


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
    # the pre layer on the fp32 state (the pre route), every later layer on
    # the int8 handoff
    assert fused_em.route_counts()["dense_gn_silu_int8"] == _k13_routes(hopper=4 * n, pre=n)
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


# ---------------------------------------------------------------------------
# the loops as CUDA graphs (ops/cuda/graph_loop.py) and the device seed
# ---------------------------------------------------------------------------

def _flagship_model(dev):
    torch.manual_seed(0)
    return ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=1024, embed_dim=512, n_blocks=2,
                        dropout=0.0).eval().to(dev)


# the sampling chains at the benchmark's shapes: generation at 500 rows and
# N = 1000 (bf16 and int8 per channel), the completion solver at 1,000 rows
# (100 poses x 10 hypotheses) and 2 x 100 Adam steps
FLAGSHIP_ROUTES = ["generation_500x1000", "int8ch_500x1000", "solver_1000x200"]
# the programmatic edges of a captured call: into each of a generation
# call's 6,000 launches (K1 x5 and K2 a step) but the first, and into each of
# a solve's 1,201 (K5 once, K1 x5 and K6 a step)
FLAGSHIP_EDGES = {"generation_500x1000": 5999, "solver_1000x200": 1201}


def _flagship_routes(dev, route):
    """``_graph_routes``' pair for a route of ``FLAGSHIP_ROUTES``."""
    model = _flagship_model(dev)
    sde = tsde.SubVPSDE(N=1000)
    kern = dict(rng_mode="kernel", device="cuda")
    if route == "solver_1000x200":
        shape = (1000, 63)
        rng = np.random.default_rng(62)
        obs = _t(rng, shape, dev, 0.3)
        mask = torch.ones(shape, device=dev)
        mask[:, 0:12] = 0.0

        def build(loop):
            return get_cuda_comp_solver(sde, model, shape, 100 * 63, iterations=2,
                                        steps_per_iter=100, loop=loop, **kern)

        return build, lambda fn, g, i: fn(g, obs * (1 + i), mask)
    shape, extra = (500, 63), {}
    if route == "int8ch_500x1000":
        from dposer_tpu_torch.ops.cuda import quant
        amax = quant.calibrate_act_amax_per_channel(
            sde, model, (256, 63), torch.Generator(device=dev).manual_seed(0), device=dev)
        extra = dict(quant="int8", act_amax=amax)

    def build(loop):
        return get_cuda_em_sampler(sde, model, shape, loop=loop, **extra, **kern)

    return build, lambda fn, g, i: fn(g)


def _graph_routes(dev, route):
    """``(build(loop) -> fn, call(fn, gen, i) -> output)`` of one graphed
    route at a small size (or, for ``FLAGSHIP_ROUTES``, at the benchmark's);
    call ``i`` takes other inputs than call ``i+1``."""
    if route in FLAGSHIP_ROUTES:
        return _flagship_routes(dev, route)
    model = _small_model(dev, scale_by_sigma=route not in ("ode", "likelihood"))
    shape, n = (70, 63), 20
    rng = np.random.default_rng(60)
    obs, z = _t(rng, shape, dev, 0.3), _t(rng, shape, dev)
    mask = torch.zeros(shape, device=dev)
    mask[:, 12:] = 1.0
    sde = tsde.SubVPSDE(N=n)
    kern = dict(rng_mode="kernel", device="cuda")
    if route in ("generation", "langevin", "imputation", "pf_euler"):
        kw = dict(corrector="langevin" if route == "langevin" else "none",
                  imputation=route == "imputation", probability_flow=route == "pf_euler",
                  eps=1e-5 if route == "pf_euler" else 1e-3, **kern)
        io = dict(observation=obs, mask=mask) if route == "imputation" else {}

        def build(loop):
            return get_cuda_em_sampler(sde, model, shape, loop=loop, **kw)

        return build, lambda fn, g, i: fn(g, z=z if route == "pf_euler" and i == 0 else None,
                                          **io)
    if route == "int8_mixed":
        from dposer_tpu_torch.ops.cuda import quant
        amax = quant.calibrate_act_amax(sde, model, (64, 63),
                                        torch.Generator(device=dev).manual_seed(0), device=dev)

        def build(loop):
            return get_cuda_em_sampler(sde, model, shape, quant="int8", act_amax=amax,
                                       bf16_tail_steps=5, loop=loop, **kern)

        return build, lambda fn, g, i: fn(g)
    if route == "solver":
        def build(loop):
            return get_cuda_comp_solver(tsde.SubVPSDE(N=1000), model, shape, 70 * 63,
                                        iterations=2, steps_per_iter=8, loop=loop, **kern)

        return build, lambda fn, g, i: fn(g, obs * (1 + i), mask)
    if route == "ode":
        def build(loop):
            return get_cuda_ode_sampler(tsde.SubVPSDE(N=1000), model, shape, n_steps=10,
                                        denoise=True, device="cuda", loop=loop)

        return build, lambda fn, g, i: fn(g)[1]

    def build(loop):
        return get_cuda_likelihood_fn(tsde.SubVPSDE(N=1000), model, shape, n_steps=10,
                                      device="cuda", loop=loop)

    return build, lambda fn, g, i: fn(g, obs * (1 + i))[:2]


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("route", ["generation", "langevin", "imputation", "pf_euler",
                                   "int8_mixed", "solver", "ode", "likelihood"]
                         + FLAGSHIP_ROUTES)
def test_graph_loop_equals_eager_loop(dev, route):
    """One CUDA graph a call (two for int8-mixed), bit-equal to the eager
    loop from the same generator state, with the same launch and route
    counts; a second call draws other normals (or takes other inputs) and
    returns tensors of its own."""
    build, call = _graph_routes(dev, route)
    eager, graph = build("eager"), build("graph")
    assert [lp.graph for lp in graph.loops] == [True] * (2 if route == "int8_mixed" else 1)
    assert not any(lp.graph for lp in eager.loops)
    results, counts = {}, {}
    for name, fn in (("eager", eager), ("graph", graph)):
        reset_launch_counts()
        out = _flat(call(fn, torch.Generator(device=dev).manual_seed(7), 0))
        torch.cuda.synchronize()
        results[name], counts[name] = out, (launch_counts(), fused_em.route_counts())
    assert all(torch.equal(a, b) for a, b in zip(results["graph"], results["eager"]))
    assert counts["graph"] == counts["eager"] and sum(counts["graph"][0].values()) > 0
    again = _flat(call(graph, torch.Generator(device=dev).manual_seed(8), 1))
    torch.cuda.synchronize()
    assert not torch.equal(again[0], results["graph"][0])
    assert again[0].data_ptr() != results["graph"][0].data_ptr()
    for lp in graph.loops:
        assert lp.capture_s > 0 and lp.instantiate_s > 0 and lp.launches


@pytest.mark.parametrize("route", FLAGSHIP_ROUTES)
def test_sampling_graphs_replay_bit_identically(dev, route):
    """The chains of programmatic launches (K1, K2, K5, K6, K13: each starts
    its prologue under the tail of the launch before it and waits for it
    before its first dependent read and its first write) at the benchmark's
    shapes: 50 replays from one generator state give the same bits, which a
    missing or misplaced wait would not."""
    build, call = _graph_routes(dev, route)
    fn = build("graph")
    first = _flat(call(fn, torch.Generator(device=dev).manual_seed(9), 0))
    for _ in range(49):
        again = _flat(call(fn, torch.Generator(device=dev).manual_seed(9), 0))
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    torch.cuda.synchronize()


@pytest.mark.parametrize("route", FLAGSHIP_ROUTES)
def test_sampling_graphs_hold_programmatic_edges(dev, route):
    """Every launch of the captured chain is programmatic
    (``programmatic_counts`` equals the launches of K1, K2, K5, K6 and K13),
    and the captured graph holds a programmatic edge into every one of them
    but the first, whose predecessor is the loop's reset of its state:
    read from the graph itself (``cuGraphGetEdges_v2``)."""
    build, call = _graph_routes(dev, route)
    fn = build("graph")
    reset_launch_counts()
    call(fn, torch.Generator(device=dev).manual_seed(3), 0)
    torch.cuda.synchronize()
    launched, programmatic = launch_counts(), fused_em.programmatic_counts()
    assert all(programmatic[k] == launched[k] for k in programmatic)
    n = sum(programmatic.values())
    assert n == sum(launched.values()) > 0
    (lp,) = fn.loops
    edges = lp.kernel_edges()
    assert n - 1 <= edges["programmatic"] <= n, edges
    if route in FLAGSHIP_EDGES:
        assert edges["programmatic"] == FLAGSHIP_EDGES[route], edges


def test_graph_loop_under_host_normals_replays_injected_noise(dev):
    """Under rng_mode="host" a replay needs noise=; with it the graph is the
    eager loop bit for bit."""
    model = _small_model(dev)
    n, shape = 20, (70, 63)
    rng = np.random.default_rng(61)
    z, noise = _t(rng, shape, dev), _t(rng, (n, 1) + shape, dev)
    sde = tsde.SubVPSDE(N=n)
    graph = get_cuda_em_sampler(sde, model, shape, device="cuda", loop="graph")
    with pytest.raises(ValueError):
        graph(torch.Generator(device=dev).manual_seed(1), z=z)
    eager = get_cuda_em_sampler(sde, model, shape, device="cuda")
    assert not eager.loops[0].graph
    assert torch.equal(graph(z=z, noise=noise), eager(z=z, noise=noise))


@pytest.mark.parametrize("kernel", ["head_em", "head_em_impute", "langevin_update",
                                    "masked_renoise", "comp_perturb", "head_adam_perturb"])
def test_seed_in_device_memory_draws_the_ints_normals(dev, kernel):
    """K2-K5 and K6's perturbing instantiation read the seed from device
    memory: the seed as an int and as the one-element int64 tensor (here one
    at and above 2**63, negative as int64) give the same bits, and a
    changed tensor draws other normals."""
    seed = 2 ** 63 + 12345
    h, w_post, b_post, coefs, x, _ = _head(dev, B=70)
    score = x.flip(1).contiguous()
    sq = (score * score).sum(1)
    obs, mask = x.flip(0).contiguous(), (x > 0).float()

    def run(s):
        xs, other = x.clone(), torch.zeros_like(x)
        if kernel == "head_em":
            head_em(h, w_post, b_post, coefs, 2, "em", x=xs, seed=s, slab=1)
        elif kernel == "head_em_impute":
            head_em(h, w_post, b_post, coefs, 2, "em", x=xs, seed=s, observed=(obs, mask),
                    renoise_next=0)
        elif kernel == "langevin_update":
            langevin_update(xs, score, sq, coefs, 1, 0.16, seed=s)
        elif kernel == "masked_renoise":
            masked_renoise(xs, obs, mask, coefs, 2, seed=s, slab=2)
        elif kernel == "comp_perturb":
            comp_perturb(xs, other, coefs, 2, seed=s)
        else:
            m1, v = torch.zeros_like(x), torch.ones_like(x)
            head_adam_perturb(h, w_post, b_post, coefs, 2, xs, other, obs, mask, m1, v, seed=s)
        return xs, other

    t = fused_em.seed_tensor(seed, dev)
    assert int(t) < 0
    want, got = run(seed), run(t)
    t.fill_(77)
    changed = run(t)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not all(torch.equal(a, b) for a, b in zip(changed, want))
