"""The bf16 handoff of the likelihood's layers, on the CPU: each K7 layer's
epilogue also writes its out and dout rounded to bf16, and the next layer
reads those copies instead of rounding the fp32 ones.

The product rounds its inputs to bf16 either way, so every check of the
handoff here is bit equality against the route without it: K7's plain
version and wrapper on CPU tensors, ``network_hidden_jvp``, K9's plain
version fed bf16-rounded rows, and the whole plain likelihood loop; that loop
is also held to the TPU kernel in interpret mode at the bounds of
``tests/test_torch_likelihood.py``. On the card the same dataflow runs K7's
Hopper route (TMA, ``wgmma``, split-K over a cluster) and K9 over a cluster
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.ops.pallas.fused_lik import get_pallas_likelihood_fn
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.ops.cuda import fused_em, fused_lik, fused_ode, score_net
from dposer_tpu_torch.ops.cuda.fused_ode import STAGE_GRID

from test_torch_model import SMALL, flax_and_torch

DIM = 63
KEY = jax.random.PRNGKey(1)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Tiny tensors: one thread is the fastest way through the small calls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))


def _layer_operands(K, N=128, B=9, seed=3):
    rng = np.random.default_rng(seed)
    a, da = _t(rng, (B, K)), _t(rng, (B, K))
    w = _t(rng, (K, N), K ** -0.5).to(torch.bfloat16)
    tp, gamma, beta = (_t(rng, (N,)) for _ in range(3))
    res, dres = _t(rng, (B, N)), _t(rng, (B, N))
    return a, da, w, tp, gamma, beta, res, dres


def _copies(B, N):
    return tuple(torch.empty((B, N), dtype=torch.bfloat16) for _ in range(2))


@pytest.mark.parametrize("layer", ["pre", "block", "block_residual_in_place"])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_k7_with_handoff_is_bit_equal(layer, fn):
    """K7 on CPU tensors with the bf16 copies: the pre layer (fp32 input at K =
    63) writes the copies of what it stores; a block layer reads ``a_b``,
    ``da_b`` (``a``, ``da`` not passed) and writes copies, also in place over
    the residual pair. The fp32 outputs equal the route without the handoff,
    bit for bit, and the copies are those outputs rounded to bf16."""
    K = 63 if layer == "pre" else 128
    a, da, w, tp, gamma, beta, res, dres = _layer_operands(K)
    with_res = layer == "block_residual_in_place"
    r = (res, dres) if with_res else (None, None)
    want = score_net.dense_gn_silu_jvp_plain(a, da, w, tp, gamma, beta, *r)
    B, N = a.shape[0], w.shape[1]
    ob, dob = _copies(B, N)
    kw = dict(out_b=ob, dout_b=dob)
    if layer != "pre":
        kw.update(a_b=a.to(torch.bfloat16), da_b=da.to(torch.bfloat16))
        a = da = None
    if with_res:
        kw.update(out=res, dout=dres)
    f = score_net.dense_gn_silu_jvp_plain_into if fn == "plain" else score_net.dense_gn_silu_jvp
    fused_em.reset_launch_counts()
    out, dout = f(a, da, w, tp, gamma, beta, *r, **kw)
    assert torch.equal(out, want[0]) and torch.equal(dout, want[1])
    assert torch.equal(ob, want[0].to(torch.bfloat16))
    assert torch.equal(dob, want[1].to(torch.bfloat16))
    if with_res:
        assert out is res and dout is dres
    assert fused_em.route_counts()["dense_gn_silu_jvp"] == {"wgmma": 0, "register": 0}


def _net(hidden, n_steps=3):
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=hidden, embed_dim=64,
                         n_blocks=2, dropout=0.0, scale_by_sigma=False).eval()
    net, _ = fused_ode.build_rk4_operands(tsde.SubVPSDE(N=1000), model, 1e-3, 1.0, n_steps,
                                          "cpu")
    return net


def _hidden_jvp_rounding_each_input(net, x, dx, i):
    """The hidden activation and its tangent as the layers computed them
    before the handoff: each layer rounds its own fp32 inputs."""
    tp, gs, gb, W = net["tp_all"][i], net["gn_scale"], net["gn_bias"], net["W"]
    f = score_net.dense_gn_silu_jvp_plain
    h, dh = f(x, dx, W[0], tp[0], gs[0], gb[0])
    for blk in range(net["n_blocks"]):
        j = 1 + 2 * blk
        h1, dh1 = f(h, dh, W[j], tp[j], gs[j], gb[j])
        h, dh = f(h1, dh1, W[j + 1], tp[j + 1], gs[j + 1], gb[j + 1], h, dh)
    return h, dh, h1, dh1


@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("layer", ["plain", "wrapper"])
def test_network_hidden_jvp_with_handoff_is_bit_equal(hidden, layer):
    """``network_hidden_jvp`` hands the activations on in bf16 (through the
    last four of its eight buffers): at every grid row the same h and dh as
    the layers rounding their fp32 inputs, bit for bit. The last block writes
    no copy, so the copies hold the first block's h and dh and the last
    block's h1 and dh1, rounded."""
    net = _net(hidden)
    B = 12
    rng = np.random.default_rng(5)
    bufs = score_net.hidden_jvp_buffers(net, B, "cpu")
    assert [(t.dtype, tuple(t.shape)) for t in bufs] == \
        [(torch.float32, (B, hidden))] * 4 + [(torch.bfloat16, (B, hidden))] * 4
    fn = (score_net.dense_gn_silu_jvp_plain_into if layer == "plain"
          else score_net.dense_gn_silu_jvp)
    for i in range(net["tp_all"].shape[0]):
        x, dx = _t(rng, (B, DIM), 2.0), torch.sign(_t(rng, (B, DIM)))
        ref = _hidden_jvp_rounding_each_input(net, x, dx, i)
        h, dh = score_net.network_hidden_jvp(net, x, dx, i, bufs, fn)
        assert h is bufs[0] and dh is bufs[1]
        assert torch.equal(h, ref[0]) and torch.equal(dh, ref[1])
        assert torch.equal(bufs[6], ref[2].to(torch.bfloat16))
        assert torch.equal(bufs[7], ref[3].to(torch.bfloat16))


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("H", [128, 192])
def test_k9_takes_bf16_rows_bit_equal(stage, H):
    """K9 rounds h and dh to bf16 in its product, so rows rounded before it
    give the same bits, in its plain version and through its wrapper, at a
    depth the card splits over clusters of 8 (128) and one it splits over
    clusters of 4 (192)."""
    rng = np.random.default_rng(30 + stage)
    B, D = 10, DIM
    h, dh = _t(rng, (B, H)), _t(rng, (B, H))
    w_post = torch.zeros(H, score_net.HEAD_COLS)
    w_post[:, :D] = _t(rng, (H, D), H ** -0.5)
    w_post = w_post.to(torch.bfloat16)
    b_post = torch.zeros(score_net.HEAD_COLS)
    b_post[:D] = _t(rng, (D,))
    coefs = torch.from_numpy(rng.uniform(-1, 1, size=(5, fused_ode.N_COEFS)).astype(np.float32))
    x, xs, acc, eps = (_t(rng, (B, D)) for _ in range(4))
    lp, lacc = _t(rng, (B,)), _t(rng, (B,))
    want = fused_lik.head_rk4_jvp_plain(h, dh, w_post, b_post, coefs, 2, stage, x, xs, acc,
                                        eps, lp, lacc)
    rounded = fused_lik.head_rk4_jvp_plain(h.to(torch.bfloat16).float(),
                                           dh.to(torch.bfloat16).float(), w_post, b_post,
                                           coefs, 2, stage, x, xs, acc, eps, lp, lacc)
    assert all(torch.equal(p, q) for p, q in zip(want, rounded))
    st = [t.clone() for t in (x, xs, acc, lp, lacc)]
    fused_lik.head_rk4_jvp(h, dh, w_post, b_post, coefs, 2, stage, *st[:3], eps, *st[3:])
    assert all(torch.equal(p, q) for p, q in zip(st, want))
    assert fused_em.launch_counts()["head_rk4_jvp"] == 0


def _likelihood_without_handoff(ts, tm, shape, n_steps, eps, data, epsv):
    """The kernel likelihood's plain loop with every layer rounding its own
    fp32 inputs (the loop before the handoff)."""
    net, coefs = fused_ode.build_rk4_operands(ts, tm, eps, ts.T, n_steps, "cpu")
    x, e = data.clone(), epsv
    xs, acc = x.clone(), torch.empty_like(x)
    lp, lacc = torch.zeros(shape[0]), torch.empty(shape[0])
    for i in range(n_steps):
        for s in range(4):
            j = 2 * i + STAGE_GRID[s]
            h, dh, _, _ = _hidden_jvp_rounding_each_input(net, xs, e, j)
            fused_lik.head_rk4_jvp_plain_into(h, dh, net["w_post"], net["b_post"], coefs, j, s,
                                              x, xs, acc, e, lp, lacc)
    return lp, x


def test_likelihood_with_handoff_matches_pallas_interpret():
    """The whole plain likelihood loop, handing the activations on in bf16:
    its z and Delta-logp bit-equal to the loop without the handoff, and its z
    and bits/dim against the TPU kernel in interpret mode at the size and
    bounds of tests/test_torch_likelihood.py (3e-2*max(1, |z|) for z, 0.1
    bits/dim)."""
    shape, n_steps, eps = (8, DIM), 25, 1e-4
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=False))
    js, ts = jsde.SubVPSDE(N=100), tsde.SubVPSDE(N=100)
    data = (0.5 * np.random.default_rng(1).normal(size=shape)).astype(np.float32)
    epsv = np.array(jax.random.rademacher(KEY, shape, jnp.float32))
    bpd_ref, z_ref, _ = get_pallas_likelihood_fn(js, fm, params, shape, n_steps=n_steps,
                                                 eps=eps, interpret=True)(KEY, jnp.asarray(data))
    fused_em.reset_launch_counts()
    bpd, z, nfe = fused_lik.get_cuda_likelihood_fn(ts, tm, shape, n_steps=n_steps, eps=eps,
                                                   device="cpu", plain=True)(
        None, torch.from_numpy(data), epsilon=torch.from_numpy(epsv))
    assert nfe == 4 * n_steps
    z_ref = np.asarray(z_ref)
    scale = max(1.0, float(np.abs(z_ref).max()))
    np.testing.assert_allclose(z.numpy(), z_ref, atol=3e-2 * scale)
    np.testing.assert_allclose(bpd.numpy(), np.asarray(bpd_ref), atol=0.1)
    lp_old, z_old = _likelihood_without_handoff(ts, tm, shape, n_steps, eps,
                                                torch.from_numpy(data), torch.from_numpy(epsv))
    assert torch.equal(z, z_old)
    assert torch.equal(bpd, fused_lik.bits_per_dim(ts, z_old, lp_old))
    assert sum(fused_em.launch_counts().values()) == 0


def _misaligned_bf16(shape):
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=torch.bfloat16)[1:1 + n].view(shape)


@pytest.mark.parametrize("case", ["misaligned_a_b", "a_b_float", "a_b_without_da_b",
                                  "out_b_without_dout_b", "out_b_float", "misaligned_w",
                                  "depth_not_whole_boxes", "depth_no_cluster_cuts",
                                  "depth_past_8_slices"])
def test_k7_handoff_validation_errors(case):
    """K7's handoff operands that the Hopper route cannot take raise before any
    launch, on the CPU as on the card: ``a_b`` or ``w`` that TMA cannot
    address (a misaligned pointer), ``a_b`` of the wrong type, the copies
    apart, and a depth that no cluster of 1, 2, 4 or 8 CTAs cuts into whole
    64-deep boxes at most 256 deep (K = 96; 576, nine boxes; 4096)."""
    K = {"depth_not_whole_boxes": 96, "depth_no_cluster_cuts": 576,
         "depth_past_8_slices": 4096}.get(case, 128)
    a, da, w, tp, gamma, beta, res, dres = _layer_operands(K)
    B, N = a.shape[0], w.shape[1]
    kw = dict(a_b=a.to(torch.bfloat16), da_b=da.to(torch.bfloat16))
    if case == "misaligned_a_b":
        kw["a_b"] = _misaligned_bf16((B, K))
        assert kw["a_b"].data_ptr() % 16 and kw["a_b"].is_contiguous()
    elif case == "a_b_float":
        kw["a_b"] = a
    elif case == "a_b_without_da_b":
        del kw["da_b"]
    elif case == "out_b_without_dout_b":
        kw["out_b"] = _copies(B, N)[0]
    elif case == "out_b_float":
        kw.update(out_b=torch.empty(B, N), dout_b=torch.empty(B, N))
    elif case == "misaligned_w":
        w = _misaligned_bf16(tuple(w.shape)).copy_(w)
        assert w.data_ptr() % 16 and w.is_contiguous()
    with pytest.raises(TypeError if case.endswith("float") else ValueError):
        score_net.dense_gn_silu_jvp(a, da, w, tp, gamma, beta, res, dres, **kw)


@pytest.mark.parametrize("H", [96, 1088, 1152])
def test_k9_depth_validation_errors(H):
    """K9 splits H over clusters of 8 or 4 CTAs into whole 16-deep slices, so
    H is a multiple of 64 and at most 1024: other depths (96; 1088 and 1152,
    multiples of 64 and 128 past 1024) raise on the CPU as on the card."""
    rng = np.random.default_rng(7)
    B, D = 4, DIM
    h = _t(rng, (B, H))
    w_post = torch.zeros(H, score_net.HEAD_COLS, dtype=torch.bfloat16)
    coefs = torch.zeros(3, fused_ode.N_COEFS)
    x = _t(rng, (B, D))
    lp = torch.zeros(B)
    with pytest.raises(ValueError):
        fused_lik.head_rk4_jvp(h, h.clone(), w_post, torch.zeros(score_net.HEAD_COLS), coefs,
                               0, 0, x, x.clone(), x.clone(), x.clone(), lp, lp.clone())


def test_default_cluster_sizes():
    """K7's Hopper route splits K = 1024 over 4 CTAs of 256, other depths over
    the fewest CTAs whose slices are whole 64-deep boxes at most 256 deep, and
    takes no depth that no such cluster cuts."""
    ks = (64, 128, 192, 256, 384, 512, 1024, 2048, 96, 576, 4096)
    assert [score_net.jvp_cluster(k) for k in ks] == [1, 1, 1, 1, 2, 2, 4, 8, None, None, None]
