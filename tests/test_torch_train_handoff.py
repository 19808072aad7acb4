"""The bf16 handoff of the train step's layers, on the CPU: every K10 layer
after the pre one reads the stash the layer before wrote (its output rounded
to the compute dtype) instead of rounding that layer's fp32 output itself,
a block's first layer and the last layer write no fp32 output, and K11
reads the last layer's stash instead of its fp32 output.

The product rounds its inputs to the compute dtype either way, so every
check of the handoff here is bit equality against the dataflow without it:
K10's plain version and wrapper on CPU tensors, and the whole plain-route
step (loss and every gradient); the fp32 route is also held to the TPU train
kernel in interpret mode at the bounds of ``tests/test_torch_train_kernel.py``.
On the card the same dataflow runs K10's Hopper route (TMA and ``wgmma`` from
the stash), K12 on the same loop and K11's bf16 instantiation of the
cluster head (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from dposer_tpu.diffusion.sde import SubVPSDE as JSubVP
from dposer_tpu.models import ScoreModelFC as FlaxScoreModelFC
from dposer_tpu.ops.pallas.fused_train import get_pallas_train_loss_and_grad
from dposer_tpu_torch.diffusion.sde import SubVPSDE
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.ops.cuda import fused_em, fused_train as ft
from dposer_tpu_torch.utils.checkpoint import state_dict_from_flax

from test_torch_train_kernel import flax_layout, jax_tz, leaf_pairs

B, D, H = 24, 63, 128


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Tiny tensors: one thread is the fastest way through the small calls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(K, dtype, seed=3, N=H, rows=B):
    g = torch.Generator().manual_seed(seed)

    def rn(*s, sc=1.0):
        return sc * torch.randn(*s, generator=g)

    return (rn(rows, K), rn(K, N, sc=K ** -0.5).to(dtype), rn(rows, N, sc=0.3).to(dtype),
            1 + 0.1 * rn(N), 0.1 * rn(N), rn(rows, N))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", ["block", "block_no_out", "block_residual_in_place"])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_k10_with_stash_is_bit_equal(dtype, layer, fn):
    """K10 reading ``a_b`` (``a`` rounded to the weights' dtype, ``a`` not
    passed) against K10 rounding ``a`` itself: the same out, stash, xhat and
    rstd bit for bit, through the plain version and through the wrapper on
    CPU tensors; also in place over the residual, and without the fp32 out
    (then None). The CPU run takes no route of the card."""
    a, w, proj, gamma, beta, res = _layer(H, dtype)
    with_res = layer == "block_residual_in_place"
    want = ft.dense_gn_silu_train_plain(a, w, proj, gamma, beta, 11, 3, 0.9,
                                        res if with_res else None)
    kw = dict(a_b=a.to(dtype))
    if with_res:
        kw.update(residual=res, out=res)
    if layer == "block_no_out":
        kw["write_out"] = False
    f = ft.dense_gn_silu_train_plain_into if fn == "plain" else ft.dense_gn_silu_train
    fused_em.reset_launch_counts()
    got = f(None, w, proj, gamma, beta, 11, 3, 0.9, **kw)
    if layer == "block_no_out":
        assert got[0] is None
    else:
        assert torch.equal(got[0], want[0])
    if with_res:
        assert got[0] is res
    for g, r in zip(got[1:], want[1:]):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert fused_em.route_counts()["dense_gn_silu_train"] == {"wgmma": 0, "register": 0}


def test_plain_stash_is_its_own_tensor():
    """At fp32 the stash equals out but is another tensor, so a block's
    in-place update of out leaves the stash the weight gradients read."""
    a, w, proj, gamma, beta, res = _layer(H, torch.float32)
    out, stash, _, _ = ft.dense_gn_silu_train_plain(a, w, proj, gamma, beta, 1, 0, 1.0, res)
    assert torch.equal(out, stash) and stash.data_ptr() != out.data_ptr()


class RoundingEachInput:
    """K10 and K11 as the step ran them before the handoff: every layer and
    the head round their own fp32 input, the fp32 output of the layer before
    (which it is handed here whether or not that layer was asked to write
    it)."""

    def __init__(self):
        self.prev = None
        self.bwd = ft.dense_gn_silu_bwd_plain_into

    def head(self, h, w_post, b_post, coefs, z):
        assert torch.equal(h, self.prev.to(w_post.dtype))  # the step hands over the stash
        return ft.head_dsm_plain(self.prev, w_post, b_post, coefs, z)

    def fwd(self, a, w, proj, gamma, beta, seed, layer, keep, residual=None, out=None,
            a_b=None, write_out=True):
        if a_b is not None:
            assert a is None and torch.equal(a_b, self.prev.to(w.dtype))
            a = self.prev
        res = ft.dense_gn_silu_train_plain(a, w, proj, gamma, beta, seed, layer, keep, residual)
        self.prev = res[0]
        return res if out is None else (out.copy_(res[0]),) + res[1:]


def _model(dropout=0.1):
    torch.manual_seed(0)
    return ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=H, embed_dim=32, n_blocks=1,
                        dropout=dropout)


def _noise(seed=1):
    g = torch.Generator().manual_seed(seed)
    return (0.3 * torch.randn(B, D, generator=g),
            dict(t=torch.rand(B, generator=g) * 0.9 + 0.05, z=torch.randn(B, D, generator=g),
                 dropout_seed=5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["plain", "wrapper"])
def test_step_with_handoff_is_bit_equal(monkeypatch, dtype, route):
    """The whole step (hidden 128, one block, dropout 0.1) through the plain
    versions with the handoff (K11 on the last layer's stash), and through
    the wrappers on CPU tensors, against the layers and the head rounding
    each input as before the handoff (K11 on the fp32 h): the same loss and
    every gradient, bit for bit, in fp32 and bf16."""
    model = _model()
    x, noise = _noise()
    sde = SubVPSDE(N=1000)
    before = RoundingEachInput()
    monkeypatch.setattr(ft, "PLAIN_LAYERS", SimpleNamespace(fwd=before.fwd, head=before.head,
                                                            bwd=before.bwd))
    ref_loss, ref = ft.get_cuda_train_loss_and_grad(sde, model, reduce_mean=True,
                                                    compute_dtype=dtype, plain=True)(x, **noise)
    monkeypatch.undo()
    loss, grads = ft.get_cuda_train_loss_and_grad(sde, model, reduce_mean=True,
                                                  compute_dtype=dtype,
                                                  plain=route == "plain")(x, **noise)
    assert torch.equal(loss, ref_loss)
    for n, g in grads.items():
        assert torch.equal(g, ref[n]), n


class RecordingLayers:
    """The plain layers, recording what each K10 call was asked to write and
    what K11 was handed."""

    def __init__(self):
        self.writes, self.head_in = [], None
        self.bwd = ft.dense_gn_silu_bwd_plain_into

    def fwd(self, *args, write_out=True, **kw):
        self.writes.append(write_out)
        return ft.dense_gn_silu_train_plain_into(*args, write_out=write_out, **kw)

    def head(self, h, *args):
        self.head_in = h
        return ft.head_dsm_plain(h, *args)


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_step_writes_no_fp32_out_for_the_head(monkeypatch, n_blocks):
    """Only the pre layer and the residual layers whose output the next
    block carries write fp32 outputs; the last layer writes its stash alone,
    and K11 is handed that stash (bf16)."""
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=H, embed_dim=32,
                         n_blocks=n_blocks, dropout=0.1)
    x, noise = _noise()
    rec = RecordingLayers()
    monkeypatch.setattr(ft, "PLAIN_LAYERS", rec)
    ft.get_cuda_train_loss_and_grad(SubVPSDE(N=1000), model, reduce_mean=True,
                                    plain=True)(x, **noise)
    assert rec.writes == [True] + [False, True] * (n_blocks - 1) + [False, False]
    assert rec.head_in.dtype == torch.bfloat16 and rec.head_in.shape == (B, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
@pytest.mark.parametrize("rows", [1, 17, B])
def test_head_dsm_on_stash_is_bit_equal(dtype, fn, rows):
    """K11 handed ``h`` rounded to the weights' dtype (the train step's
    stash) against K11 on fp32 ``h``: the same loss rows and dout bit for
    bit, through the plain version and through the wrapper on CPU tensors,
    at fp32 and bf16 weights."""
    g = torch.Generator().manual_seed(6)
    h = torch.randn(rows, H, generator=g)
    w_post = torch.zeros(H, 64)
    w_post[:, :D] = H ** -0.5 * torch.randn(H, D, generator=g)
    b_post = torch.zeros(64)
    b_post[:D] = torch.randn(D, generator=g)
    coefs = torch.stack([-torch.rand(rows, generator=g) - 0.1,
                         torch.rand(rows, generator=g) + 0.5,
                         torch.full((rows,), 1.0 / (D * rows))], 1)
    z = torch.randn(rows, D, generator=g)
    args = (w_post.to(dtype), b_post, coefs, z)
    f = ft.head_dsm_plain if fn == "plain" else ft.head_dsm
    fused_em.reset_launch_counts()
    want = f(h, *args)
    got = f(h.to(dtype), *args)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert fused_em.launch_counts()["head_dsm"] == 0  # the CPU takes no launch


@pytest.mark.parametrize("case", ["fp16", "bf16_h_fp32_weights", "shape", "meta"])
def test_head_dsm_operand_checks(case):
    """``h`` in a dtype that is neither fp32 nor the weights' (fp16; bf16
    beside fp32 weights) or of the wrong shape, or operands on the meta
    device, raise before any launch."""
    g = torch.Generator().manual_seed(8)
    h = torch.randn(B, H, generator=g)
    w_post = torch.zeros(H, 64, dtype=torch.bfloat16)
    args = [torch.zeros(64), torch.rand(B, 3, generator=g), torch.randn(B, D, generator=g)]
    err = TypeError
    if case == "fp16":
        h = h.half()
    elif case == "bf16_h_fp32_weights":
        h, w_post = h.bfloat16(), w_post.float()
    elif case == "shape":
        h, err = h.bfloat16()[:, :-1], ValueError
    else:
        h, w_post, err = h.bfloat16().to("meta"), w_post.to("meta"), ValueError
        args = [t.to("meta") for t in args]
    fused_em.reset_launch_counts()
    with pytest.raises(err):
        ft.head_dsm(h, w_post, *args)
    assert fused_em.launch_counts()["head_dsm"] == 0


def test_fp32_route_with_handoff_matches_jax():
    """The fp32 step with the handoff, through the plain versions and through
    the wrappers, against the TPU train kernel in interpret mode (fp32): loss
    to 1e-4 and every gradient leaf to 5e-4 relative, the bar of
    tests/test_torch_train_kernel.py."""
    kw = dict(n_poses=21, pose_dim=3, hidden_dim=H, embed_dim=32, n_blocks=1, dropout=0.0)
    fm = FlaxScoreModelFC(**kw)
    params = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, D)), jnp.ones((1,)))["params"]
    params = jax.tree.map(np.asarray, params)
    tm = ScoreModelFC(**kw)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    x = (0.3 * np.random.default_rng(1).normal(size=(32, D))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    l_ref, g_ref = get_pallas_train_loss_and_grad(
        JSubVP(N=1000), fm, reduce_mean=True, interpret=True,
        compute_dtype=jnp.float32)(params, key, jnp.asarray(x))
    t, z = jax_tz(key, JSubVP(N=1000))
    for plain in (True, False):
        loss, grads = ft.get_cuda_train_loss_and_grad(
            SubVPSDE(N=1000), tm, reduce_mean=True, compute_dtype=torch.float32,
            plain=plain)(torch.from_numpy(x), t=t, z=z, dropout_seed=0)
        np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-4)
        for name, r, g in leaf_pairs(g_ref, flax_layout(grads)):
            rel = np.linalg.norm(g - r) / (np.linalg.norm(r) + 1e-12)
            assert rel < 5e-4, f"{name}: relative error {rel}"


@pytest.mark.parametrize("case", ["dtype", "shape", "not_contiguous", "misaligned", "ragged_k",
                                  "out_without_write", "meta"])
def test_k10_stash_operand_checks(case):
    """Operands of the stash that K10's Hopper route cannot take raise
    before any launch, on every device: the weights' dtype, [B, K],
    contiguous, 16-byte aligned, K % 8 == 0; ``write_out=False`` takes no
    ``out``; a meta-device operand is neither the CPU nor a card."""
    K = 63 if case == "ragged_k" else H
    a, w, proj, gamma, beta, _ = _layer(K, torch.bfloat16)
    a_b = a.to(torch.bfloat16)
    kw = {}
    if case == "dtype":
        a_b = a
    elif case == "shape":
        a_b = a_b[:-1]
    elif case == "not_contiguous":
        a_b = torch.empty(K, B, dtype=torch.bfloat16).t()
    elif case == "misaligned":
        a_b = torch.empty(B * K + 1, dtype=torch.bfloat16)[1:].view(B, K)
    elif case == "out_without_write":
        kw = dict(write_out=False, out=torch.empty(B, H))
    elif case == "meta":
        meta = torch.device("meta")
        a_b, w, proj, gamma, beta = (t.to(meta) for t in (a_b, w, proj, gamma, beta))
    fused_em.reset_launch_counts()
    err = ValueError if case != "dtype" else TypeError
    with pytest.raises(err):
        ft.dense_gn_silu_train(None, w, proj, gamma, beta, 1, 1, 0.9, a_b=a_b, **kw)
    assert fused_em.launch_counts()["dense_gn_silu_train"] == 0


@pytest.mark.parametrize("case", ["dtype", "shape", "meta"])
def test_k12_operand_checks(case):
    """K12's operands in the wrong dtype or shape, or on the meta device,
    raise before any launch."""
    g = torch.Generator().manual_seed(4)
    args = [torch.randn(B, H, generator=g).to(torch.bfloat16),
            torch.randn(H, H, generator=g).to(torch.bfloat16),
            torch.randn(B, H, generator=g).to(torch.bfloat16), torch.rand(B, 32) + 0.5,
            torch.ones(H), torch.zeros(H)]
    if case == "dtype":
        args[0] = args[0].float()
    elif case == "shape":
        args[2] = args[2][:, :-1]
    else:
        args = [t.to("meta") for t in args]
    fused_em.reset_launch_counts()
    with pytest.raises(TypeError if case == "dtype" else ValueError):
        ft.dense_gn_silu_bwd(*args, 1, 2, 0.9)
    assert fused_em.launch_counts()["dense_gn_silu_bwd"] == 0


def test_train_route_counts_start_at_zero():
    """``route_counts`` names K10's two routes and K12's one, and
    ``reset_launch_counts`` sets them to 0."""
    ft.dense_gn_silu_train.routes["wgmma"] += 4
    ft.dense_gn_silu_bwd.routes["wgmma"] += 5
    fused_em.reset_launch_counts()
    routes = fused_em.route_counts()
    assert routes["dense_gn_silu_train"] == {"wgmma": 0, "register": 0}
    assert routes["dense_gn_silu_bwd"] == {"wgmma": 0}


@pytest.mark.parametrize("kernel", ["dense_gn_silu_train", "dense_gn_silu_bwd"])
def test_train_rings_variants_apply(kernel):
    """Every variant of ``benchmarks/train_rings.py`` still applies to the
    shipped sources (one substitution each, into the kernel's file or the
    loop's header), and the shipped variant is the source as it is."""
    from dposer_tpu_torch.benchmarks import train_rings
    from dposer_tpu_torch.ops.cuda import build

    shipped = (build.CSRC / f"{kernel}.cu").read_text()
    assert train_rings.variant_sources(kernel, "shipped") == {f"{kernel}.cu": shipped}
    for variant, subs in train_rings.VARIANTS.items():
        if not train_rings.applies(kernel, variant):
            continue
        files = train_rings.variant_sources(kernel, variant)
        for target, old, new in subs:
            name = f"{kernel}.cu" if target == "cu" else target
            assert old not in files[name] and new in files[name]
    assert train_rings.applies("dense_gn_silu_bwd", "K12's final sum unrolled by 8")
    assert not train_rings.applies("dense_gn_silu_train", "K12's final sum unrolled by 8")


@pytest.mark.parametrize("kernel", ["head_adam", "head_rk4", "head_dsm"])
def test_head_splits_variants_apply(kernel):
    """Every variant of ``benchmarks/head_splits.py`` still applies to the
    shipped sources of K6, K8 and K11 (one substitution each, into the kernel's
    file or the cluster head), and the shipped variant is the source as it
    is."""
    from dposer_tpu_torch.benchmarks import head_splits
    from dposer_tpu_torch.ops.cuda import build

    shipped = (build.CSRC / f"{kernel}.cu").read_text()
    assert head_splits.variant_sources(kernel, "shipped") == {f"{kernel}.cu": shipped}
    for variant, subs in head_splits.VARIANTS.items():
        files = head_splits.variant_sources(kernel, variant)
        for name, (old, new) in subs.items():
            if name in files:
                assert old not in files[name] and new in files[name]
        assert variant == "shipped" or len(files) > 1 or files[f"{kernel}.cu"] != shipped
