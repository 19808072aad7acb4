"""The bf16 handoff of K1's hidden layers, on the CPU: each layer's epilogue
writes its output rounded to bf16, and the next layer reads that copy
instead of rounding the fp32 one.

The copy is the rounding the next layer made of the fp32 output before, so
every check here is bit equality against the route without the handoff:
K1's plain version, ``network_hidden`` on bf16 operands, a plain generation
loop and a plain completion solve. ``handoff_buffers`` gives the layers
bf16 copies for bf16 operands and int8 ones for int8 operands (whose
handoff ``tests/test_torch_int8_handoff.py`` checks). On the card the same
dataflow runs K1's bf16 Hopper route (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.ops.cuda import fused_comp, fused_em, fused_ode, quant, score_net

DIM = 63


def _t(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))


def _k1_operands(K=128, N=128, B=9, seed=3):
    rng = np.random.default_rng(seed)
    a = _t(rng, (B, K))
    w = _t(rng, (K, N), K ** -0.5).to(torch.bfloat16)
    tp, gamma, beta = (_t(rng, (N,)) for _ in range(3))
    return a, w, tp, gamma, beta, _t(rng, (B, N))


@pytest.mark.parametrize("write_out", [True, False])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("wrapper", ["plain", "kernel"])
def test_k1_with_handoff_is_bit_equal(wrapper, with_residual, write_out):
    """K1 (its wrapper on CPU tensors, or its plain version) given ``a_b =
    bf16(a)`` (``a`` not passed) and ``out_b``: the same fp32 output as from
    fp32 ``a``, bit for bit, an ``out_b`` that is that output rounded to
    bf16, and with ``write_out=False`` that copy alone, returned."""
    a, w, tp, gamma, beta, res = _k1_operands()
    res = res if with_residual else None
    want = score_net.dense_gn_silu_plain_into(a, w, tp, gamma, beta, res)
    fn = score_net.dense_gn_silu if wrapper == "kernel" else score_net.dense_gn_silu_plain_into
    out_b = torch.empty(want.shape, dtype=torch.bfloat16)
    fused_em.reset_launch_counts()
    got = fn(None, w, tp, gamma, beta, res, a_b=a.to(torch.bfloat16), out_b=out_b,
             write_out=write_out)
    assert torch.equal(out_b, want.to(torch.bfloat16))
    if write_out:
        assert torch.equal(got, want)
    else:
        assert got is out_b
    assert fused_em.route_counts()["dense_gn_silu"] == {"wgmma_bf16": 0, "pre_wgmma": 0}


def _misaligned(rows, cols, dtype=torch.float32):
    """A contiguous [rows, cols] view whose data starts 4 bytes past a
    16-byte boundary."""
    base = torch.empty(rows * cols + 16, dtype=dtype)
    skip = next(s for s in range(1, 16) if (base.data_ptr() + s * base.element_size()) % 16 == 4)
    return base[skip:skip + rows * cols].view(rows, cols)


@pytest.mark.parametrize("case,want", [
    ("pre K=63", "pre_wgmma"), ("pre K=63 misaligned", "pre_wgmma"),
    ("K=64", "pre_wgmma"), ("rot6d K=126", ValueError), ("K=1024", ValueError),
    ("K=1024 misaligned", ValueError), ("K=63 W misaligned", ValueError),
    ("K=65", ValueError), ("K=128", ValueError), ("bf16 copy", "wgmma_bf16")])
def test_k1_route_follows_the_operands(case, want):
    """K1's route is chosen by the operands: fp32 A at K <= 64 (the pre
    layer, whatever A's alignment) with W 16-byte aligned takes the pre
    route, the bf16 copy the bf16 route. Any other fp32 A (K = 126, rot6d's
    pre layer; the K = 1024 layers; a misaligned W) has no route and raises,
    telling the caller to pass the bf16 copy."""
    K = int(case.split("K=")[1].split()[0]) if "K=" in case else 1024
    w_off = "W misaligned" in case
    a_off = "misaligned" in case and not w_off
    a = _misaligned(70, K) if a_off else torch.empty(70, K)
    w = _misaligned(K, 256, torch.bfloat16) if w_off else torch.empty(K, 256, dtype=torch.bfloat16)
    a_b = torch.empty(70, K, dtype=torch.bfloat16) if case == "bf16 copy" else None
    assert (a.data_ptr() % 16 != 0, w.data_ptr() % 16 != 0) == (a_off, w_off)
    if want is ValueError:
        with pytest.raises(ValueError, match="bf16 copy a_b"):
            score_net._k1_route(a, a_b, w)
    else:
        assert score_net._k1_route(a, a_b, w) == want


def _bf16_net(hidden=128, n=6, seed=0, n_blocks=2):
    torch.manual_seed(seed)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=hidden, embed_dim=64,
                         n_blocks=n_blocks, dropout=0.0).eval()
    net, _ = fused_em.build_sampler_operands(tsde.SubVPSDE(N=n), model, 1e-3,
                                             "euler_maruyama", "cpu")
    return model, net


def _hidden_rounding_each_input(net, x, i, h, h1, layer=None, q=None):
    """``network_hidden`` as it ran before the handoff: each layer rounds
    its own fp32 input, and a block's first layer writes fp32 ``h1``."""
    tp, gs, gb, W = net["tp_all"][i], net["gn_scale"], net["gn_bias"], net["W"]
    f = score_net.dense_gn_silu_plain_into
    f(x, W[0], tp[0], gs[0], gb[0], out=h)
    for blk in range(net["n_blocks"]):
        j = 1 + 2 * blk
        f(h, W[j], tp[j], gs[j], gb[j], out=h1)
        f(h1, W[j + 1], tp[j + 1], gs[j + 1], gb[j + 1], h, out=h)
    return h


@pytest.mark.parametrize("n_blocks", [1, 2])
@pytest.mark.parametrize("layer", ["default", "plain"])
def test_network_hidden_with_handoff_is_bit_equal(layer, n_blocks):
    """``network_hidden`` on bf16 operands (the handoff, through the given
    buffers or its own) gives the hidden activation of the layers rounding
    each fp32 input, bit for bit, at every step; the last block writes no
    copy, so ``q[1]`` holds the last block's first layer's output rounded."""
    _, net = _bf16_net(n_blocks=n_blocks)
    B, H = 12, net["hidden"]
    rng = np.random.default_rng(5)
    fn = None if layer == "default" else score_net.dense_gn_silu_plain_into
    q = score_net.handoff_buffers(net, B, "cpu")
    for i in range(net["tp_all"].shape[0]):
        x = _t(rng, (B, DIM), 2.0)
        ref, ref_h1 = torch.empty(B, H), torch.empty(B, H)
        _hidden_rounding_each_input(net, x, i, ref, ref_h1)
        h = torch.empty(B, H)
        got = score_net.network_hidden(net, x, i, h, torch.empty(B, H), fn, q)
        assert got is h and torch.equal(h, ref)
        assert torch.equal(q[1], ref_h1.to(torch.bfloat16))
        assert torch.equal(score_net.network_hidden(net, x, i, torch.empty(B, H),
                                                    torch.empty(B, H), fn), ref)


@pytest.mark.parametrize("plain", [True, False])
def test_generation_with_handoff_is_bit_equal(monkeypatch, plain):
    """The sampler's loop (its plain versions, or the wrappers on CPU
    tensors) with the handoff against the same loop whose layers round each
    fp32 input: the same samples, bit for bit, with the corrector too."""
    model, _ = _bf16_net()
    n, shape = 20, (10, DIM)  # finite with the corrector on an untrained net
    rng = np.random.default_rng(8)
    z, noise = _t(rng, shape), _t(rng, (n, 2) + shape)
    sde = tsde.SubVPSDE(N=n)

    def run():
        return fused_em.get_cuda_em_sampler(sde, model, shape, corrector="langevin",
                                            device="cpu", plain=plain)(z=z, noise=noise)

    got = run()
    monkeypatch.setattr(fused_em, "network_hidden", _hidden_rounding_each_input)
    want = run()
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.parametrize("plain", [True, False])
def test_completion_solve_with_handoff_is_bit_equal(monkeypatch, plain):
    """The completion solver's loop with the handoff against the same loop
    whose layers round each fp32 input: the same solve, bit for bit, and the
    solver's scratch holds the two bf16 copies."""
    model, _ = _bf16_net()
    rows, steps = 7, 6
    rng = np.random.default_rng(9)
    obs, noise = _t(rng, (rows, DIM), 0.3), _t(rng, (steps, rows, DIM))
    mask = torch.ones(rows, DIM)
    mask[:, :12] = 0.0
    sde = tsde.SubVPSDE(N=1000)

    def run():
        return fused_comp.get_cuda_comp_solver(sde, model, (rows, DIM), rows * DIM,
                                               iterations=2, steps_per_iter=3, device="cpu",
                                               plain=plain)(None, obs, mask, noise=noise)

    got = run()
    monkeypatch.setattr(fused_comp, "network_hidden", _hidden_rounding_each_input)
    want = run()
    assert torch.equal(got, want)
    _, net = _bf16_net()
    q = fused_comp.solver_scratch(net, rows, "cpu")["q"]
    assert [(t.dtype, tuple(t.shape)) for t in q] == [(torch.bfloat16, (rows, 128))] * 2


def test_ode_sampler_with_handoff_is_bit_equal(monkeypatch):
    """The RK4 PF-ODE sampler's loop with the handoff against the same loop
    whose layers round each fp32 input: the same samples, bit for bit."""
    model, _ = _bf16_net()
    shape = (5, DIM)
    z = _t(np.random.default_rng(10), shape)

    def run():
        return fused_ode.get_cuda_ode_sampler(tsde.SubVPSDE(N=1000), model, shape, n_steps=3,
                                              device="cpu", plain=True)(z=z)[1]

    got = run()
    monkeypatch.setattr(fused_ode, "network_hidden", _hidden_rounding_each_input)
    assert torch.equal(got, run())


@pytest.mark.parametrize("scheme", ["bf16", "int8"])
def test_handoff_buffers_follow_the_operands(scheme):
    """``handoff_buffers`` gives two [B, H] buffers: int8 for int8 operands,
    as the int8 handoff took them, and bf16 for bf16 ones."""
    _, net = _bf16_net()
    if scheme == "int8":
        net = dict(net, Wq=[])
    q = score_net.handoff_buffers(net, 11, "cpu")
    dtype = torch.int8 if scheme == "int8" else torch.bfloat16
    assert len(q) == 2 and q[0].data_ptr() != q[1].data_ptr()
    assert [(t.dtype, tuple(t.shape)) for t in q] == [(dtype, (11, 128))] * 2


def _misaligned_bf16(shape):
    buf = torch.zeros(int(np.prod(shape)) + 16, dtype=torch.bfloat16)
    return buf[1:1 + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("case", ["misaligned_a_b", "a_b_k_not_8", "a_b_float", "out_b_float",
                                  "no_out_b_without_out", "out_with_write_out_false"])
def test_k1_handoff_validation_errors(case):
    """K1's bf16 operands that its Hopper route cannot take raise before any
    launch, on the CPU as on the card: ``a_b`` that TMA cannot address (a
    misaligned pointer, K not a multiple of 8), of the wrong type; ``out_b``
    of the wrong type; ``write_out=False`` without ``out_b`` or with
    ``out``."""
    K = 60 if case == "a_b_k_not_8" else 128
    a, w, tp, gamma, beta, res = _k1_operands(K=K)
    B, N = a.shape[0], w.shape[1]
    kw = dict(a_b=a.to(torch.bfloat16))
    if case == "misaligned_a_b":
        kw["a_b"] = _misaligned_bf16((B, K))
        assert kw["a_b"].data_ptr() % 16 and kw["a_b"].is_contiguous()
    elif case == "a_b_float":
        kw["a_b"] = a
    elif case == "out_b_float":
        kw["out_b"] = torch.empty((B, N))
    elif case == "no_out_b_without_out":
        kw["write_out"] = False
    elif case == "out_with_write_out_false":
        kw.update(write_out=False, out=torch.empty((B, N)),
                  out_b=torch.empty((B, N), dtype=torch.bfloat16))
    fused_em.reset_launch_counts()
    with pytest.raises(TypeError if case.endswith("float") else ValueError):
        score_net.dense_gn_silu(None, w, tp, gamma, beta, residual=res, **kw)
    assert fused_em.launch_counts()["dense_gn_silu"] == 0


def test_int8_network_keeps_its_int8_handoff():
    """On int8 operands ``network_hidden`` hands on int8 copies as before:
    with the buffers it makes itself, the same hidden activation as through
    ``handoff_buffers``' int8 pair."""
    torch.manual_seed(0)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=128, embed_dim=64, n_blocks=2,
                         dropout=0.0).eval()
    sde = tsde.SubVPSDE(N=6)
    amax = quant.calibrate_act_amax(sde, model, (16, DIM), torch.Generator().manual_seed(1),
                                    device="cpu")
    net, _ = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", "cpu",
                                             quant="int8", act_amax=amax)
    B, H = 8, net["hidden"]
    x = _t(np.random.default_rng(4), (B, DIM), 2.0)
    q = score_net.handoff_buffers(net, B, "cpu")
    assert [t.dtype for t in q] == [torch.int8] * 2
    want = score_net.network_hidden(net, x, 2, torch.empty(B, H), torch.empty(B, H), q=q)
    got = score_net.network_hidden(net, x, 2, torch.empty(B, H), torch.empty(B, H))
    assert torch.equal(got, want)
    assert torch.equal(q[1], quant.quantize_act(
        score_net.dense_gn_silu_int8_plain(None, *score_net.layer_weights(net, 3),
                                           net["tp_all"][2, 3], net["gn_scale"][3],
                                           net["gn_bias"][3], a_q=q[0]),
        net["qinv_rows"][4]).to(torch.int8))


@pytest.mark.parametrize("variant", ["shipped", "the other wgmma pipeline depth",
                                     "12-stage deep ring", "6-stage ring, two CTAs an SM",
                                     "4-stage shallow ring"])
def test_k1_rings_variants_apply(variant):
    """Every variant of ``benchmarks/k1_rings.py`` still applies to the
    shipped K1 source, changing its ring lines and nothing else; the shipped
    variant is the source as it is."""
    from dposer_tpu_torch.benchmarks import k1_rings
    from dposer_tpu_torch.ops.cuda import build

    shipped = (build.CSRC / "dense_gn_silu.cu").read_text()
    assert set(k1_rings.VARIANTS) == {"shipped", "the other wgmma pipeline depth",
                                      "12-stage deep ring", "6-stage ring, two CTAs an SM",
                                      "4-stage shallow ring"}
    text = k1_rings.variant_source(variant)
    changed = [(a, b) for a, b in zip(shipped.splitlines(), text.splitlines()) if a != b]
    assert len(text.splitlines()) == len(shipped.splitlines())
    assert len(changed) == len(k1_rings.VARIANTS[variant])
    assert all("Ring<" in a and "Ring<" in b for a, b in changed)


@pytest.mark.parametrize("variant", ["shipped", "two an SM", "as registers allow",
                                     "16-byte loads"])
def test_k1_pre_variants_apply(variant):
    """Every variant of ``benchmarks/k1_pre.py`` still applies to the shipped
    K1 source and changes only the lines it names; the shipped variant is
    the source as it is."""
    from dposer_tpu_torch.benchmarks import k1_pre
    from dposer_tpu_torch.ops.cuda import build

    shipped = (build.CSRC / "dense_gn_silu.cu").read_text()
    assert set(k1_pre.VARIANTS) == {"shipped", "two an SM", "as registers allow",
                                    "16-byte loads"}
    text = k1_pre.variant_source(variant)
    subs = k1_pre.VARIANTS[variant]
    assert (text == shipped) == (not subs)
    for old, new in subs:
        assert old in shipped and old not in text and new in text
