"""The int8 handoff of the port's int8 serving mode, on the CPU: each int8
layer's epilogue writes its output quantized by the next layer's ``qinv``
row, and the next layer reads that copy instead of quantizing the fp32 one.

The int32 sums and the quantized values are the same either way, so every
check here is bit equality against the route without the handoff: K13's
plain version, ``network_hidden`` on int8 operands, and the microbenchmark's
int8 chain (K14's plain version). The sampler's plain loop runs the handoff
too; ``tests/test_torch_quant.py`` holds it to the JAX int8 kernel in
interpret mode. On the card the same dataflow runs K13's and K14's Hopper
int8 loop (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from dposer_tpu_torch.benchmarks import mxu_micro
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.ops.cuda import chain_link as cl
from dposer_tpu_torch.ops.cuda import fused_em, quant, score_net

DIM = 63


def _t(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))


def _qinv_row(rng, n, scheme):
    """A per-tensor row (one value) or a per-channel row (one per column)."""
    if scheme == "tensor":
        return torch.full((n,), float(np.float32(127.0 / 3.1)))
    return torch.from_numpy(rng.uniform(10, 60, size=n).astype(np.float32))


def _k13_operands(scheme, K=128, N=128, B=9, seed=3):
    rng = np.random.default_rng(seed)
    a = _t(rng, (B, K))
    wq = torch.from_numpy(rng.integers(-127, 128, size=(N, K)).astype(np.int8))
    qinv = _qinv_row(rng, K, scheme)
    qs = torch.from_numpy(rng.uniform(1e-4, 1e-3, size=N).astype(np.float32))
    tp, gamma, beta = (_t(rng, (N,)) for _ in range(3))
    res = _t(rng, (B, N))
    return a, wq, qinv, qs, tp, gamma, beta, res, _qinv_row(rng, N, scheme)


@pytest.mark.parametrize("scheme", ["tensor", "channel"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_plain_k13_with_handoff_is_bit_equal(scheme, with_residual):
    """K13's wrapper on CPU tensors with ``a_q = q(a)`` (``a`` not passed)
    and ``out_q``: the same fp32 output as without them, bit for bit, and an
    ``out_q`` that is ``quantize_act`` of that output."""
    a, wq, qinv, qs, tp, gamma, beta, res, qnext = _k13_operands(scheme)
    res = res if with_residual else None
    want = score_net.dense_gn_silu_int8_plain_into(a, wq, qinv, qs, tp, gamma, beta, res)
    a_q = quant.quantize_act(a, qinv).to(torch.int8)
    out_q = torch.empty(want.shape, dtype=torch.int8)
    fused_em.reset_launch_counts()
    got = score_net.dense_gn_silu_int8(None, wq, qinv, qs, tp, gamma, beta, residual=res,
                                       a_q=a_q, qinv_next=qnext, out_q=out_q)
    assert torch.equal(got, want)
    assert torch.equal(out_q, quant.quantize_act(want, qnext).to(torch.int8))
    assert fused_em.route_counts()["dense_gn_silu_int8"] == {"wgmma_int8": 0, "pre_wgmma8": 0,
                                                              "register": 0}


def _misaligned(rows, cols):
    """A contiguous fp32 [rows, cols] view whose data starts 4 bytes past a
    16-byte boundary."""
    base = torch.empty(rows * cols + 16)
    skip = next(s for s in range(1, 16) if (base.data_ptr() + 4 * s) % 16 == 4)
    return base[skip:skip + rows * cols].view(rows, cols)


@pytest.mark.parametrize("case,want", [
    ("pre K=63", "pre_wgmma8"), ("pre K=63 misaligned", "pre_wgmma8"), ("K=64", "pre_wgmma8"),
    ("K=65", "register"), ("rot6d K=126", "register"), ("K=1024", "register"),
    ("K=1024 misaligned", "register"), ("int8 copy", "wgmma_int8")])
def test_k13_route_follows_the_operands(case, want):
    """K13's route is chosen by the operands: the int8 copy ``a_q`` takes the
    Hopper int8 loop, fp32 A at K <= 64 (the pre layer, whatever A's
    alignment) the pre route, any wider fp32 A the register-staged loop."""
    K = int(case.split("K=")[1].split()[0]) if "K=" in case else 1024
    a = _misaligned(70, K) if "misaligned" in case else torch.empty(70, K)
    assert (a.data_ptr() % 16 != 0) == ("misaligned" in case)
    a_q = torch.empty(70, K, dtype=torch.int8) if case == "int8 copy" else None
    assert score_net._k13_route(None if a_q is not None else a, a_q) == want


@pytest.mark.parametrize("variant", ["pre route", "two an SM", "register route"])
def test_k13_pre_variants_apply(variant):
    """Every K13 variant of ``benchmarks/k1_pre.py`` still applies to the
    shipped K13 source and changes only the lines it names; the pre route
    variant is the source as it is."""
    from dposer_tpu_torch.benchmarks import k1_pre
    from dposer_tpu_torch.ops.cuda import build

    shipped = (build.CSRC / "dense_gn_silu_int8.cu").read_text()
    assert set(k1_pre.K13_VARIANTS) == {"pre route", "two an SM", "register route"}
    text = k1_pre.variant_source(variant, "dense_gn_silu_int8")
    subs = k1_pre.K13_VARIANTS[variant]
    assert (text == shipped) == (not subs)
    for old, new in subs:
        assert old in shipped and old not in text and (not new or new in text)
    assert len(text.splitlines()) == len(shipped.splitlines()) - sum(
        old.count("\n") - new.count("\n") for old, new in subs)


def _int8_net(scheme, hidden=128, n=6, seed=0):
    torch.manual_seed(seed)
    model = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=hidden, embed_dim=64, n_blocks=2,
                         dropout=0.0).eval()
    sde = tsde.SubVPSDE(N=n)
    calib = (quant.calibrate_act_amax_per_channel if scheme == "channel"
             else quant.calibrate_act_amax)
    amax = calib(sde, model, (16, DIM), torch.Generator().manual_seed(1), device="cpu")
    net, _ = fused_em.build_sampler_operands(sde, model, 1e-3, "euler_maruyama", "cpu",
                                             quant="int8", act_amax=amax)
    return net


def _hidden_quantizing_each_input(net, x, i):
    """The hidden activation as the int8 layers computed it before the
    handoff: each layer quantizes its own fp32 input."""
    tp, gs, gb = net["tp_all"][i], net["gn_scale"], net["gn_bias"]
    f = score_net.dense_gn_silu_int8_plain
    h = f(x, *score_net.layer_weights(net, 0), tp[0], gs[0], gb[0])
    for blk in range(net["n_blocks"]):
        j = 1 + 2 * blk
        h1 = f(h, *score_net.layer_weights(net, j), tp[j], gs[j], gb[j])
        h = f(h1, *score_net.layer_weights(net, j + 1), tp[j + 1], gs[j + 1], gb[j + 1], h)
    return h, h1


@pytest.mark.parametrize("scheme", ["tensor", "channel"])
def test_network_hidden_with_handoff_is_bit_equal(scheme):
    """``network_hidden`` on int8 operands (the handoff, through the given
    buffers or its own) gives the hidden activation of the layers quantizing
    each fp32 input, bit for bit, at every step; the last block writes no
    copy, so ``q[1]`` holds the last block's h1 quantized."""
    net = _int8_net(scheme)
    B, H = 12, net["hidden"]
    rng = np.random.default_rng(5)
    q = score_net.handoff_buffers(net, B, "cpu")
    assert [(t.dtype, tuple(t.shape)) for t in q] == [(torch.int8, (B, H))] * 2
    for i in range(net["tp_all"].shape[0]):
        x = _t(rng, (B, DIM), 2.0)
        ref, ref_h1 = _hidden_quantizing_each_input(net, x, i)
        h, h1 = torch.empty(B, H), torch.empty(B, H)
        got = score_net.network_hidden(net, x, i, h, h1, q=q)
        assert got is h and torch.equal(h, ref) and torch.equal(h1, ref_h1)
        assert torch.equal(q[1], quant.quantize_act(h1, net["qinv_rows"][4]).to(torch.int8))
        assert torch.equal(score_net.network_hidden(net, x, i, torch.empty(B, H),
                                                    torch.empty(B, H)), ref)


@pytest.mark.parametrize("scheme", ["tensor", "channel"])
def test_plain_layers_take_the_handoff(scheme):
    """The plain layer ``pc_step(plain=True)`` runs, fed the handoff, against
    the same layer quantizing ``a`` itself, on each hidden layer's operands
    in turn: the same output, and an ``out_q`` that is the ``a_q`` the next
    layer would make."""
    net = _int8_net(scheme)
    B = 7
    rng = np.random.default_rng(6)
    x = _t(rng, (B, DIM), 2.0)
    tp, gs, gb = net["tp_all"][2], net["gn_scale"], net["gn_bias"]
    a = score_net.dense_gn_silu_int8_plain_into(x, *score_net.layer_weights(net, 0), tp[0],
                                                gs[0], gb[0])
    for j in range(1, 5):
        wq, qinv, qs = score_net.layer_weights(net, j)
        a_q = quant.quantize_act(a, qinv).to(torch.int8)
        want = score_net.dense_gn_silu_int8_plain_into(a, wq, qinv, qs, tp[j], gs[j], gb[j])
        out_q = torch.empty(want.shape, dtype=torch.int8)
        nxt = net["qinv_rows"][min(j + 1, 4)]
        got = score_net.dense_gn_silu_int8_plain_into(None, wq, qinv, qs, tp[j], gs[j], gb[j],
                                                      a_q=a_q, qinv_next=nxt, out_q=out_q)
        assert torch.equal(got, want)
        assert torch.equal(out_q, quant.quantize_act(want, nxt).to(torch.int8))
        a = want


def test_sampler_scratch_holds_the_int8_copies():
    """``pc_scratch`` gives int8 operands two int8 [B, H] buffers beside ``h``
    and ``h1``, and bf16 operands two bf16 ones."""
    net = _int8_net("tensor")
    s = fused_em.pc_scratch(net, 10, 0, "cpu")
    assert [(t.dtype, tuple(t.shape)) for t in s["q"]] == [(torch.int8, (10, 128))] * 2
    bf16 = dict(net)
    del bf16["Wq"]
    q = fused_em.pc_scratch(bf16, 10, 1, "cpu")["q"]
    assert [(t.dtype, tuple(t.shape)) for t in q] == [(torch.bfloat16, (10, 128))] * 2


def _old_int8_chain(x, ws, n_steps, rows):
    """The int8 chain as the links computed it before the handoff: each link
    quantizes its fp32 input itself."""
    for _ in range(n_steps):
        h = x
        for w in ws:
            h = cl.chain_link_plain(h, w, "int8", **rows)
        x = x * 0.5 + h * 1e-3
    return x


def _chain_inputs(B=16, H=64, seed=2):
    rng = np.random.default_rng(seed)
    x0 = _t(rng, (B, H))
    ws = [torch.from_numpy(np.clip(np.rint(rng.normal(size=(H, H)) * 127 / np.sqrt(H)), -127,
                                   127).astype(np.int8)) for _ in range(mxu_micro.CHAIN)]
    return x0, ws, cl.int8_rows(H, H, "cpu")


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("link", ["plain", "wrapper"])
def test_int8_chain_with_handoff_is_bit_equal(n_steps, link):
    """``run_chain`` in mode int8 (the links handing ``q(h)`` on, the last
    link ``q(x_new)``) against the chain whose links quantize their fp32
    inputs: bit-equal states; on CPU tensors the wrapper launches nothing."""
    x0, ws, rows = _chain_inputs()
    want = _old_int8_chain(x0.clone(), ws, n_steps, rows)
    fn = cl.chain_link_plain_into if link == "plain" else cl.chain_link
    fused_em.reset_launch_counts()
    got = cl.run_chain(x0.clone(), ws, "int8", n_steps, link=fn, **rows)
    assert torch.equal(got, want)
    assert fused_em.launch_counts()["chain_link"] == 0


def test_int8_chain_handoff_with_an_odd_chain():
    """An odd number of links: the last link's copy and the next step's first
    link never share a buffer."""
    x0, ws, rows = _chain_inputs(seed=4)
    want = _old_int8_chain(x0.clone(), ws[:3], 2, rows)
    got = cl.run_chain(x0.clone(), ws[:3], "int8", 2, link=cl.chain_link_plain_into, **rows)
    assert torch.equal(got, want)


def test_inner_int8_link_writes_only_its_copy():
    """K14's wrapper in mode int8 given ``a_q`` and ``out_q`` without ``out``:
    returns ``out_q``, which is ``q(h)`` of the plain link's fp32 ``h``."""
    x0, ws, rows = _chain_inputs()
    a_q = quant.quantize_act(x0, rows["qinv"]).to(torch.int8)
    out_q = torch.empty(x0.shape, dtype=torch.int8)
    got = cl.chain_link(None, ws[0], "int8", a_q=a_q, qinv_next=rows["qinv"], out_q=out_q,
                        **rows)
    h = cl.chain_link_plain(x0, ws[0], "int8", **rows)
    assert got is out_q
    assert torch.equal(out_q, quant.quantize_act(h, rows["qinv"]).to(torch.int8))


def _misaligned_int8(shape):
    buf = torch.zeros(int(np.prod(shape)) + 16, dtype=torch.int8)
    return buf[1:1 + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("case", ["misaligned_a_q", "a_q_k_not_16", "a_q_float",
                                  "out_q_without_qinv_next", "qinv_next_without_out_q",
                                  "out_q_float"])
def test_k13_handoff_validation_errors(case):
    """K13's int8 operands that the Hopper route cannot take raise before any
    launch, on the CPU as on the card: ``a_q`` that TMA cannot address (a
    misaligned pointer, K not a multiple of 16), of the wrong type; ``out_q``
    and ``qinv_next`` apart."""
    K = 63 if case == "a_q_k_not_16" else 128
    a, wq, qinv, qs, tp, gamma, beta, res, qnext = _k13_operands("channel", K=K)
    B, N = a.shape[0], wq.shape[0]
    kw = dict(a_q=quant.quantize_act(a, qinv).to(torch.int8))
    if case == "misaligned_a_q":
        kw["a_q"] = _misaligned_int8((B, K))
        assert kw["a_q"].data_ptr() % 16 and kw["a_q"].is_contiguous()
    elif case == "a_q_float":
        kw["a_q"] = kw["a_q"].float()
    elif case == "out_q_without_qinv_next":
        kw["out_q"] = torch.empty((B, N), dtype=torch.int8)
    elif case == "qinv_next_without_out_q":
        kw["qinv_next"] = qnext
    elif case == "out_q_float":
        kw.update(out_q=torch.empty((B, N)), qinv_next=qnext)
    with pytest.raises(TypeError if case.endswith("float") else ValueError):
        score_net.dense_gn_silu_int8(a, wq, qinv, qs, tp, gamma, beta, residual=res, **kw)


@pytest.mark.parametrize("case", ["misaligned_a_q", "a_q_in_bf16_mode", "out_q_in_bf16_mode",
                                  "out_q_without_qinv_next", "update_without_out"])
def test_k14_handoff_validation_errors(case):
    """K14's int8 handoff arguments raise where they do not fit: an ``a_q``
    TMA cannot address, ``a_q`` or ``out_q`` outside mode int8, ``out_q``
    without ``qinv_next``, an update with no state to update."""
    x0, ws, rows = _chain_inputs()
    a_q = quant.quantize_act(x0, rows["qinv"]).to(torch.int8)
    out_q = torch.empty(x0.shape, dtype=torch.int8)
    w16 = ws[0].float().t().contiguous().to(torch.bfloat16)
    with pytest.raises(ValueError):
        if case == "misaligned_a_q":
            cl.chain_link(None, ws[0], "int8", a_q=_misaligned_int8(tuple(x0.shape)), **rows)
        elif case == "a_q_in_bf16_mode":
            cl.chain_link(x0, w16, "bf16", a_q=a_q)
        elif case == "out_q_in_bf16_mode":
            cl.chain_link(x0, w16, "bf16", qinv_next=rows["qinv"], out_q=out_q)
        elif case == "out_q_without_qinv_next":
            cl.chain_link(None, ws[0], "int8", a_q=a_q, out_q=out_q, **rows)
        else:
            cl.chain_link(None, ws[0], "int8", a_q=a_q, update=True, qinv_next=rows["qinv"],
                          out_q=out_q, **rows)


def test_route_counts_start_at_zero():
    """``route_counts`` names K1's two routes, K7's two, K10's two, K12's
    one, K13's three and K14's three, and ``reset_launch_counts`` sets them
    to 0."""
    score_net.dense_gn_silu_int8.routes["register"] += 3
    score_net.dense_gn_silu_int8.routes["pre_wgmma8"] += 5
    score_net.dense_gn_silu_jvp.routes["wgmma"] += 2
    score_net.dense_gn_silu.routes["wgmma_bf16"] += 4
    fused_em.reset_launch_counts()
    assert fused_em.route_counts() == {
        "dense_gn_silu": {"wgmma_bf16": 0, "pre_wgmma": 0},
        "dense_gn_silu_jvp": {"wgmma": 0, "register": 0},
        "dense_gn_silu_train": {"wgmma": 0, "register": 0},
        "dense_gn_silu_bwd": {"wgmma": 0},
        "dense_gn_silu_int8": {"wgmma_int8": 0, "pre_wgmma8": 0, "register": 0},
        "chain_link": {"wgmma": 0, "wgmma_int8": 0, "register": 0}}


def test_int8_link_bound_follows_the_int8_bytes():
    """The microbenchmark's least time for an int8 link counts int8 in and out
    (fp32 in on a call's first link; the fp32 state read and written on an
    updating link): bytes bound at [512, 1024] x [1024, 1024]."""
    B, H, rate = mxu_micro.B, mxu_micro.H, mxu_micro.HBM_BYTES_PER_S
    inner = (B * H + H * H + B * H) / rate
    assert mxu_micro.link_bound_s("int8", B, H, H, False) == pytest.approx(inner, rel=1e-12)
    last = (B * H + H * H + B * H + 8 * B * H) / rate
    assert mxu_micro.link_bound_s("int8", B, H, H, True) == pytest.approx(last, rel=1e-12)
    first = (4 * B * H + H * H + B * H) / rate
    assert mxu_micro.link_bound_s("int8", B, H, H, False, first=True) == pytest.approx(first)
    assert mxu_micro.chain_bound_s("int8", 2) == pytest.approx(
        2 * (5 * inner + last) + first - inner)
