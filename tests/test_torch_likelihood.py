"""The port's likelihood paths against the JAX package on the CPU: the
Hutchinson divergence, the fp32 fixed-grid and adaptive likelihoods, the
latent encoder, the hand-written tangents of K7 against ``torch.func.jvp``,
K9's plain version against the Pallas kernel's formulas, and the kernel
likelihood's plain loop against the Pallas kernel in interpret mode.

The Hutchinson probe is made by ``jax.random.rademacher`` in the test and
handed to both sides; weights cross through ``state_dict_from_flax``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.diffusion import likelihood as jlik
from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.diffusion.score_fn import get_score_fn as jax_get_score_fn
from dposer_tpu.ops.pallas.fused_lik import get_pallas_likelihood_fn
from dposer_tpu_torch.diffusion import likelihood as tlik
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.score_fn import get_score_fn
from dposer_tpu_torch.ops.cuda import fused_lik, fused_ode, score_net
from dposer_tpu_torch.ops.cuda.fused_em import launch_counts, reset_launch_counts
from dposer_tpu_torch.ops.cuda.fused_lik import get_cuda_likelihood_fn, head_rk4_jvp
from dposer_tpu_torch.ops.cuda.score_net import dense_gn_silu_jvp

from test_torch_kernels import _head_inputs, _k1_inputs, jax_mm
from test_torch_model import SMALL, flax_and_torch

SHAPE = (8, 63)
KEY = jax.random.PRNGKey(1)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """These tensors are tiny (8 rows, 128 features): one thread is the fastest
    way through the thousands of small calls, above all beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=False))
    return fm, params, tm


def _scores(fm, params, tm, **sde_kw):
    js, ts = jsde.SubVPSDE(N=100, **sde_kw), tsde.SubVPSDE(N=100, **sde_kw)
    jscore = jax_get_score_fn(js, lambda x, t: fm.apply({"params": params}, x, t),
                              continuous=True)
    return js, ts, jscore, get_score_fn(ts, tm, continuous=True)


def _data(seed=0, shape=SHAPE):
    data = (0.5 * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)
    epsv = np.array(jax.random.rademacher(KEY, shape, jnp.float32))
    return data, epsv


def test_div_fn_matches_jax(nets):
    js, ts, jscore, tscore = _scores(*nets)
    data, epsv = _data()
    jr, tr = (s.reverse_sde(f, probability_flow=True) for s, f in ((js, jscore), (ts, tscore)))
    for t in (1e-3, 0.1, 0.7):
        jd, jdiv = jlik.get_div_fn(lambda x, tt: jr(x, tt)[0])(
            jnp.asarray(data), jnp.full((8,), t), jnp.asarray(epsv))
        with torch.no_grad():
            td, tdiv = tlik.get_div_fn(lambda x, tt: tr(x, tt)[0])(
                torch.from_numpy(data), torch.full((8,), t), torch.from_numpy(epsv))
        # the time embedding's sin/cos of t*999 differ by ~1e-4 between the
        # frameworks (test_torch_model.py), and 1/std carries that to the drift
        jd, jdiv = np.asarray(jd), np.asarray(jdiv)
        np.testing.assert_allclose(td.numpy(), jd, atol=1e-4 * max(1.0, np.abs(jd).max()))
        # 63 such terms add up in the divergence
        np.testing.assert_allclose(tdiv.numpy(), jdiv, atol=5e-4 * max(1.0, np.abs(jdiv).max()))


@pytest.mark.parametrize("hutchinson_type", ["Rademacher", "Gaussian"])
def test_fast_likelihood_matches_jax(nets, hutchinson_type):
    fm, params, tm = nets
    js, ts, _, _ = _scores(*nets)
    data, epsv = _data(1)
    if hutchinson_type == "Gaussian":
        epsv = np.array(jax.random.normal(KEY, SHAPE, jnp.float32))
    bpd_ref, z_ref, nfe_ref = jlik.get_fast_likelihood_fn(
        js, fm, params, n_steps=25, hutchinson_type=hutchinson_type, eps=1e-4)(
        KEY, jnp.asarray(data))
    bpd, z, nfe = tlik.get_fast_likelihood_fn(ts, tm, n_steps=25, eps=1e-4)(
        None, torch.from_numpy(data), epsilon=torch.from_numpy(epsv))
    assert nfe == nfe_ref == 100
    # fp32 both sides, 100 chained jvp evaluations in another summation order
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-3)
    np.testing.assert_allclose(bpd.numpy(), np.asarray(bpd_ref), atol=2e-3)


def test_draw_epsilon():
    g = torch.Generator().manual_seed(3)
    e = tlik.draw_epsilon("Rademacher", (50, 63), g, "cpu")
    assert e.dtype == torch.float32 and set(e.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(e.mean())) < 0.1
    assert torch.equal(e, tlik.draw_epsilon("Rademacher", (50, 63),
                                            torch.Generator().manual_seed(3), "cpu"))
    n = tlik.draw_epsilon("Gaussian", (50, 63), g, "cpu")
    assert abs(float(n.std()) - 1.0) < 0.1
    with pytest.raises(NotImplementedError):
        tlik.draw_epsilon("Cauchy", (2, 3), g, "cpu")


def test_fast_likelihood_draws_its_probe_from_the_generator(nets):
    _, _, tm = nets
    fn = tlik.get_fast_likelihood_fn(tsde.SubVPSDE(N=100), tm, n_steps=3, eps=1e-2)
    data = torch.from_numpy(_data(2, (4, 63))[0])
    a = fn(torch.Generator().manual_seed(1), data)[0]
    assert torch.equal(a, fn(torch.Generator().manual_seed(1), data)[0])
    assert not torch.equal(a, fn(torch.Generator().manual_seed(2), data)[0])


def test_likelihood_fn_matches_jax(nets):
    """The adaptive oracle. sde.T is cut to 0.2: over the full span the
    untrained field amplifies the ulp differences of two adaptive runs beyond
    any useful bound, and the torch side's jvp costs ~20 ms a call here."""
    fm, params, tm = nets
    js, ts, jscore, tscore = _scores(fm, params, tm, T=0.2)
    data, epsv = _data(3, (4, 63))
    kw = dict(rtol=1e-4, atol=1e-4, eps=1e-2)
    bpd_ref, z_ref, nfe_ref = jlik.get_likelihood_fn(js, jscore, **kw)(KEY, jnp.asarray(data))
    bpd, z, nfe = tlik.get_likelihood_fn(ts, tscore, **kw)(
        None, torch.from_numpy(data), epsilon=torch.from_numpy(epsv))
    # two adaptive runs at rtol 1e-4 whose step sequences part after an ulp
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=3e-2)
    np.testing.assert_allclose(bpd.numpy(), np.asarray(bpd_ref), atol=5e-2)
    assert abs(nfe - int(nfe_ref)) <= 0.1 * int(nfe_ref) + 12
    # the bits/dim are finished from z and the integrated log-density change
    delta = -(bpd * math.log(2) * 63) - ts.prior_logp(z)
    np.testing.assert_allclose(tlik.bits_per_dim(ts, z, delta).numpy(), bpd.numpy(), rtol=1e-5)


def test_latent_encoder_matches_jax(nets):
    fm, params, tm = nets
    js, ts, jscore, tscore = _scores(fm, params, tm, T=0.5)
    data, _ = _data(4)
    z_ref, nfe_ref = jlik.get_latent_encoder(js, jscore, rtol=1e-5, atol=1e-5, eps=1e-2)(
        jnp.asarray(data))
    z, nfe = tlik.get_latent_encoder(ts, tscore, rtol=1e-5, atol=1e-5, eps=1e-2)(
        torch.from_numpy(data))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref),
                               atol=5e-3 * max(1.0, float(np.abs(z_ref).max())))
    assert abs(nfe - int(nfe_ref)) <= 0.1 * int(nfe_ref) + 12


@pytest.mark.parametrize("K", [63, 256])
@pytest.mark.parametrize("with_residual", [False, True])
def test_dense_gn_silu_jvp_plain_matches_autodiff(K, with_residual):
    """The tangent rules written out by hand against ``torch.func.jvp`` of
    the plain K1 layer: an independent check of dense, GN, SiLU and the skip."""
    B, N = 12, 128
    a, w, _, tp, gamma, beta, res = _k1_inputs(B, K, N, seed=20)
    rng = np.random.default_rng(21)
    # tangents that the bf16 rounding of the matmul input leaves unchanged
    da = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32)).to(torch.bfloat16).float()
    dres = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
    a, tp, gamma, beta, res = map(torch.from_numpy, (a, tp, gamma, beta, res))
    wf = w.float()

    def layer(av, rv):  # K1's plain layer without its (non-differentiable) rounding of a
        y = torch.nn.functional.silu(torch.nn.functional.group_norm(
            av @ wf + tp, 32, gamma, beta, eps=1e-5))
        return y + rv if with_residual else y

    a16 = a.to(torch.bfloat16).float()
    ref, dref = torch.func.jvp(layer, (a16, res), (da, dres))
    out, dout = score_net.dense_gn_silu_jvp_plain(
        a, da, w, tp, gamma, beta, *((res, dres) if with_residual else ()))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dout.numpy(), dref.numpy(), rtol=1e-4, atol=1e-4)
    # and the primal is K1's plain version
    k1 = score_net.dense_gn_silu_plain(a, w, tp, gamma, beta, res if with_residual else None)
    np.testing.assert_allclose(out.numpy(), k1.numpy(), rtol=1e-6, atol=1e-6)


def test_dense_gn_silu_jvp_wrapper_on_cpu():
    B, K, N = 6, 128, 64
    a, w, _, tp, gamma, beta, res = _k1_inputs(B, K, N, seed=22)
    a, tp, gamma, beta, res = map(torch.from_numpy, (a, tp, gamma, beta, res))
    da, dres = a.flip(0).contiguous(), res.flip(0).contiguous()
    want = score_net.dense_gn_silu_jvp_plain(a, da, w, tp, gamma, beta, res, dres)
    reset_launch_counts()
    out, dout = dense_gn_silu_jvp(a, da, w, tp, gamma, beta, residual=res, dresidual=dres,
                                  out=res, dout=dres)
    assert out is res and dout is dres  # in place, as the block's h + h2 and dh + dh2
    torch.testing.assert_close(res, want[0], rtol=0, atol=0)
    torch.testing.assert_close(dres, want[1], rtol=0, atol=0)
    fresh = dense_gn_silu_jvp(a, da, w, tp, gamma, beta)
    assert fresh[0].shape == fresh[1].shape == (B, N)
    assert launch_counts()["dense_gn_silu_jvp"] == 0
    with pytest.raises(ValueError):  # a residual without its tangent
        dense_gn_silu_jvp(a, da, w, tp, gamma, beta, residual=res)
    with pytest.raises(TypeError):
        dense_gn_silu_jvp(a, da.double(), w, tp, gamma, beta)
    with pytest.raises(ValueError):
        dense_gn_silu_jvp(a, da[:-1], w, tp, gamma, beta)


def _rk4_ref(stage, hstep, k, x, acc):
    """fused_ode.py:87-96 / fused_lik.py:91-102 stage by stage, in jnp."""
    if stage == 0:
        return x, k, x + 0.5 * hstep * k
    if stage in (1, 2):
        return x, acc + 2.0 * k, x + (0.5 if stage == 1 else 1.0) * hstep * k
    x = x + (hstep / 6.0) * (acc + k)
    return x, acc, x


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_head_rk4_jvp_matches_jax_formula(stage):
    """fused_lik.py:75-79 and its RK4 step on the same numbers."""
    h, w_post, w_vals, b_post, coefs, x, z = _head_inputs(seed=23)
    rng = np.random.default_rng(23)
    dh = rng.normal(size=h.shape).astype(np.float32)
    xs, acc = (rng.normal(size=x.shape).astype(np.float32) for _ in range(2))
    eps = np.sign(z).astype(np.float32)
    lp, lacc = (rng.normal(size=x.shape[0]).astype(np.float32) for _ in range(2))
    j, D = 3, x.shape[1]
    a1, a2, hstep = (jnp.float32(c) for c in coefs[j, :3])
    out = (jax_mm(h, w_vals) + b_post)[:, :D]
    dout = jax_mm(dh, w_vals)[:, :D]
    kx = a1 * xs + a2 * out
    kl = a1 * jnp.sum(eps * eps, axis=1) + a2 * jnp.sum(dout * eps, axis=1)
    x_ref, acc_ref, xs_ref = _rk4_ref(stage, hstep, kx, jnp.asarray(x), jnp.asarray(acc))
    lp_ref, lacc_ref, _ = _rk4_ref(stage, hstep, kl, jnp.asarray(lp), jnp.asarray(lacc))

    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        x=x, xs=xs, acc=acc, lp=lp, lacc=lacc).items()}
    head_rk4_jvp(torch.from_numpy(h), torch.from_numpy(dh), w_post, torch.from_numpy(b_post),
                 torch.from_numpy(coefs), j, stage, t["x"], t["xs"], t["acc"],
                 torch.from_numpy(eps), t["lp"], t["lacc"])
    for name, ref in (("x", x_ref), ("xs", xs_ref), ("acc", acc_ref), ("lp", lp_ref),
                      ("lacc", lacc_ref)):
        np.testing.assert_allclose(t[name].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4,
                                   err_msg=name)
    if stage < 3:
        np.testing.assert_array_equal(t["x"].numpy(), x)  # the step's start is kept
        np.testing.assert_array_equal(t["lp"].numpy(), lp)


def test_head_rk4_jvp_rejects_bad_operands():
    h, w_post, _, b_post, coefs, x, z = _head_inputs(seed=24)
    th, tb, tc, tx = map(torch.from_numpy, (h, b_post, coefs, x))
    lp = torch.zeros(x.shape[0])
    args = (tx, tx.clone(), tx.clone(), torch.from_numpy(z), lp, lp.clone())
    with pytest.raises(ValueError):  # K9 has no denoise stage
        head_rk4_jvp(th, th.clone(), w_post, tb, tc, 0, fused_ode.DENOISE, *args)
    with pytest.raises(ValueError):  # a grid row past the table
        head_rk4_jvp(th, th.clone(), w_post, tb, tc, coefs.shape[0], 0, *args)
    with pytest.raises(ValueError):  # the tangent must match the hidden state
        head_rk4_jvp(th, th[:, :-1].contiguous(), w_post, tb, tc, 0, 0, *args)
    with pytest.raises(ValueError):  # lp is [B]
        head_rk4_jvp(th, th.clone(), w_post, tb, tc, 0, 0, *args[:4], lp[:, None], lp.clone())


def test_kernel_likelihood_matches_pallas_interpret(nets):
    """The kernel likelihood's plain loop (plain K7 and K9 on CPU tensors)
    against the TPU kernel in interpret mode, same data and probe, at the
    bounds the JAX package holds its kernel to its fp32 path with
    (test_fast_ode.py: 3e-2*scale for z, 0.1 bits/dim), and against the port's
    fp32 path. On this untrained field some rows' bits/dim part by 0.2-0.6
    between any two of the bf16 and fp32 paths (the JAX kernel against its own
    fp32 path too); this seed's rows all stay inside JAX's limit."""
    fm, params, tm = nets
    js, ts, _, _ = _scores(*nets)
    data, epsv = _data(1)
    bpd_ref, z_ref, nfe_ref = get_pallas_likelihood_fn(
        js, fm, params, SHAPE, n_steps=25, eps=1e-4, interpret=True)(KEY, jnp.asarray(data))
    z_ref = np.asarray(z_ref)
    reset_launch_counts()
    fn = get_cuda_likelihood_fn(ts, tm, SHAPE, n_steps=25, eps=1e-4, device="cpu")
    bpd, z, nfe = fn(None, torch.from_numpy(data), epsilon=torch.from_numpy(epsv))
    assert nfe == nfe_ref == 100
    scale = max(1.0, float(np.abs(z_ref).max()))
    np.testing.assert_allclose(z.numpy(), z_ref, atol=3e-2 * scale)
    np.testing.assert_allclose(bpd.numpy(), np.asarray(bpd_ref), atol=0.1)
    bpd32, z32, _ = tlik.get_fast_likelihood_fn(ts, tm, n_steps=25, eps=1e-4)(
        None, torch.from_numpy(data), epsilon=torch.from_numpy(epsv))
    np.testing.assert_allclose(z.numpy(), z32.numpy(), atol=3e-2 * scale)
    np.testing.assert_allclose(bpd.numpy(), bpd32.numpy(), atol=0.1)
    # plain=True is the loop the wrappers run on CPU tensors; nothing launched
    plain = get_cuda_likelihood_fn(ts, tm, SHAPE, n_steps=25, eps=1e-4, device="cpu",
                                   plain=True)(None, torch.from_numpy(data),
                                               epsilon=torch.from_numpy(epsv))
    assert torch.equal(plain[0], bpd) and torch.equal(plain[1], z)
    assert sum(launch_counts().values()) == 0


def test_kernel_likelihood_probe_and_operand_checks(nets):
    _, _, tm = nets
    ts = tsde.SubVPSDE(N=100)
    fn = get_cuda_likelihood_fn(ts, tm, (4, 63), n_steps=2, eps=1e-2, device="cpu")
    data = torch.from_numpy(_data(6, (4, 63))[0])
    a = fn(torch.Generator().manual_seed(1), data)
    b = fn(torch.Generator().manual_seed(1), data)
    assert a[2] == 8 and torch.equal(a[0], b[0]) and torch.isfinite(a[0]).all()
    assert not torch.equal(a[0], fn(torch.Generator().manual_seed(2), data)[0])
    with pytest.raises(ValueError):
        fn(None, data[:3], epsilon=torch.ones(3, 63))
    with pytest.raises(ValueError):
        get_cuda_likelihood_fn(ts, tm, (4, 62), device="cpu")
    with pytest.raises(NotImplementedError):
        get_cuda_likelihood_fn(ts, tm, (4, 63), n_steps=2, hutchinson_type="Cauchy",
                               device="cpu")(None, data)
    assert fused_lik.head_rk4_jvp.launches == 0
