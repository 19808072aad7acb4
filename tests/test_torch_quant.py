"""The port's int8 serving mode against the JAX package's (W8A8 calibration,
per-tensor and per-channel scales, the bf16 tail).

On the CPU the kernel wrappers run their plain versions: K13's is held to
``bind_fwd``'s quant ``mm`` through the samplers, which are held to the TPU
kernel run in interpret mode (``get_pallas_em_sampler(interpret=True,
quant="int8")``) on the same weights, ranges, prior draw and normals. The
CUDA kernel itself is held to its plain version on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.diffusion import fast_sampler as jfs
from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.diffusion.few_step import get_pallas_ddim_sampler, get_pallas_hybrid_sampler
from dposer_tpu.ops.pallas import quant as jq
from dposer_tpu.ops.pallas.fused_em import get_pallas_em_sampler
from dposer_tpu.ops.pallas.score_net import \
    build_network_operands as jax_build_network_operands
from dposer_tpu_torch.diffusion import fast_sampler as tfs
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.few_step import (get_cuda_ddim_sampler,
                                                 get_cuda_hybrid_sampler)
from dposer_tpu_torch.ops.cuda import quant as tq
from dposer_tpu_torch.ops.cuda import score_net
from dposer_tpu_torch.ops.cuda.fused_em import (get_cuda_em_hypo_sampler, get_cuda_em_sampler,
                                                launch_counts, reset_launch_counts)

from test_torch_demo import _args, workdir  # noqa: F401  (the demo's tiny config)
from test_torch_model import SMALL, flax_and_torch
from test_torch_sampling import _injected

DIM = 63


@pytest.fixture(scope="module")
def models():
    """A flax ScoreModelFC (hidden 128, 2 blocks, sigma-scaled output) and the
    port's model holding the same weights."""
    return flax_and_torch(**dict(SMALL, scale_by_sigma=True))


def _obs_mask(shape, seed=4):
    rng = np.random.default_rng(seed)
    obs = (0.1 * rng.normal(size=shape)).astype(np.float32)
    mask = np.zeros(shape, np.float32)
    mask[:, 39:45] = 1.0
    return obs * mask, mask


def _jax_draws(shape, n, n_corr, seed):
    """The prior draw and the [N, K, B, D] normals JAX's calibration takes
    from ``PRNGKey(seed)``: ``fold_in(key, 2**31)`` for the prior,
    ``fold_in(fold_in(key, i), j)`` for corrector step j and ``fold_in(ki,
    7)`` for the predictor."""
    key = jax.random.PRNGKey(seed)
    z = jax.random.normal(jax.random.fold_in(key, 2 ** 31), shape)
    noise = []
    for i in range(n):
        ki = jax.random.fold_in(key, i)
        noise.append([jax.random.normal(jax.random.fold_in(ki, j), shape)
                      for j in range(n_corr)] + [jax.random.normal(jax.random.fold_in(ki, 7),
                                                                   shape)])
    return key, np.array(z), np.array(noise)


def _amax(models, scheme, n=8, batch=16, corrector="none", seed=2):
    """Calibrated ranges of the given scheme (the port's calibration)."""
    _, _, tm = models
    fn = tq.calibrate_act_amax_per_channel if scheme == "channel" else tq.calibrate_act_amax
    return fn(tsde.SubVPSDE(N=n), tm, (batch, DIM), torch.Generator().manual_seed(seed),
              corrector=corrector, margin=1.2, device="cpu")


# ---------------------------------------------------------------------------
# quantize_cols, smooth_fold, the amax forward, calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_cols", [0, 16])
def test_quantize_cols_bit_equal_to_jax(zero_cols):
    rng = np.random.default_rng(0)
    W = rng.normal(size=(40, 96)).astype(np.float32) * rng.uniform(0.01, 3, size=96)
    if zero_cols:
        W[:, -zero_cols:] = 0.0
    q, s = tq.quantize_cols(torch.from_numpy(W))
    jq_, js = jq.quantize_cols(jnp.asarray(W))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert np.all(q.numpy()[:, W.shape[1] - zero_cols:] == 0)
    # symmetric per-column int8: the error is at most half a step
    recon = q.float().numpy() * s.numpy()[None, :]
    assert np.all(np.abs(recon - W) <= 0.5 * np.maximum(s.numpy(), 1e-30)[None, :] + 1e-7)


def test_smooth_fold_bit_equal_to_jax_and_natural_order_fold():
    rng = np.random.default_rng(1)
    amax = rng.uniform(0.1, 100.0, size=DIM).astype(np.float32)
    W = rng.normal(size=(DIM, 128)).astype(np.float32)
    W[5] = 0.0  # a dead input row: excluded from the geometric mean
    for mine, theirs in zip(tq.smooth_fold(amax, W), jq.smooth_fold(amax, W)):
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(theirs))
    # the JAX build folds the pre layer padded to 128 zero rows with zero
    # ranges; the port folds the 63 real rows: the same fold
    a_pad = np.zeros(128, np.float32)
    a_pad[:DIM] = amax
    W_pad = np.zeros((128, 128), np.float32)
    W_pad[:DIM] = W
    inv, Wf, at = tq.smooth_fold(amax, W)
    inv_p, Wf_p, at_p = jq.smooth_fold(a_pad, W_pad)
    assert at == at_p
    np.testing.assert_array_equal(inv, inv_p[:DIM])
    np.testing.assert_array_equal(Wf, Wf_p[:DIM])
    assert not Wf_p[DIM:].any()


@pytest.mark.parametrize("per_channel", [False, True])
def test_amax_forward_matches_jax(models, per_channel):
    fm, params, tm = models
    js, ts = jsde.SubVPSDE(N=8), tsde.SubVPSDE(N=8)
    jlabels = jfs._labels_for(js, js.timesteps(1e-3))
    jt, jscale = jfs.precompute_time_tables(fm, params, jlabels)
    tt, tscale = tfs.precompute_time_tables(tm, torch.from_numpy(np.array(jlabels)))
    jfwd = jq._make_amax_forward(fm, params, jt, jscale, per_channel=per_channel)
    tfwd = tq._make_amax_forward(tm, tt, tscale, per_channel=per_channel)
    x = np.random.default_rng(2).normal(size=(10, DIM)).astype(np.float32)
    for i in (0, 3, 7):
        jout, jam = jfwd(jnp.asarray(x), i)
        with torch.no_grad():
            tout, tam = tfwd(torch.from_numpy(x), i)
        # fp32 both sides, the matmuls summed in another order; GroupNorm
        # divides small groups' differences by their std
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                                   atol=1e-4 * float(np.abs(jout).max()))
        jam = jam if per_channel else [jam]
        tam = tam if per_channel else [tam]
        for a, b in zip(tam, jam):
            # single elements after GroupNorm over groups of 4 features
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4)


@pytest.mark.parametrize("scale_by_sigma", [False, True])
@pytest.mark.parametrize("corrector", ["none", "langevin"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_calibration_matches_jax_on_its_draws(corrector, per_channel, scale_by_sigma):
    """The port's calibration fed JAX's own prior draw and normals gives
    JAX's ranges. The trajectory's matmuls are summed in another order, and on
    this untrained net the state grows to ~600 (to ~2.5e6 with sigma scaling,
    which both apply twice along the trajectory), so the per-tensor ranges
    agree to 2e-5 (measured 1.2e-5) and the per-channel ones, single elements
    after GroupNorm over groups of 4 features, to 5e-4 (measured 1.9e-4).
    Langevin needs N >= 20: below it the corrector's alpha turns negative, in
    JAX too."""
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=scale_by_sigma))
    n, shape = 20, (16, DIM)
    n_corr = 1 if corrector == "langevin" else 0
    key, z, noise = _jax_draws(shape, n, n_corr, seed=5)
    kw = dict(eps=1e-3, corrector=corrector, margin=1.1)
    jfn = jq.calibrate_act_amax_per_channel if per_channel else jq.calibrate_act_amax
    tfn = tq.calibrate_act_amax_per_channel if per_channel else tq.calibrate_act_amax
    ref = jfn(jsde.SubVPSDE(N=n), fm, params, shape, key, **kw)
    out = tfn(tsde.SubVPSDE(N=n), tm, shape, z=torch.from_numpy(z),
              noise=torch.from_numpy(noise), device="cpu", **kw)
    ref = ref if per_channel else [ref]
    out = out if per_channel else [out]
    assert len(out) == len(ref) == (6 if per_channel else 1)
    for a, b in zip(out, ref):
        assert a.dtype == np.float32 and a.shape == b.shape and np.all(a > 0)
        np.testing.assert_allclose(a, b, rtol=5e-4 if per_channel else 2e-5)


def test_calibration_draws_from_the_generator(models):
    _, _, tm = models
    a = _amax(models, "tensor", seed=3)
    b = _amax(models, "tensor", seed=3)
    c = _amax(models, "tensor", seed=4)
    assert a.shape == (tq.n_matmuls(tm),) and np.array_equal(a, b) and not np.array_equal(a, c)
    with pytest.raises(ValueError):
        tq.calibrate_act_amax(tsde.SubVPSDE(N=8), tm, (4, DIM), corrector="pc", device="cpu")


# ---------------------------------------------------------------------------
# the int8 operands and the int8 forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["tensor", "channel"])
def test_int8_operands_bit_equal_to_jax(models, scheme):
    """The JAX build with its matmul GroupNorm (identity permutation), its
    padded rows dropped: the same int8 weights, rescale rows and
    quantization rows, bit for bit."""
    fm, params, tm = models
    amax = _amax(models, scheme)
    js = jsde.SubVPSDE(N=8)
    jlabels = jfs._labels_for(js, js.timesteps(1e-3))
    net = score_net.build_network_operands(tm, torch.from_numpy(np.array(jlabels)), "cpu",
                                           quant="int8", act_amax=amax)
    jnet = jax_build_network_operands(fm, params, DIM, 128, jlabels, gn="mm", quant="int8",
                                      act_amax=amax)
    n_l = 1 + 2 * SMALL["n_blocks"]
    assert "W" not in net and len(net["Wq"]) == n_l
    assert net["Wq"][0].shape == (SMALL["hidden_dim"], DIM)  # [N, K]
    np.testing.assert_array_equal(net["Wq"][0].t().numpy(), np.asarray(jnet["Wpre"])[:DIM])
    assert not np.asarray(jnet["Wpre"])[DIM:].any()
    for mine, theirs in zip(net["Wq"][1:], jnet["Ws"]):
        np.testing.assert_array_equal(mine.t().numpy(), np.asarray(theirs))
    q = jnet["quant"]
    np.testing.assert_array_equal(net["qs"].numpy(), np.asarray(q["qs_h"])[:n_l])
    if scheme == "channel":
        np.testing.assert_array_equal(net["qinv"][0, :DIM].numpy(),
                                      np.asarray(q["qinv"])[0, :DIM])
        np.testing.assert_array_equal(net["qinv"][1:].numpy(), np.asarray(q["qinv"])[1:n_l])
    else:
        assert q["qinv"] is None
        for k, imm in enumerate(q["act_inv"]):
            assert np.all(net["qinv"][k].numpy() == np.float32(imm))
    np.testing.assert_array_equal(net["w_post"].float().numpy(),
                                  np.asarray(jnet["Wpost"], np.float32)[:, :64])


@pytest.mark.parametrize("scheme", ["tensor", "channel"])
def test_int8_forward_matches_jax_twin_at_every_step(models, scheme):
    """The port's plain int8 twin against JAX's ``make_fast_forward_int8`` at
    every step, and the kernel path (K13's plain version, bf16 head) against
    the twin. The twins agree to ~1e-5 of the scale, except where an
    activation on a quantization boundary rounds the other way under another
    fp32 summation order: one level of one input moves the row by ~3e-3 of
    the scale (measured), so 1e-2."""
    fm, params, tm = models
    amax = _amax(models, scheme)
    act_amax = list(amax) if scheme == "channel" else amax
    js = jsde.SubVPSDE(N=8)
    jlabels = jfs._labels_for(js, js.timesteps(1e-3))
    labels = torch.from_numpy(np.array(jlabels))
    jt, jscale = jfs.precompute_time_tables(fm, params, jlabels)
    tt, tscale = tfs.precompute_time_tables(tm, labels)
    jfwd = jq.make_fast_forward_int8(fm, params, jt, jscale, act_amax)
    tfwd = tq.make_fast_forward_int8(tm, tt, tscale, act_amax)
    net = score_net.build_network_operands(tm, labels, "cpu", quant="int8", act_amax=amax)
    x = np.random.default_rng(6).normal(size=(12, DIM)).astype(np.float32)
    xt = torch.from_numpy(x)
    h, h1 = torch.empty(12, SMALL["hidden_dim"]), torch.empty(12, SMALL["hidden_dim"])
    for i in range(8):
        ref = np.asarray(jfwd(jnp.asarray(x), i))
        out = tfwd(xt, i).numpy()
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(out, ref, atol=1e-2 * scale)
        score_net.network_hidden(net, xt, i, h, h1)
        kern = (h.to(torch.bfloat16).float() @ net["w_post"].float() + net["b_post"])[:, :DIM]
        kern = kern * net["out_scale"][i]
        np.testing.assert_allclose(kern.numpy(), ref, atol=2e-2 * scale)


def test_dense_gn_silu_int8_wrapper_on_cpu():
    """K13's wrapper on CPU tensors: the plain version, in place, no launch;
    malformed operands raise."""
    rng = np.random.default_rng(7)
    B, K, N = 6, 63, 64
    a = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, size=(N, K)).astype(np.int8))
    qinv = torch.from_numpy(rng.uniform(10, 40, size=K).astype(np.float32))
    qs, tp, gamma, beta = (torch.from_numpy(rng.normal(size=N).astype(np.float32))
                           for _ in range(4))
    res = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
    want = score_net.dense_gn_silu_int8_plain(a, wq, qinv, qs, tp, gamma, beta, res)
    # the exact int32 sums by hand: clamp(rint(a*qinv)) @ wq^T
    aq = np.clip(np.rint(a.numpy() * qinv.numpy()), -127, 127).astype(np.int64)
    acc = (aq @ wq.numpy().astype(np.int64).T).astype(np.float32)
    h = torch.from_numpy(acc) * qs + tp
    ref = torch.nn.functional.silu(tfs._group_norm(h, gamma, beta)) + res
    torch.testing.assert_close(want, ref, rtol=0, atol=0)
    reset_launch_counts()
    out = score_net.dense_gn_silu_int8(a, wq, qinv, qs, tp, gamma, beta, residual=res, out=res)
    assert out is res and torch.equal(res, want)
    assert launch_counts()["dense_gn_silu_int8"] == 0
    with pytest.raises(TypeError):
        score_net.dense_gn_silu_int8(a, wq.float(), qinv, qs, tp, gamma, beta)
    with pytest.raises(ValueError):
        score_net.dense_gn_silu_int8(a, wq.t().contiguous(), qinv, qs, tp, gamma, beta)


# ---------------------------------------------------------------------------
# the samplers against the TPU kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme,corrector,tail", [
    ("tensor", "none", 0), ("channel", "none", 0), ("tensor", "none", 3),
    ("channel", "none", 3), ("channel", "langevin", 0)])
def test_int8_sampler_matches_pallas_interpret(models, scheme, corrector, tail):
    """``get_cuda_em_sampler(quant="int8")`` (plain K13 and K2 on CPU
    tensors) against the TPU kernel's int8 branch in interpret mode, on the
    same ranges, z and noise, at the 2e-2 of the scale the JAX package
    holds its int8 kernel to its twin (tests/test_quant.py)."""
    fm, params, tm = models
    n, shape = 20, (8, DIM)
    amax = _amax(models, scheme, n=n)
    act_amax = list(amax) if scheme == "channel" else amax
    k = 2 if corrector == "langevin" else 1
    z, noise = _injected(shape, n, k, seed=17)
    kw = dict(eps=1e-3, corrector=corrector, snr=0.16, n_corrector_steps=1, quant="int8",
              act_amax=act_amax, bf16_tail_steps=tail)
    _, ref = get_pallas_em_sampler(jsde.SubVPSDE(N=n), fm, params, shape, interpret=True,
                                   rng_mode="host", **kw)(
        jax.random.PRNGKey(0), z=jnp.asarray(z), noise=jnp.asarray(noise))
    ref = np.asarray(ref)
    reset_launch_counts()
    out = get_cuda_em_sampler(tsde.SubVPSDE(N=n), tm, shape, device="cpu", **kw)(
        z=torch.from_numpy(z), noise=torch.from_numpy(noise))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2 * scale)
    assert sum(launch_counts().values()) == 0


def test_int8_hypo_sampler_with_bf16_tail_matches_pallas_interpret(models):
    fm, params, tm = models
    n, shape, hypo = 20, (4, DIM), 2
    amax = list(_amax(models, "channel", n=n))
    obs, mask = _obs_mask(shape)
    z, noise = _injected((hypo * shape[0], DIM), n, 3, seed=18)
    kw = dict(eps=1e-3, quant="int8", act_amax=amax, bf16_tail_steps=4)
    jref = get_pallas_em_sampler(jsde.SubVPSDE(N=n), fm, params, (hypo * shape[0], DIM),
                                 interpret=True, rng_mode="host", imputation=True, **kw)
    _, ref = jref(jax.random.PRNGKey(0), observation=jnp.tile(obs, (hypo, 1)),
                  mask=jnp.tile(mask, (hypo, 1)), z=jnp.asarray(z), noise=jnp.asarray(noise))
    ref = np.swapaxes(np.asarray(ref).reshape(hypo, shape[0], DIM), 0, 1)
    s = get_cuda_em_hypo_sampler(tsde.SubVPSDE(N=n), tm, shape, hypo, device="cpu", **kw)
    out = s(None, torch.from_numpy(obs), torch.from_numpy(mask), z=torch.from_numpy(z),
            noise=torch.from_numpy(noise))
    assert out.shape == (shape[0], hypo, DIM)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("imputation", [False, True])
def test_ddim_bf16_tail_matches_pallas_interpret(models, imputation):
    """The DDIM rows split into an int8 head and a bf16 tail (the overridden
    rows cut at ``n_rows - K``)."""
    fm, params, tm = models
    shape, n_steps, k_tail = (6, DIM), 8, 2
    amax = _amax(models, "channel", n=20)
    k = 3 if imputation else 1
    z, noise = _injected(shape, n_steps + 1, k, seed=19)
    obs, mask = _obs_mask(shape)
    jio = dict(observation=jnp.asarray(obs), mask=jnp.asarray(mask)) if imputation else {}
    tio = {k_: torch.from_numpy(np.array(v)) for k_, v in jio.items()}
    kw = dict(n_steps=n_steps, imputation=imputation, quant="int8", act_amax=list(amax),
              bf16_tail_steps=k_tail)
    nfe_ref, ref = get_pallas_ddim_sampler(jsde.SubVPSDE(N=1000), fm, params, shape,
                                           interpret=True, rng_mode="host", **kw)(
        jax.random.PRNGKey(0), z=jnp.asarray(z), noise=jnp.asarray(noise), **jio)
    nfe, out = get_cuda_ddim_sampler(tsde.SubVPSDE(N=1000), tm, shape, device="cpu", **kw)(
        z=torch.from_numpy(z), noise=torch.from_numpy(noise), **tio)
    assert nfe == nfe_ref == n_steps + 1
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("scheme", ["tensor", "channel"])
def test_hybrid_int8_matches_pallas_interpret(models, scheme):
    """The hybrid with ``quant`` passed to both builds (DDIM head and pc
    tail) against the JAX hybrid in interpret mode."""
    fm, params, tm = models
    n, shape, n_head, m_tail = 20, (6, DIM), 4, 5
    amax = _amax(models, scheme, n=n)
    act_amax = list(amax) if scheme == "channel" else amax
    obs, mask = _obs_mask(shape)
    zh, nh = _injected(shape, n_head, 3, seed=20)
    _, nt = _injected(shape, m_tail, 3, seed=21)
    kw = dict(n_head=n_head, m_tail=m_tail, tail_corrector="none", imputation=True,
              quant="int8", act_amax=act_amax)
    _, ref = get_pallas_hybrid_sampler(jsde.SubVPSDE(N=n), fm, params, shape, interpret=True,
                                       rng_mode="host", **kw)(
        jax.random.PRNGKey(0), observation=jnp.asarray(obs), mask=jnp.asarray(mask),
        z=jnp.asarray(zh), noise=(jnp.asarray(nh), jnp.asarray(nt)))
    nfe, out = get_cuda_hybrid_sampler(tsde.SubVPSDE(N=n), tm, shape, device="cpu", **kw)(
        observation=torch.from_numpy(obs), mask=torch.from_numpy(mask),
        z=torch.from_numpy(zh), noise=(torch.from_numpy(nh), torch.from_numpy(nt)))
    assert nfe == n_head + m_tail
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2 * max(1.0, float(np.abs(ref).max())))


def test_mixed_sampler_draws_what_the_full_run_draws(models):
    """Host normals from one generator: the int8 head and bf16 tail of the
    mixed schedule consume the generator as one full run does, so the mixed
    run equals the two parts run on the full run's draws."""
    _, _, tm = models
    n, shape, k_tail = 20, (5, DIM), 6
    amax = _amax(models, "tensor", n=n)
    ts = tsde.SubVPSDE(N=n)
    mixed = get_cuda_em_sampler(ts, tm, shape, device="cpu", quant="int8", act_amax=amax,
                                bf16_tail_steps=k_tail)(torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    z = ts.prior_sampling(shape, g, "cpu")
    noise = torch.stack([torch.randn((1,) + shape, generator=g) for _ in range(n)])
    head = get_cuda_em_sampler(ts, tm, shape, device="cpu", quant="int8", act_amax=amax,
                               denoise=False, step_range=(0, n - k_tail))
    tail = get_cuda_em_sampler(ts, tm, shape, device="cpu", step_range=(n - k_tail, n))
    want = tail(z=head(z=z, noise=noise[:n - k_tail]), noise=noise[n - k_tail:])
    assert torch.equal(mixed, want)


def test_build_validation_errors(models):
    _, _, tm = models
    ts = tsde.SubVPSDE(N=20)
    labels = torch.arange(20, dtype=torch.float32)
    amax = np.ones(6, np.float32)
    with pytest.raises(ValueError, match="act_amax"):
        score_net.build_network_operands(tm, labels, "cpu", quant="int8")
    with pytest.raises(ValueError, match="act_amax"):
        score_net.build_network_operands(tm, labels, "cpu", act_amax=amax)
    with pytest.raises(ValueError, match="quant"):
        score_net.build_network_operands(tm, labels, "cpu", quant="int4", act_amax=amax)
    with pytest.raises(ValueError, match="positive ranges"):
        score_net.build_network_operands(tm, labels, "cpu", quant="int8",
                                         act_amax=np.zeros(6, np.float32))
    with pytest.raises(ValueError, match="positive ranges"):
        score_net.build_network_operands(tm, labels, "cpu", quant="int8",
                                         act_amax=np.ones(5, np.float32))
    with pytest.raises(ValueError, match="per-channel act_amax must have"):
        score_net.build_network_operands(tm, labels, "cpu", quant="int8",
                                         act_amax=[np.ones(DIM, np.float32)])
    with pytest.raises(ValueError, match="requires quant='int8'"):
        get_cuda_em_sampler(ts, tm, (4, DIM), device="cpu", bf16_tail_steps=2)
    with pytest.raises(ValueError, match="bf16_tail_steps must be in"):
        get_cuda_em_sampler(ts, tm, (4, DIM), device="cpu", quant="int8", act_amax=amax,
                            bf16_tail_steps=20)
    with pytest.raises(ValueError, match="requires quant='int8'"):
        get_cuda_em_sampler(ts, tm, (4, DIM), device="cpu", quant="int8", act_amax=amax,
                            bf16_tail_steps=2, step_range=(0, 10))
    with pytest.raises(ValueError, match="requires quant='int8'"):
        get_cuda_ddim_sampler(ts, tm, (4, DIM), n_steps=8, device="cpu", bf16_tail_steps=2)
    with pytest.raises(ValueError, match="bf16_tail_steps must be in"):
        get_cuda_ddim_sampler(ts, tm, (4, DIM), n_steps=8, device="cpu", quant="int8",
                              act_amax=amax, bf16_tail_steps=9)


# ---------------------------------------------------------------------------
# the demo's --quant flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,scheme", [("int8", "channel"), ("int8-mixed", "tensor")])
def test_demo_generation_under_quant(workdir, capsys, quant, scheme):
    """Generation and ``--metrics`` under ``--quant``: one calibration per
    (eps, corrector, scheme), the line printed, finite samples and APD."""
    from dposer_tpu_torch import demo

    out = workdir["tmp"] / f"out_quant_gen_{quant}"
    res = demo.run(demo.parse_args(_args(
        workdir, out, "--metrics", "--smpl-path", workdir["smpl"], "--quant", quant,
        "--quant-scheme", scheme, "--quant-bf16-tail", "10")))
    text = capsys.readouterr().out
    for eps, corr in (("0.001", "none"), ("0.005", "langevin")):
        assert text.count(f"[quant] int8 ranges calibrated (eps={eps}, corrector={corr}, "
                          f"scheme={scheme}):") == 1, text
    with np.load(res["samples_file"]) as f:
        assert f["pose_samples"].shape == (50, DIM) and np.isfinite(f["pose_samples"]).all()
    assert np.isfinite(res["apd"]) and res["apd"] > 0


@pytest.mark.parametrize("quant,scheme,sampler", [
    ("int8", "channel", "pc"), ("int8-mixed", "channel", "ddim"),
    ("int8", "tensor", "hybrid")])
def test_demo_completion2_under_quant(workdir, capsys, quant, scheme, sampler):
    from dposer_tpu_torch import demo

    out = workdir["tmp"] / f"out_quant_c2_{sampler}"
    extra = {"pc": [], "ddim": ["--sampler-steps", "20"],
             "hybrid": ["--sampler-steps", "3", "--hybrid-tail", "5"]}[sampler]
    res = demo.run(demo.parse_args(_args(
        workdir, out, "--hypo", "2", "--file-path", workdir["poses"], "--bodymodel-path",
        workdir["smplx"], "--sampler", sampler, *extra, "--quant", quant, "--quant-scheme",
        scheme, task="completion2")))
    text = capsys.readouterr().out
    assert f"[quant] int8 ranges calibrated (eps=0.001, corrector=none, scheme={scheme}):" \
        in text
    assert f", {quant}" in text  # the sampler line names the mode
    with np.load(res["hypotheses_file"]) as f:
        assert f["pose_hypotheses"].shape == (8, 2, DIM)
        assert np.isfinite(f["pose_hypotheses"]).all()
    assert np.isfinite(res["mpjpe"]) and res["mpjpe"] > 0


@pytest.mark.parametrize("sampler", ["ddim", "hybrid"])
def test_demo_few_step_generation_under_quant(workdir, capsys, sampler):
    """``--sampler ddim|hybrid`` generation (a corrector-free config) under
    ``--quant int8-mixed``: DDIM keeps a bf16 tail of a tenth of its rows,
    the hybrid runs plain int8."""
    from dposer_tpu_torch import demo

    out = workdir["tmp"] / f"out_quant_fs_{sampler}"
    extra = ["--sampler-steps", "20"] + (["--hybrid-tail", "5"] if sampler == "hybrid" else [])
    res = demo.run(demo.parse_args(_args(workdir, out, "--sampler", sampler, *extra,
                                         "--quant", "int8-mixed")))
    text = capsys.readouterr().out
    assert "[quant] int8 ranges calibrated (eps=0.001, corrector=none, scheme=tensor):" in text
    assert (f"[sampler] kernel {'DDIM, 20 steps' if sampler == 'ddim' else 'hybrid DDIM-20'}"
            in text and ", int8-mixed" in text), text
    with np.load(res["samples_file"]) as f:
        assert f["pose_samples"].shape == (50, DIM) and np.isfinite(f["pose_samples"]).all()
