"""The port's reverse-diffusion kernels (K1 dense_gn_silu, K2 head_em,
K3 langevin_update, K4 masked_renoise), the completion kernels (K5
comp_perturb, K6 head_adam), the RK4 head (K8 head_rk4; K7 and K9 are in
test_torch_likelihood.py) and the kernel sampler.

On the CPU the wrappers run their plain PyTorch versions: those are held
to the JAX formulas of the Pallas kernel (``dposer_tpu/ops/pallas``), and
the kernel sampler to ``get_pallas_em_sampler(interpret=True)`` on the same
weights and injected noise. The CUDA kernels themselves are held to the
plain versions on the card by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.diffusion.fast_sampler import _group_norm as jax_group_norm
from dposer_tpu.diffusion.fast_sampler import _labels_for as jax_labels_for
from dposer_tpu.diffusion.few_step import get_pallas_ddim_sampler
from dposer_tpu.ops.pallas.fused_em import get_pallas_em_sampler
from dposer_tpu.ops.pallas.score_net import \
    build_network_operands as jax_build_network_operands
from dposer_tpu_torch.diffusion import fast_sampler as tfs
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.few_step import get_cuda_ddim_sampler
from dposer_tpu_torch.ops.cuda import fused_comp, fused_em, fused_ode, score_net
from dposer_tpu_torch.ops.cuda.fused_comp import comp_perturb, head_adam
from dposer_tpu_torch.ops.cuda.fused_em import (get_cuda_em_hypo_sampler,
                                                get_cuda_em_sampler, head_em,
                                                langevin_update, launch_counts,
                                                masked_renoise, reset_launch_counts)
from dposer_tpu_torch.ops.cuda.fused_ode import head_rk4
from dposer_tpu_torch.ops.cuda.score_net import (HEAD_COLS, dense_gn_silu,
                                                 network_hidden, network_hidden_jvp)

from test_torch_model import SMALL, flax_and_torch
from test_torch_sampling import _injected


def bf16(a):
    """numpy fp32 -> (torch bf16, numpy fp32 holding the same values)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t, t.float().numpy()


def jax_mm(a, w_vals):
    """The Pallas kernel's matmul: bf16 operands, fp32 accumulation."""
    return jnp.dot(jnp.asarray(a).astype(jnp.bfloat16),
                   jnp.asarray(w_vals).astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


def _k1_inputs(B, K, N, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, K)).astype(np.float32)
    w, w_vals = bf16(rng.normal(size=(K, N)) / np.sqrt(K))
    tp, gamma, beta, res = (rng.normal(size=s).astype(np.float32)
                            for s in ((N,), (N,), (N,), (B, N)))
    return a, w, w_vals, tp, gamma, beta, res


@pytest.mark.parametrize("K", [63, 256])
@pytest.mark.parametrize("with_residual", [False, True])
def test_dense_gn_silu_plain_matches_jax(K, with_residual):
    B, N = 12, 128
    a, w, w_vals, tp, gamma, beta, res = _k1_inputs(B, K, N)
    ref = jax.nn.silu(jax_group_norm(jax_mm(a, w_vals) + tp, gamma, beta))
    if with_residual:
        ref = ref + res
    out = score_net.dense_gn_silu_plain(
        torch.from_numpy(a), w, torch.from_numpy(tp), torch.from_numpy(gamma),
        torch.from_numpy(beta), torch.from_numpy(res) if with_residual else None)
    # same bf16 operands and fp32 sums in another order; GN divides by the
    # group std, which keeps the difference at fp32 rounding
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_dense_gn_silu_wrapper_on_cpu_writes_out_in_place():
    B, K, N = 6, 128, 64
    a, w, _, tp, gamma, beta, res = _k1_inputs(B, K, N, seed=1)
    a, tp, gamma, beta, res = map(torch.from_numpy, (a, tp, gamma, beta, res))
    want = score_net.dense_gn_silu_plain(a, w, tp, gamma, beta, res)
    reset_launch_counts()
    out = dense_gn_silu(a, w, tp, gamma, beta, residual=res, out=res)
    assert out is res  # out may alias the residual, as the block's h = h + h2
    torch.testing.assert_close(res, want, rtol=0, atol=0)
    assert launch_counts() == dict.fromkeys(
        ("dense_gn_silu", "head_em", "head_em_impute", "langevin_update", "masked_renoise",
         "comp_perturb", "head_adam", "head_adam_perturb", "dense_gn_silu_jvp", "head_rk4",
         "head_rk4_jvp", "dense_gn_silu_train", "head_dsm", "dense_gn_silu_bwd",
         "dense_gn_silu_int8", "chain_link"), 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_dense_gn_silu_wrapper_rejects_bad_operands(bad):
    B, K, N = 4, 64, 64
    a, w, _, tp, gamma, beta, _ = _k1_inputs(B, K, N, seed=2)
    a, tp, gamma, beta = map(torch.from_numpy, (a, tp, gamma, beta))
    if bad == "dtype":
        w = w.float()
    elif bad == "shape":
        tp = tp[:-1]
    else:
        a = torch.from_numpy(np.ones((K, B), np.float32)).t()
    with pytest.raises((TypeError, ValueError)):
        dense_gn_silu(a, w, tp, gamma, beta)


def test_k1_and_k14_wrappers_check_before_any_launch():
    """Operands on a device that is neither the CPU nor a card: both wrappers
    of the Hopper main loop raise after their checks, before any library is
    loaded or any kernel launched."""
    from dposer_tpu_torch.ops.cuda import chain_link as cl
    B, K, N = 4, 64, 64
    meta = torch.device("meta")
    a = torch.empty(B, K, device=meta)
    w = torch.empty(K, N, dtype=torch.bfloat16, device=meta)
    rows = [torch.empty(N, device=meta) for _ in range(3)]
    reset_launch_counts()
    with pytest.raises(ValueError, match="cpu or cuda"):
        dense_gn_silu(a, w, *rows)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cl.chain_link(a, w, "bf16")
    with pytest.raises(TypeError):  # the dtype check comes first
        dense_gn_silu(a, w.float(), *rows)
    assert launch_counts()["dense_gn_silu"] == launch_counts()["chain_link"] == 0


def test_tma_encodes_reads_the_library_counter(monkeypatch):
    """``build.tma_encodes`` reads the named library's count of tensor-map
    encodes as a 64-bit integer."""
    from dposer_tpu_torch.ops.cuda import build

    class Counter:
        argtypes = restype = None

        def __call__(self):
            return 2 ** 40 + 6

    class Lib:
        dposer_tma_encodes = Counter()

    loaded = []
    monkeypatch.setattr(build, "load", lambda name: loaded.append(name) or Lib)
    assert build.tma_encodes("dense_gn_silu") == 2 ** 40 + 6
    assert loaded == ["dense_gn_silu"]
    assert Lib.dposer_tma_encodes.restype is ctypes.c_longlong
    assert Lib.dposer_tma_encodes.argtypes == []


def _head_inputs(B=10, H=128, D=63, n_steps=5, seed=3):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, H)).astype(np.float32)
    w_post = np.zeros((H, HEAD_COLS), np.float32)
    w_post[:, :D] = rng.normal(size=(H, D)) / np.sqrt(H)
    w_post, w_vals = bf16(w_post)
    b_post = np.zeros(HEAD_COLS, np.float32)
    b_post[:D] = rng.normal(size=D)
    coefs = rng.uniform(0.1, 1.5, size=(n_steps, fused_em.N_COEFS)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    z = rng.normal(size=(B, D)).astype(np.float32)
    return h, w_post, w_vals, b_post, coefs, x, z


def test_head_em_matches_jax_formula():
    h, w_post, w_vals, b_post, coefs, x, z = _head_inputs()
    step, D = 2, x.shape[1]
    res = (jax_mm(h, w_vals) + b_post)[:, :D]
    cf = coefs[step]
    x_mean_ref = cf[0] * x + cf[1] * res
    x_new_ref = x_mean_ref + cf[2] * z
    score_ref = cf[3] * res

    th, tb, tc = torch.from_numpy(h), torch.from_numpy(b_post), torch.from_numpy(coefs)
    tx, x_mean = torch.from_numpy(x.copy()), torch.empty(x.shape)
    head_em(th, w_post, tb, tc, step, "em", x=tx, x_mean=x_mean,
            noise=torch.from_numpy(z))
    np.testing.assert_allclose(x_mean.numpy(), np.asarray(x_mean_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(x_new_ref), rtol=1e-5, atol=1e-5)

    score, score_sq = torch.empty(x.shape), torch.empty(x.shape[0])
    head_em(th, w_post, tb, tc, step, "score", score=score, score_sq=score_sq)
    np.testing.assert_allclose(score.numpy(), np.asarray(score_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(score_sq.numpy(),
                               np.asarray(jnp.sum(score_ref * score_ref, axis=1)),
                               rtol=1e-5)


def test_langevin_update_matches_jax_formula():
    """fused_em.py's corrector: batch-mean row norms of score and z."""
    h, w_post, w_vals, b_post, coefs, x, z = _head_inputs(seed=4)
    step, snr = 1, 0.16
    score = np.array(coefs[step, 3] * (jax_mm(h, w_vals) + b_post)[:, :x.shape[1]])
    grad_norm = jnp.mean(jnp.sqrt(jnp.sum(score * score, axis=1)))
    noise_norm = jnp.mean(jnp.sqrt(jnp.sum(z * z, axis=1)))
    step_ref = (snr * noise_norm / grad_norm) ** 2 * 2.0 * coefs[step, 4]
    x_ref = x + step_ref * score + jnp.sqrt(2.0 * step_ref) * z

    tx, st = torch.from_numpy(x.copy()), torch.empty(1)
    langevin_update(tx, torch.from_numpy(score),
                    torch.from_numpy((score * score).sum(1)), torch.from_numpy(coefs),
                    step, snr, noise=torch.from_numpy(z), step_out=st)
    np.testing.assert_allclose(st.numpy()[0], float(step_ref), rtol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(x_ref), rtol=1e-5, atol=1e-5)


def test_in_kernel_normals_need_the_card():
    h, w_post, _, b_post, coefs, x, _ = _head_inputs()
    with pytest.raises(ValueError):
        head_em(torch.from_numpy(h), w_post, torch.from_numpy(b_post),
                torch.from_numpy(coefs), 0, "em", x=torch.from_numpy(x), seed=1)
    _, _, tm = flax_and_torch(**SMALL)
    with pytest.raises(ValueError):
        get_cuda_em_sampler(tsde.SubVPSDE(N=5), tm, (4, 63), rng_mode="kernel",
                            device="cpu")


def test_network_operands_match_jax():
    """Natural feature order: the JAX build with its matmul GroupNorm (no
    lane permutation) gives the same weights and per-step rows."""
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    jlabels = jax_labels_for(jsde.SubVPSDE(N=20), jsde.SubVPSDE(N=20).timesteps(1e-3))
    labels = torch.from_numpy(np.array(jlabels))
    net = score_net.build_network_operands(tm, labels, "cpu")
    jnet = jax_build_network_operands(fm, params, 63, 128, jlabels, gn="mm")
    n_tp = 1 + 2 * SMALL["n_blocks"]
    np.testing.assert_allclose(net["tp_all"].numpy(),
                               np.asarray(jnet["tp_all"])[:, :n_tp],
                               rtol=1e-5, atol=5e-5)
    np.testing.assert_array_equal(net["W"][0].float().numpy(),
                                  np.asarray(jnet["Wpre"], np.float32)[:63])
    for mine, theirs in zip(net["W"][1:], jnet["Ws"]):
        np.testing.assert_array_equal(mine.float().numpy(), np.asarray(theirs, np.float32))
    np.testing.assert_array_equal(net["w_post"].float().numpy(),
                                  np.asarray(jnet["Wpost"], np.float32)[:, :HEAD_COLS])
    np.testing.assert_allclose(net["out_scale"].numpy(), np.asarray(jnet["out_scale"]),
                               rtol=1e-6)
    # the hidden stack reproduces the fp32 forward up to bf16 operand rounding
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(6, 63)).astype(np.float32))
    h, h1 = torch.empty(6, SMALL["hidden_dim"]), torch.empty(6, SMALL["hidden_dim"])
    network_hidden(net, x, 3, h, h1)
    tprojs, _ = tfs.precompute_time_tables(tm, labels)
    with torch.no_grad():
        ref = tfs.make_fast_forward(tm, tprojs, None)(x, 3)
        out = h.to(torch.bfloat16).float() @ net["w_post"].float()[:, :63] + net["b_post"][:63]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=3e-2 * float(ref.abs().max()))


@pytest.mark.parametrize("corrector", ["none", "langevin"])
def test_kernel_sampler_matches_pallas_interpret(corrector):
    """The port's kernel path (plain versions on the CPU) against the TPU
    kernel run in interpret mode, on identical z and noise, at the bound
    the JAX package holds its own kernel to (test_pallas_sampler.py)."""
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    n, shape = 20, (8, 63)
    k = 2 if corrector == "langevin" else 1
    z, noise = _injected(shape, n, k, seed=11)
    kw = dict(eps=1e-3, corrector=corrector, snr=0.16, n_corrector_steps=1)
    _, ref = get_pallas_em_sampler(jsde.SubVPSDE(N=n), fm, params, shape,
                                   interpret=True, rng_mode="host", **kw)(
        jax.random.PRNGKey(0), z=jnp.asarray(z), noise=jnp.asarray(noise))
    ref = np.asarray(ref)
    reset_launch_counts()
    out = get_cuda_em_sampler(tsde.SubVPSDE(N=n), tm, shape, device="cpu", **kw)(
        z=torch.from_numpy(z), noise=torch.from_numpy(noise))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2 * scale)
    # and the fp32 tabled sampler, the port's semantic reference
    fp32 = tfs.get_fast_pc_sampler(tsde.SubVPSDE(N=n), tm, shape, device="cpu",
                                   corrector=corrector)(
        z=torch.from_numpy(z), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), fp32.numpy(), atol=2e-2 * scale)
    # the CPU path runs the plain versions and launches nothing
    assert sum(launch_counts().values()) == 0


def test_kernel_sampler_denoise_off_and_generator():
    _, _, tm = flax_and_torch(**SMALL)
    # N >= 20: below it the DDPM betas 20/N exceed 1 and the corrector's
    # alpha = 1 - beta turns negative (in the JAX package too)
    s = get_cuda_em_sampler(tsde.SubVPSDE(N=20), tm, (4, 63), denoise=False,
                            corrector="langevin", device="cpu")
    a = s(torch.Generator().manual_seed(1))
    b = s(torch.Generator().manual_seed(1))
    assert a.shape == (4, 63) and torch.isfinite(a).all() and torch.equal(a, b)
    with pytest.raises(ValueError):
        s(noise=torch.zeros(20, 1, 4, 63))  # langevin needs K = 2 slabs


def test_plain_sampler_is_the_cpu_kernel_path():
    """``plain=True`` (the card's reference loop) runs the same arithmetic the
    wrappers run on CPU tensors, step for step."""
    _, _, tm = flax_and_torch(**SMALL)
    z, noise = _injected((5, 63), 20, 2, seed=12)
    z, noise = torch.from_numpy(z), torch.from_numpy(noise)
    outs = [get_cuda_em_sampler(tsde.SubVPSDE(N=20), tm, (5, 63), corrector="langevin",
                                device="cpu", plain=plain)(z=z, noise=noise)
            for plain in (False, True)]
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError):
        get_cuda_em_sampler(tsde.SubVPSDE(N=20), tm, (5, 63), rng_mode="kernel",
                            device="cpu", plain=True)


def test_masked_renoise_and_comp_perturb_match_jax_formulas():
    """fused_em.py:192-197 and fused_comp.py:116-117 on the same numbers."""
    _, _, _, _, coefs, x, z = _head_inputs(seed=6)
    rng = np.random.default_rng(6)
    obs = rng.normal(size=x.shape).astype(np.float32)
    mask = (rng.random(x.shape) < 0.3).astype(np.float32)
    step = 3
    masked = coefs[step, 5] * jnp.asarray(obs) + coefs[step, 6] * jnp.asarray(z)
    ref = jnp.asarray(x) * (1.0 - mask) + masked * mask
    tx = torch.from_numpy(x.copy())
    masked_renoise(tx, torch.from_numpy(obs), torch.from_numpy(mask), torch.from_numpy(coefs),
                   step, noise=torch.from_numpy(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tx.numpy()[mask == 0], x[mask == 0])

    pert = torch.empty(x.shape)
    comp_perturb(torch.from_numpy(x), pert, torch.from_numpy(coefs), step,
                 noise=torch.from_numpy(z))
    np.testing.assert_allclose(pert.numpy(),
                               np.asarray(coefs[step, 0] * jnp.asarray(x)
                                          + coefs[step, 1] * jnp.asarray(z)),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):  # in place is refused: K6 reads x and pert
        t = torch.from_numpy(x.copy())
        comp_perturb(t, t, torch.from_numpy(coefs), step, noise=torch.from_numpy(z))
    with pytest.raises(ValueError):  # in-kernel normals need the card
        masked_renoise(tx, torch.from_numpy(obs), torch.from_numpy(mask),
                       torch.from_numpy(coefs), step, seed=1)


@pytest.mark.parametrize("paste", [False, True])
def test_head_adam_matches_jax_formula(paste):
    """fused_comp.py:118-127 (and the paste, :131) on the same numbers."""
    h, w_post, w_vals, b_post, coefs, x, z = _head_inputs(seed=7)
    rng = np.random.default_rng(7)
    obs, pert = (rng.normal(size=x.shape).astype(np.float32) for _ in range(2))
    mask = (rng.random(x.shape) < 0.5).astype(np.float32)
    m1 = (0.1 * rng.normal(size=x.shape)).astype(np.float32)
    v = (0.01 * rng.random(x.shape)).astype(np.float32)
    step, D = 1, x.shape[1]
    cf = coefs[step]
    raw = (jax_mm(h, w_vals) + b_post)[:, :D]
    x0_hat = cf[2] * pert + cf[3] * raw
    g = cf[4] * (mask * (x - obs)) + cf[5] * (x - x0_hat)
    m_ref = fused_comp.ADAM_B1 * m1 + (1.0 - fused_comp.ADAM_B1) * g
    v_ref = fused_comp.ADAM_B2 * v + (1.0 - fused_comp.ADAM_B2) * (g * g)
    x_ref = x - cf[6] * m_ref / (jnp.sqrt(v_ref * cf[7]) + fused_comp.ADAM_EPS)
    if paste:
        x_ref = obs * mask + x_ref * (1.0 - mask)
    tx, tm1, tv = (torch.from_numpy(a.copy()) for a in (x, m1, v))
    head_adam(torch.from_numpy(h), w_post, torch.from_numpy(b_post), torch.from_numpy(coefs),
              step, tx, torch.from_numpy(pert), torch.from_numpy(obs), torch.from_numpy(mask),
              tm1, tv, paste)
    np.testing.assert_allclose(tm1.numpy(), np.asarray(m_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v_ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tx.numpy(), np.asarray(x_ref), rtol=1e-5, atol=1e-5)
    if paste:
        np.testing.assert_array_equal(tx.numpy() * mask, obs * mask)


def _obs_mask(shape, seed=13):
    obs = (0.3 * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)
    mask = np.zeros(shape, np.float32)
    mask[:, 39:45] = 1.0
    return obs, mask


@pytest.mark.parametrize("corrector", ["none", "langevin"])
def test_imputation_kernel_sampler_matches_pallas_interpret(corrector):
    """The imputation switch of the kernel sampler (plain K4 around plain K2
    on CPU tensors) against ``get_pallas_em_sampler(imputation=True)`` in
    interpret mode, on identical z and [N, K, B, D] slabs, at the bound of
    test_kernel_sampler_matches_pallas_interpret."""
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    n, shape = 20, (8, 63)
    k = (1 if corrector == "langevin" else 0) + 3
    z, noise = _injected(shape, n, k, seed=14)
    obs, mask = _obs_mask(shape)
    kw = dict(eps=1e-3, corrector=corrector, snr=0.16, n_corrector_steps=1, imputation=True)
    for denoise in (True, False):
        _, ref = get_pallas_em_sampler(jsde.SubVPSDE(N=n), fm, params, shape, interpret=True,
                                       rng_mode="host", denoise=denoise, **kw)(
            jax.random.PRNGKey(0), observation=jnp.asarray(obs), mask=jnp.asarray(mask),
            z=jnp.asarray(z), noise=jnp.asarray(noise))
        ref = np.asarray(ref)
        sampler = get_cuda_em_sampler(tsde.SubVPSDE(N=n), tm, shape, device="cpu",
                                      denoise=denoise, **kw)
        out = sampler(observation=torch.from_numpy(obs), mask=torch.from_numpy(mask),
                      z=torch.from_numpy(z), noise=torch.from_numpy(noise))
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-2 * scale)
        # the observed dims went through no network: they agree to rounding
        np.testing.assert_allclose(out.numpy()[:, 39:45], ref[:, 39:45],
                                   atol=(2e-2 if denoise else 1e-5) * scale)
    with pytest.raises(ValueError):
        sampler(z=torch.from_numpy(z), noise=torch.from_numpy(noise))
    with pytest.raises(ValueError):  # built without imputation: takes no observation
        get_cuda_em_sampler(tsde.SubVPSDE(N=n), tm, shape, device="cpu")(
            observation=torch.from_numpy(obs), mask=torch.from_numpy(mask))


def test_kernel_sampler_step_range_split_equals_full_run():
    _, _, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    n, cut, shape = 20, 13, (6, 63)
    z, noise = _injected(shape, n, 4, seed=15)
    z, noise = torch.from_numpy(z), torch.from_numpy(noise)
    io = {k: torch.from_numpy(a) for k, a in zip(("observation", "mask"), _obs_mask(shape))}
    kw = dict(corrector="langevin", imputation=True, device="cpu")
    ts = tsde.SubVPSDE(N=n)
    full = get_cuda_em_sampler(ts, tm, shape, **kw)(z=z, noise=noise, **io)
    head = get_cuda_em_sampler(ts, tm, shape, denoise=False, step_range=(0, cut), **kw)
    tail = get_cuda_em_sampler(ts, tm, shape, step_range=(cut, n), **kw)
    assert torch.equal(tail(z=head(z=z, noise=noise[:cut], **io), noise=noise[cut:], **io), full)
    with pytest.raises(ValueError):
        get_cuda_em_sampler(ts, tm, shape, step_range=(3, 3), **kw)
    with pytest.raises(ValueError):
        head(z=z, noise=noise, **io)  # the head takes its own 13 rows of slabs


@pytest.mark.parametrize("imputation", [False, True])
def test_cuda_ddim_sampler_matches_pallas_ddim_interpret(imputation):
    """DDIM on the overridden tables: ``cout`` folds the sigma scaling once,
    and the imputation columns follow the overridden timesteps."""
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    shape, n_steps = (6, 63), 8
    k = 3 if imputation else 1
    z, noise = _injected(shape, n_steps + 1, k, seed=16)
    obs, mask = _obs_mask(shape)
    jio = dict(observation=jnp.asarray(obs), mask=jnp.asarray(mask)) if imputation else {}
    tio = {k_: torch.from_numpy(np.array(v)) for k_, v in jio.items()}
    nfe_ref, ref = get_pallas_ddim_sampler(jsde.SubVPSDE(N=1000), fm, params, shape,
                                           n_steps=n_steps, interpret=True, rng_mode="host",
                                           imputation=imputation)(
        jax.random.PRNGKey(0), z=jnp.asarray(z), noise=jnp.asarray(noise), **jio)
    nfe, out = get_cuda_ddim_sampler(tsde.SubVPSDE(N=1000), tm, shape, n_steps=n_steps,
                                     imputation=imputation, device="cpu")(
        z=torch.from_numpy(z), noise=torch.from_numpy(noise), **tio)
    assert nfe == nfe_ref == n_steps + 1
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2 * max(1.0, float(np.abs(ref).max())))


def test_em_hypo_sampler_tiles_rows():
    _, _, tm = flax_and_torch(**SMALL)
    shape, hypo = (4, 63), 3
    obs, mask = map(torch.from_numpy, _obs_mask(shape))
    s = get_cuda_em_hypo_sampler(tsde.SubVPSDE(N=20), tm, shape, hypo, denoise=False,
                                 device="cpu")
    out = s(torch.Generator().manual_seed(0), obs, mask)
    assert out.shape == (4, hypo, 63) and torch.isfinite(out).all()
    # the state is re-imputed last: observed dims sit at the observation, at
    # the last step's noise level (std 1e-4 at t = 1e-3)
    assert float(((out - obs[:, None]) * mask[:, None]).abs().max()) < 1e-2
    assert float((out[:, 0] - out[:, 1]).abs().max()) > 1e-3


@pytest.mark.parametrize("stage", [0, 1, 2, 3, fused_ode.DENOISE])
def test_head_rk4_matches_jax_formula(stage):
    """fused_ode.py:87-96 (one RK4 stage) and :101-107 (the denoise) on the
    same numbers."""
    h, w_post, w_vals, b_post, coefs, x, z = _head_inputs(seed=30)
    rng = np.random.default_rng(30)
    xs, acc = z, rng.normal(size=x.shape).astype(np.float32)
    j, D = 2, x.shape[1]
    a1, a2, hstep, cdx, cdo = (jnp.float32(c) for c in coefs[j, :5])
    out = (jax_mm(h, w_vals) + b_post)[:, :D]
    k = a1 * xs + a2 * out
    if stage == 0:
        x_ref, acc_ref, xs_ref = x, k, x + 0.5 * hstep * k
    elif stage in (1, 2):
        x_ref, acc_ref = x, acc + 2.0 * k
        xs_ref = x + (0.5 if stage == 1 else 1.0) * hstep * k
    elif stage == 3:
        x_ref = x + (hstep / 6.0) * (acc + k)
        acc_ref, xs_ref = acc, x_ref
    else:
        x_ref, acc_ref, xs_ref = cdx * x + cdo * out, acc, xs
    tx, txs, tacc = (torch.from_numpy(a.copy()) for a in (x, xs, acc))
    head_rk4(torch.from_numpy(h), w_post, torch.from_numpy(b_post), torch.from_numpy(coefs),
             j, stage, tx, txs, tacc)
    for got, ref in ((tx, x_ref), (txs, xs_ref), (tacc, acc_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_head_rk4_rejects_bad_operands():
    h, w_post, _, b_post, coefs, x, _ = _head_inputs(seed=31)
    th, tb, tc, tx = map(torch.from_numpy, (h, b_post, coefs, x))
    with pytest.raises(ValueError):  # stages are 0..3 and the denoise
        head_rk4(th, w_post, tb, tc, 0, 5, tx, tx.clone(), tx.clone())
    with pytest.raises(ValueError):  # a grid row past the table
        head_rk4(th, w_post, tb, tc, coefs.shape[0], 0, tx, tx.clone(), tx.clone())
    with pytest.raises(ValueError):
        head_rk4(th, w_post, tb, tc, 0, 0, tx, tx[:-1].clone(), tx.clone())
    with pytest.raises(TypeError):
        head_rk4(th, w_post, tb, tc, 0, 0, tx, tx.clone(), tx.double())


def test_network_hidden_jvp_matches_autodiff_of_the_forward():
    """The hand-propagated tangent of the hidden stack, through the head,
    against ``torch.func.jvp`` of the fp32 forward at a row of the stage grid;
    the primal is ``network_hidden``'s."""
    _, _, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    ts = tsde.SubVPSDE(N=100)
    _, labels, _, _, _ = tfs.pf_ode_grid(ts, tm, 1e-4, ts.T, 6, "cpu")
    net = score_net.build_network_operands(tm, labels, "cpu")
    rng = np.random.default_rng(32)
    x, dx = (torch.from_numpy(rng.normal(size=(6, 63)).astype(np.float32)) for _ in range(2))
    H = SMALL["hidden_dim"]
    bufs = score_net.hidden_jvp_buffers(net, 6, "cpu")
    row = 7
    h, dh = network_hidden_jvp(net, x, dx, row, bufs)
    ref_h = network_hidden(net, x, row, torch.empty(6, H), torch.empty(6, H))
    np.testing.assert_allclose(h.numpy(), ref_h.numpy(), rtol=1e-6, atol=1e-6)
    tprojs, _ = tfs.precompute_time_tables(tm, labels)
    with torch.no_grad():
        out, dout = torch.func.jvp(lambda v: tfs.make_fast_forward(tm, tprojs, None)(v, row),
                                   (x,), (dx,))
    wp = net["w_post"].float()[:, :63]
    mine = dh.to(torch.bfloat16).float() @ wp
    # bf16 matmul operands against fp32: three decimal digits through five layers
    np.testing.assert_allclose(mine.numpy(), dout.numpy(), atol=3e-2 * float(dout.abs().max()))
