"""The port's probability-flow-ODE paths against the JAX package on the CPU:
the PF tables, the adaptive RK45, the fp32 samplers, the kernel RK4 sampler's
plain loop against the Pallas kernel in interpret mode, the PF-Euler decode,
and the interpolation helpers. Same weights (``state_dict_from_flax``) and
numpy-seeded inputs on both sides.

The networks are untrained. Without the sigma output scaling their PF field
stays bounded enough that two integrations of it can be compared; it still
grows |x| to several hundred over [T, eps], so tolerances scale with |ref|.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.diffusion import fast_sampler as jfs
from dposer_tpu.diffusion import ode as jode
from dposer_tpu.diffusion import sampling as jsampling
from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.diffusion.score_fn import get_score_fn as jax_get_score_fn
from dposer_tpu.ops import smoothing as jsmooth
from dposer_tpu.ops.pallas.fused_em import get_pallas_em_sampler
from dposer_tpu.ops.pallas.fused_ode import get_pallas_ode_sampler
from dposer_tpu_torch.diffusion import fast_sampler as tfs
from dposer_tpu_torch.diffusion import ode as tode
from dposer_tpu_torch.diffusion import sampling as tsampling
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.score_fn import get_score_fn
from dposer_tpu_torch.ops import smoothing as tsmooth
from dposer_tpu_torch.ops.cuda.fused_em import (get_cuda_em_sampler, launch_counts,
                                                reset_launch_counts)
from dposer_tpu_torch.ops.cuda.fused_ode import get_cuda_ode_sampler

from test_torch_model import SMALL, flax_and_torch
from test_torch_sampling import SDES, _grid, close

SHAPE = (8, 63)


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
    js, ts = jsde.SubVPSDE(N=100), tsde.SubVPSDE(N=100)
    jscore = jax_get_score_fn(js, lambda x, t: fm.apply({"params": params}, x, t),
                              continuous=True)
    return fm, params, tm, js, ts, jscore, get_score_fn(ts, tm, continuous=True)


def _z(seed, shape=SHAPE, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _scaled_close(out, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, atol=rel * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("name", list(SDES))
def test_pf_tables_match_jax(name):
    js, ts, jt, tt = _grid(name)
    for jo, to in zip(jfs._pf_tables(js, jt), tfs._pf_tables(ts, tt)):
        close(to, jo, rtol=5e-6)


def test_pf_ode_grid_folds_the_sigma_scale():
    """a2 carries the model's 1/sigma output scaling at each stage label, and
    the grid runs from its start to its end in 2*n_steps + 1 points."""
    _, _, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    ts = tsde.SubVPSDE(N=100)
    taus, labels, a1, a2, h = tfs.pf_ode_grid(ts, tm, 1e-4, ts.T, 10, "cpu")
    assert taus.shape == (21,) and float(taus[0]) == np.float32(1e-4) and float(taus[-1]) == 1.0
    assert h == pytest.approx((1.0 - 1e-4) / 10)
    raw1, raw2 = tfs._pf_tables(ts, taus)
    close(a1, raw1.numpy(), rtol=0, atol=0)
    close(a2, (raw2 / tm.sigmas[labels.long()]).numpy(), rtol=1e-6)


def test_rk45_linear_ode_matches_jax():
    rng = np.random.default_rng(0)
    A = (0.5 * rng.normal(size=(5, 5))).astype(np.float32)
    y0 = rng.normal(size=(3, 5)).astype(np.float32)
    ref = jode.rk45(lambda t, y: y @ jnp.asarray(A) * jnp.cos(3 * t), 0.0, 2.0,
                    jnp.asarray(y0), rtol=1e-6, atol=1e-6)
    out = tode.rk45(lambda t, y: y @ torch.from_numpy(A) * float(np.cos(np.float32(3) * t)),
                    0.0, 2.0, torch.from_numpy(y0), rtol=1e-6, atol=1e-6)
    assert out.status == int(ref.status) == 0
    # both solve to rtol 1e-6; the controllers' float32 arithmetic differs by
    # ulps (XLA fuses it), which can flip an accept: a few steps of 6 RHS calls
    np.testing.assert_allclose(out.y.numpy(), np.asarray(ref.y), rtol=2e-5, atol=2e-5)
    assert out.nfe % 6 == 2 and abs(out.nfe - int(ref.nfe)) <= 18


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_rk45_network_drift_matches_jax(nets, direction):
    """The PF-ODE drift of a small network, over a stretch of time where the
    untrained field is tame, in both directions."""
    _, _, _, js, ts, jscore, tscore = nets
    t0, t1 = (0.3, 0.6) if direction == "forward" else (0.6, 0.3)
    y0 = _z(1, scale=0.5)
    jr, tr = (s.reverse_sde(f, probability_flow=True) for s, f in ((js, jscore), (ts, tscore)))
    ref = jode.rk45(lambda t, x: jr(x, jnp.full((8,), t))[0], t0, t1, jnp.asarray(y0),
                    rtol=1e-5, atol=1e-5)
    out = tode.rk45(lambda t, x: tr(x, torch.full((8,), float(t)))[0], t0, t1,
                    torch.from_numpy(y0), rtol=1e-5, atol=1e-5)
    assert out.status == int(ref.status) == 0
    # two runs at rtol 1e-5 whose steps part after an ulp; the untrained field
    # amplifies their local differences a few hundred times
    _scaled_close(out.y, ref.y, 5e-3)
    assert abs(out.nfe - int(ref.nfe)) <= 0.1 * int(ref.nfe) + 12


def test_rk45_reports_truncation_and_lands_on_t1():
    y0 = torch.from_numpy(_z(2, (3, 5)))
    cut = tode.rk45(lambda t, y: -y, 1.0, 0.0, y0, max_steps=3)
    ref = jode.rk45(lambda t, y: -y, 1.0, 0.0, jnp.asarray(y0.numpy()), max_steps=3)
    assert (cut.status, cut.nfe) == (int(ref.status), int(ref.nfe)) == (1, 2 + 3 * 6)
    times = []
    full = tode.rk45(lambda t, y: times.append(float(t)) or -y, 1.0, 0.25, y0)
    assert full.status == 0 and min(times) == 0.25  # the last stage sits exactly on t1
    np.testing.assert_allclose(full.y.numpy(), y0.numpy() * np.exp(0.75), rtol=1e-4)


@pytest.mark.parametrize("denoise", [False, True])
def test_fast_ode_sampler_matches_jax(nets, denoise):
    fm, params, tm, js, ts, _, _ = nets
    z = _z(3)
    nfe_ref, ref = jfs.get_fast_ode_sampler(js, fm, params, SHAPE, n_steps=20, eps=1e-3,
                                            denoise=denoise)(jax.random.PRNGKey(0),
                                                             z=jnp.asarray(z))
    nfe, out = tfs.get_fast_ode_sampler(ts, tm, SHAPE, n_steps=20, eps=1e-3, denoise=denoise,
                                        device="cpu")(z=torch.from_numpy(z))
    assert nfe == nfe_ref == 80
    _scaled_close(out, ref, 1e-4)  # fp32 both sides: summation order over 80 forwards


def test_fast_ode_sampler_draws_its_prior_from_the_generator(nets):
    _, _, tm, _, ts, _, _ = nets
    s = tfs.get_fast_ode_sampler(ts, tm, (4, 63), n_steps=3, device="cpu")
    a = s(torch.Generator().manual_seed(5))[1]
    assert torch.equal(a, s(torch.Generator().manual_seed(5))[1])
    assert not torch.equal(a, s(torch.Generator().manual_seed(6))[1])


@pytest.mark.parametrize("denoise", [False, True])
def test_ode_sampler_matches_jax(nets, denoise):
    """The adaptive sampler. sde.T is cut to 0.5 so that the untrained field
    amplifies little and both adaptive runs sit near the true solution."""
    fm, params, tm, *_ = nets
    js, ts = jsde.SubVPSDE(N=100, T=0.5), tsde.SubVPSDE(N=100, T=0.5)
    jscore = jax_get_score_fn(js, lambda x, t: fm.apply({"params": params}, x, t),
                              continuous=True)
    z = _z(4, scale=0.5)
    kw = dict(denoise=denoise, rtol=1e-5, atol=1e-5, eps=1e-2)
    nfe_ref, ref = jsampling.get_ode_sampler(js, SHAPE, jscore, **kw)(
        jax.random.PRNGKey(0), z=jnp.asarray(z))
    nfe, out = tsampling.get_ode_sampler(ts, SHAPE, get_score_fn(ts, tm, continuous=True),
                                         device="cpu", **kw)(z=torch.from_numpy(z))
    _scaled_close(out, ref, 5e-3)  # as test_rk45_network_drift_matches_jax
    assert abs(nfe - int(nfe_ref)) <= 0.1 * int(nfe_ref) + 12


def test_ode_sampler_returns_nans_when_truncated(nets, monkeypatch):
    *_, ts, _, tscore = nets
    real = tode.rk45
    monkeypatch.setattr(tode, "rk45", lambda *a, **kw: real(*a, max_steps=2, **kw))
    nfe, x = tsampling.get_ode_sampler(ts, (4, 63), tscore, device="cpu")(
        z=torch.from_numpy(_z(5, (4, 63))))
    assert nfe == 14 and torch.isnan(x).all()


def test_fast_em_sampler_matches_jax(nets):
    """JAX draws step i's normals from fold_in(key, i) -> split 4 -> third
    key; the same arrays go to the port through ``noise=``."""
    fm, params, tm, *_ = nets
    js, ts = jsde.SubVPSDE(N=20), tsde.SubVPSDE(N=20)
    z, key = _z(6), jax.random.PRNGKey(3)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.split(jax.random.fold_in(key, i), 4)[2], SHAPE)) for i in range(20)])
    for denoise in (True, False):
        _, ref = jfs.get_fast_em_sampler(js, fm, params, SHAPE, denoise=denoise)(
            key, z=jnp.asarray(z))
        out = tfs.get_fast_em_sampler(ts, tm, SHAPE, denoise=denoise, device="cpu")(
            z=torch.from_numpy(z), noise=torch.from_numpy(noise))
        _scaled_close(out, ref, 1e-4)


def test_get_sampling_fn_dispatches_on_the_config(nets):
    *_, ts, _, tscore = nets
    sampling = types.SimpleNamespace(method="ODE", predictor="euler_maruyama",
                                     corrector="none", snr=0.16, n_steps_each=1,
                                     noise_removal=False, probability_flow=True)
    config = types.SimpleNamespace(sampling=sampling)
    short = tsde.SubVPSDE(N=100, T=0.3)
    z = torch.from_numpy(_z(7, (4, 63), 0.5))
    nfe, x = tsampling.get_sampling_fn(config, short, (4, 63), tscore, 1e-2, device="cpu")(z=z)
    ref = tsampling.get_ode_sampler(short, (4, 63), tscore, eps=1e-2, device="cpu")(z=z)
    assert nfe == ref[0] and torch.equal(x, ref[1])
    sampling.method = "pc"
    x = tsampling.get_sampling_fn(config, ts, (4, 63), tscore, 1e-3, device="cpu")(z=z)
    ref = tsampling.get_pc_sampler(ts, (4, 63), tscore, probability_flow=True, denoise=False,
                                   device="cpu")(z=z)
    assert torch.equal(x, ref)
    sampling.method = "heun"
    with pytest.raises(ValueError):
        tsampling.get_sampling_fn(config, ts, (4, 63), tscore, 1e-3)


@pytest.mark.parametrize("denoise", [False, True])
def test_kernel_ode_sampler_matches_pallas_interpret(nets, denoise):
    """The kernel RK4 sampler's plain loop (plain K1 and K8 on CPU tensors)
    against the TPU kernel in interpret mode on the same z, at the bound the
    JAX package holds its kernel to its fp32 sampler with (test_fast_ode.py),
    and against the port's fp32 sampler."""
    fm, params, tm, js, ts, _, _ = nets
    z = _z(8)
    nfe_ref, ref = get_pallas_ode_sampler(js, fm, params, SHAPE, n_steps=20, eps=1e-3,
                                          denoise=denoise, interpret=True)(
        jax.random.PRNGKey(0), z=jnp.asarray(z))
    reset_launch_counts()
    nfe, out = get_cuda_ode_sampler(ts, tm, SHAPE, n_steps=20, eps=1e-3, denoise=denoise,
                                    device="cpu")(z=torch.from_numpy(z))
    assert nfe == nfe_ref == 80
    _scaled_close(out, ref, 5e-3)
    _, fp32 = tfs.get_fast_ode_sampler(ts, tm, SHAPE, n_steps=20, eps=1e-3, denoise=denoise,
                                       device="cpu")(z=torch.from_numpy(z))
    _scaled_close(out, fp32, 5e-3)
    # plain=True is the loop the wrappers run on CPU tensors; nothing launched
    _, plain = get_cuda_ode_sampler(ts, tm, SHAPE, n_steps=20, eps=1e-3, denoise=denoise,
                                    device="cpu", plain=True)(z=torch.from_numpy(z))
    assert torch.equal(plain, out) and sum(launch_counts().values()) == 0


def test_kernel_ode_sampler_checks_its_operands(nets):
    *_, tm, _, ts, _, _ = nets
    with pytest.raises(ValueError):
        get_cuda_ode_sampler(ts, tm, (4, 60), n_steps=2, device="cpu")
    s = get_cuda_ode_sampler(ts, tm, (4, 63), n_steps=2, device="cpu")
    with pytest.raises(ValueError):
        s(z=torch.zeros(5, 63))
    a = s(torch.Generator().manual_seed(1))[1]
    assert a.shape == (4, 63) and torch.equal(a, s(torch.Generator().manual_seed(1))[1])


def test_pf_euler_decode_matches_pallas_interpret(nets):
    """``probability_flow=True`` on the kernel sampler (plain K1 and K2 on CPU
    tensors) against the TPU kernel with the same switch in interpret mode,
    at test_fast_ode.py's bound; the normals have no effect."""
    fm, params, tm, js, ts, _, _ = nets
    z = _z(9)
    _, ref = get_pallas_em_sampler(js, fm, params, SHAPE, eps=1e-5, denoise=True,
                                   probability_flow=True, interpret=True)(
        jax.random.PRNGKey(0), z=jnp.asarray(z), noise=jnp.zeros((js.N, 1) + SHAPE))
    sampler = get_cuda_em_sampler(ts, tm, SHAPE, eps=1e-5, probability_flow=True, device="cpu")
    out = sampler(z=torch.from_numpy(z))
    _scaled_close(out, ref, 5e-3)
    fp32 = tfs.get_fast_pc_sampler(ts, tm, SHAPE, eps=1e-5, probability_flow=True,
                                   device="cpu")(z=torch.from_numpy(z),
                                                 noise=torch.zeros((ts.N, 1) + SHAPE))
    _scaled_close(out, fp32, 5e-3)
    noisy = sampler(z=torch.from_numpy(z), noise=torch.from_numpy(_z(10, (ts.N, 1) + SHAPE)))
    assert torch.equal(noisy, out)
    with pytest.raises(ValueError):  # overridden tables carry their own noise column
        get_cuda_em_sampler(ts, tm, SHAPE, probability_flow=True, device="cpu",
                            _tables_override=(ts.timesteps(1e-3),) * 4)


def test_pf_euler_with_a_corrector_still_draws_its_noise(nets):
    *_, tm, _, _, _, _ = nets
    ts = tsde.SubVPSDE(N=20)
    s = get_cuda_em_sampler(ts, tm, (4, 63), probability_flow=True, corrector="langevin",
                            device="cpu")
    z = torch.from_numpy(_z(11, (4, 63)))
    a, b = (s(torch.Generator().manual_seed(k), z=z) for k in (1, 2))
    assert torch.isfinite(a).all() and not torch.equal(a, b)


def test_interpolations_match_jax():
    a, b = _z(12, (63,)), _z(13, (63,))
    for name in ("linear_interpolation", "slerp_interpolation"):
        ref = getattr(jsmooth, name)(jnp.asarray(a), jnp.asarray(b), 7)
        out = getattr(tsmooth, name)(torch.from_numpy(a), torch.from_numpy(b), 7)
        assert out.shape == (7, 63)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # the end points are the inputs, and parallel latents fall back to the linear blend
    out = tsmooth.slerp_interpolation(torch.from_numpy(a), torch.from_numpy(b), 5)
    np.testing.assert_allclose(out[0].numpy(), a, atol=1e-6)
    np.testing.assert_allclose(out[-1].numpy(), b, atol=1e-6)
    par = tsmooth.slerp_interpolation(torch.from_numpy(a), torch.from_numpy(2 * a), 5)
    ref = jsmooth.slerp_interpolation(jnp.asarray(a), jnp.asarray(2 * a), 5)
    assert torch.isfinite(par).all()
    np.testing.assert_allclose(par.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
