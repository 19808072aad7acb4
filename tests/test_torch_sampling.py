"""The torch port's SDEs, coefficient tables and samplers against the JAX
package on the same weights, inputs and injected noise (CPU, fp32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.diffusion import fast_sampler as jfs
from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.diffusion.score_fn import get_score_fn as jax_get_score_fn
from dposer_tpu_torch.diffusion import fast_sampler as tfs
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.sampling import get_pc_sampler
from dposer_tpu_torch.diffusion.score_fn import get_score_fn

from test_torch_model import SMALL, flax_and_torch

SDES = {
    "subvp": (jsde.SubVPSDE(N=1000), tsde.SubVPSDE(N=1000), 1e-3),
    "vp": (jsde.VPSDE(N=1000), tsde.VPSDE(N=1000), 1e-3),
    "ve": (jsde.VESDE(N=1000), tsde.VESDE(N=1000), 1e-5),
}


def close(out, ref, rtol=2e-6, atol=1e-6):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=rtol, atol=atol)


# Quantities built on a discrete ladder (VP's DDPM betas, VE's sigma
# ladder) come from a jnp.linspace inside the SDE whose points differ from
# the port's by a few ulps (see test_grids_match_jax); sqrt(alpha) - 1 and
# sigma^2 - sigma_prev^2 cancel about 100x, so those compare at 2e-4.
LADDER_RTOL = 2e-4


def _grid(name):
    """The SDE pair and JAX's time grid, as both frameworks' tensors: the
    formulas below are compared on one grid."""
    js, ts, eps = SDES[name]
    jt = js.timesteps(eps)
    return js, ts, jt, torch.from_numpy(np.array(jt))


@pytest.mark.parametrize("name", list(SDES))
def test_grids_match_jax(name):
    js, ts, eps = SDES[name]
    jt, tt = js.timesteps(eps), ts.timesteps(eps)
    # XLA contracts jnp.linspace's arithmetic into FMAs: points may differ
    # by a few ulps of 1.0, but the integer casts that index the tables
    # (step index t*(N-1), sigma label t*999) must agree exactly
    close(tt, jt, rtol=0, atol=2e-7)
    for scale in (ts.N - 1, 999):
        np.testing.assert_array_equal((tt * scale).long().numpy(),
                                      np.asarray((jt * scale).astype(jnp.int32)))
    if name != "ve":
        close(ts.alphas(), js.alphas(), rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("name", list(SDES))
def test_sde_methods_match_jax(name):
    js, ts, jt, tt = _grid(name)
    x = np.random.default_rng(0).normal(size=(1000, 5)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for jo, to in zip(js.sde(jx, jt), ts.sde(tx, tt)):
        close(to, jo, rtol=5e-6)
    for jo, to in zip(js.marginal_prob(jx, jt), ts.marginal_prob(tx, tt)):
        close(to, jo, rtol=5e-6)
    for jo, to in zip(js.discretize(jx, jt), ts.discretize(tx, tt)):
        close(to, jo, rtol=LADDER_RTOL)
    close(ts.prior_logp(tx), js.prior_logp(jx), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("name", list(SDES))
def test_tables_match_jax(name):
    js, ts, jt, tt = _grid(name)
    for pred in ("euler_maruyama", "reverse_diffusion"):
        rtol = 5e-6 if pred == "euler_maruyama" else LADDER_RTOL
        for pf in (False, True):
            for jo, to in zip(jfs._pred_tables(js, jt, pred, pf),
                              tfs._pred_tables(ts, tt, pred, pf)):
                close(to, jo, rtol=rtol)
    close(tfs._labels_for(ts, tt), jfs._labels_for(js, jt))
    for jo, to in zip(jfs._corrector_tables(js, jt, None),
                      tfs._corrector_tables(ts, tt, None)):
        close(to, jo, rtol=5e-6)
    for jo, to in zip(jfs._imputation_tables(js, jt), tfs._imputation_tables(ts, tt)):
        close(to, jo, rtol=5e-6)


def test_time_tables_match_jax():
    fm, params, tm = flax_and_torch(**SMALL)
    js, ts, jt, tt = _grid("subvp")
    jp, jscale = jfs.precompute_time_tables(fm, params, jfs._labels_for(js, jt))
    tp, tscale = tfs.precompute_time_tables(tm, tfs._labels_for(ts, tt))
    assert sorted(jp) == sorted(tp)
    # the sinusoidal embedding itself agrees to 1e-4 (labels up to 999 times
    # a frequency whose fp32 exp may differ by an ulp; test_torch_model.py)
    for k in jp:
        close(tp[k], jp[k], rtol=1e-5, atol=5e-5)
    close(tscale, jscale)


def test_score_fn_matches_jax():
    fm, params, tm = flax_and_torch(**SMALL)
    js, ts, _ = SDES["subvp"]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 63)).astype(np.float32)
    # sub-VP's std = 1 - exp(2*lmc) cancels as t -> 0 (1e-4 at t = 1e-3),
    # which turns a 1-ulp difference in exp into 1e-3 of the score; away
    # from 0 the adapter is compared at the model's own tolerance
    t = rng.uniform(0.05, 1.0, size=(6,)).astype(np.float32)
    ref = jax_get_score_fn(js, lambda a, b: fm.apply({"params": params}, a, b))(
        jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        out = get_score_fn(ts, tm)(torch.from_numpy(x), torch.from_numpy(t))
    close(out, ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


def _injected(shape, n, k, seed=7):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=shape).astype(np.float32)
    noise = rng.normal(size=(n, k) + shape).astype(np.float32)
    return z, noise


@pytest.mark.parametrize("corrector", ["none", "langevin"])
@pytest.mark.parametrize("scale_by_sigma", [False, True])
def test_fast_pc_sampler_matches_jax(corrector, scale_by_sigma):
    kw = dict(SMALL, scale_by_sigma=scale_by_sigma)
    fm, params, tm = flax_and_torch(**kw)
    js, ts = jsde.SubVPSDE(N=20), tsde.SubVPSDE(N=20)
    shape = (8, 63)
    z, noise = _injected(shape, 20, 2 if corrector == "langevin" else 1)
    _, ref = jfs.get_fast_pc_sampler(js, fm, params, shape, corrector=corrector)(
        jax.random.PRNGKey(0), z=jnp.asarray(z), noise=jnp.asarray(noise))
    out = tfs.get_fast_pc_sampler(ts, tm, shape, corrector=corrector, device="cpu")(
        z=torch.from_numpy(z), noise=torch.from_numpy(noise))
    ref = np.asarray(ref)
    # fp32 both sides; 20 noisy steps amplify matmul rounding differences
    close(out, ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("corrector", ["none", "langevin"])
def test_pc_sampler_matches_fast_sampler(corrector):
    """The plain predictor-corrector loop and the tabled sampler are the same
    algorithm on the same noise."""
    _, _, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    ts = tsde.SubVPSDE(N=20)
    shape = (8, 63)
    z, noise = _injected(shape, 20, 2 if corrector == "langevin" else 1, seed=8)
    z, noise = torch.from_numpy(z), torch.from_numpy(noise)
    generic = get_pc_sampler(ts, shape, get_score_fn(ts, tm), corrector=corrector,
                             device="cpu")(z=z, noise=noise)
    fast = tfs.get_fast_pc_sampler(ts, tm, shape, corrector=corrector,
                                   device="cpu")(z=z, noise=noise)
    close(fast, generic, rtol=0, atol=1e-4 * max(1.0, float(generic.abs().max())))


def test_sampler_draws_from_generator():
    _, _, tm = flax_and_torch(**SMALL)
    ts = tsde.SubVPSDE(N=5)
    s = tfs.get_fast_pc_sampler(ts, tm, (4, 63), device="cpu")
    a = s(torch.Generator().manual_seed(3))
    b = s(torch.Generator().manual_seed(3))
    c = s(torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (4, 63) and torch.isfinite(a).all()
