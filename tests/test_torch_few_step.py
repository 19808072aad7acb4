"""The port's few-step samplers (DDIM, DPM-Solver++(2M), hybrid) and the
imputation switches of its tabled samplers against the JAX package, on the
same weights, prior draw and injected noise (CPU, fp32; hidden 128, embed 64,
2 blocks, 6 rows)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.diffusion import fast_sampler as jfs
from dposer_tpu.diffusion import few_step as jfew
from dposer_tpu.diffusion import sde as jsde
from dposer_tpu_torch.diffusion import fast_sampler as tfs
from dposer_tpu_torch.diffusion import few_step as tfew
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.sampling import get_pc_sampler
from dposer_tpu_torch.diffusion.score_fn import get_score_fn

from test_torch_model import SMALL, flax_and_torch

SHAPE = (6, 63)
KEY = jax.random.PRNGKey(0)
SDES = {"subvp": (jsde.SubVPSDE, tsde.SubVPSDE, 1e-3), "vp": (jsde.VPSDE, tsde.VPSDE, 1e-3),
        "ve": (jsde.VESDE, tsde.VESDE, 1e-5)}


@pytest.fixture(scope="module")
def models():
    return flax_and_torch(**dict(SMALL, scale_by_sigma=True))


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _obs_mask(seed=5):
    obs = 0.3 * _normal(SHAPE, seed)
    mask = np.zeros(SHAPE, np.float32)
    mask[:, 39:45] = 1.0
    return obs, mask


def close(out, ref, tol=1e-4):
    """Pointwise to ``tol * max(1, |ref|max)``: fp32 both sides, rounding of
    the matmuls carried through a few noisy steps."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("name", list(SDES))
@pytest.mark.parametrize("grid", ["t", "lambda"])
def test_step_grid_matches_jax(name, grid):
    J, T, eps = SDES[name]
    ref = np.asarray(jfew.step_grid(J(N=1000), 21, eps, grid))
    out = tfew.step_grid(T(N=1000), 21, eps, grid).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert out[0] == np.float32(1.0) and out[-1] == np.float32(eps)


@pytest.mark.parametrize("denoise", [True, False])
@pytest.mark.parametrize("grid", ["t", "lambda"])
def test_ddim_tables_match_jax(models, denoise, grid):
    fm, params, tm = models
    ref = jfew.ddim_tables(jsde.SubVPSDE(N=1000), 10, 1e-3, fm, params, denoise=denoise,
                           grid=grid)
    out = tfew.ddim_tables(tsde.SubVPSDE(N=1000), 10, 1e-3, tm, denoise=denoise, grid=grid)
    assert out[0].shape[0] == (11 if denoise else 10)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_hybrid_t_switch_matches_jax():
    for m_tail in (1, 100, 999):
        assert tfew.hybrid_t_switch(tsde.SubVPSDE(N=1000), m_tail, 1e-3) == pytest.approx(
            jfew.hybrid_t_switch(jsde.SubVPSDE(N=1000), m_tail, 1e-3), abs=2e-7)
    with pytest.raises(ValueError):
        tfew.hybrid_t_switch(tsde.SubVPSDE(N=1000), 1000, 1e-3)


@pytest.mark.parametrize("grid", ["t", "lambda"])
@pytest.mark.parametrize("denoise", [True, False])
def test_ddim_sampler_matches_jax(models, grid, denoise):
    fm, params, tm = models
    z = _normal(SHAPE, 1)
    kw = dict(n_steps=10, eps=1e-3, denoise=denoise, grid=grid)
    nfe_ref, ref = jfew.get_ddim_sampler(jsde.SubVPSDE(N=1000), fm, params, SHAPE, **kw)(
        KEY, z=jnp.asarray(z))
    nfe, out = tfew.get_ddim_sampler(tsde.SubVPSDE(N=1000), tm, SHAPE, device="cpu", **kw)(
        z=torch.from_numpy(z))
    assert nfe == nfe_ref == (11 if denoise else 10)
    close(out, ref)


@pytest.mark.parametrize("grid", ["lambda", "t"])
@pytest.mark.parametrize("denoise", [True, False])
def test_dpm_sampler_matches_jax(models, grid, denoise):
    fm, params, tm = models
    z = _normal(SHAPE, 2)
    kw = dict(n_steps=8, eps=1e-3, denoise=denoise, grid=grid)
    nfe_ref, ref = jfew.get_dpm_sampler(jsde.SubVPSDE(N=1000), fm, params, SHAPE, **kw)(
        KEY, z=jnp.asarray(z))
    nfe, out = tfew.get_dpm_sampler(tsde.SubVPSDE(N=1000), tm, SHAPE, device="cpu", **kw)(
        z=torch.from_numpy(z))
    assert nfe == nfe_ref == (9 if denoise else 8)
    close(out, ref)


@pytest.mark.parametrize("tail_corrector", ["none", "langevin"])
def test_hybrid_sampler_matches_jax(models, tail_corrector):
    """The JAX hybrid draws its tail's noise from its key, so its two halves
    are composed here as ``get_hybrid_sampler`` composes them, with the tail's
    slabs injected on both sides."""
    fm, params, tm = models
    js, ts = jsde.SubVPSDE(N=40), tsde.SubVPSDE(N=40)
    n_head, m_tail = 4, 6
    k = 2 if tail_corrector == "langevin" else 1
    z, tail_noise = _normal(SHAPE, 3), _normal((m_tail, k) + SHAPE, 4)
    t_sw = jfew.hybrid_t_switch(js, m_tail, 1e-3)
    _, x = jfew.get_ddim_sampler(js, fm, params, SHAPE, n_steps=n_head, eps=t_sw,
                                 denoise=False)(KEY, z=jnp.asarray(z))
    _, ref = jfs.get_fast_pc_sampler(js, fm, params, SHAPE, corrector=tail_corrector,
                                     step_range=(js.N - m_tail, js.N))(
        KEY, z=x, noise=jnp.asarray(tail_noise))
    nfe, out = tfew.get_hybrid_sampler(ts, tm, SHAPE, n_head=n_head, m_tail=m_tail,
                                       tail_corrector=tail_corrector, device="cpu")(
        z=torch.from_numpy(z), noise=(None, torch.from_numpy(tail_noise)))
    assert nfe == n_head + m_tail * k
    close(out, ref)


@pytest.mark.parametrize("corrector", ["none", "langevin"])
@pytest.mark.parametrize("denoise", [True, False])
def test_fast_pc_imputation_matches_jax(models, corrector, denoise):
    fm, params, tm = models
    n = 20
    k = (1 if corrector == "langevin" else 0) + 3
    z, noise = _normal(SHAPE, 6), _normal((n, k) + SHAPE, 7)
    obs, mask = _obs_mask()
    _, ref = jfs.get_fast_pc_sampler(jsde.SubVPSDE(N=n), fm, params, SHAPE,
                                     corrector=corrector, imputation=True, denoise=denoise)(
        KEY, observation=jnp.asarray(obs), mask=jnp.asarray(mask), z=jnp.asarray(z),
        noise=jnp.asarray(noise))
    sampler = tfs.get_fast_pc_sampler(tsde.SubVPSDE(N=n), tm, SHAPE, corrector=corrector,
                                      imputation=True, denoise=denoise, device="cpu")
    out = sampler(observation=torch.from_numpy(obs), mask=torch.from_numpy(mask),
                  z=torch.from_numpy(z), noise=torch.from_numpy(noise))
    close(out, ref)
    if not denoise:  # the state is re-imputed last; the returned mean is not
        std_last = float(tsde.SubVPSDE(N=n).marginal_prob(torch.zeros(1), torch.tensor(1e-3))[1])
        assert np.abs((out.numpy() - obs) * mask).max() < 10 * std_last + 1e-2
    with pytest.raises(ValueError):
        sampler(z=torch.from_numpy(z))  # built with imputation: needs obs and mask
    with pytest.raises(ValueError):
        sampler(observation=torch.from_numpy(obs), mask=torch.from_numpy(mask),
                noise=torch.from_numpy(noise[:, :1]))


@pytest.mark.parametrize("imputation", [False, True])
def test_fast_pc_step_range_split_equals_full_run(models, imputation):
    """Head then tail on the sliced grid is the full run: against the JAX
    package's split with injected noise, and on one generator."""
    fm, params, tm = models
    n, cut = 20, 12
    k = 4 if imputation else 2
    z, noise = _normal(SHAPE, 8), _normal((n, k) + SHAPE, 9)
    obs, mask = _obs_mask()
    kw = dict(corrector="langevin", imputation=imputation, device="cpu")
    io = dict(observation=torch.from_numpy(obs), mask=torch.from_numpy(mask)) if imputation else {}
    ts = tsde.SubVPSDE(N=n)
    tz, tn = torch.from_numpy(z), torch.from_numpy(noise)
    full = tfs.get_fast_pc_sampler(ts, tm, SHAPE, **kw)(z=tz, noise=tn, **io)
    head = tfs.get_fast_pc_sampler(ts, tm, SHAPE, denoise=False, step_range=(0, cut), **kw)
    tail = tfs.get_fast_pc_sampler(ts, tm, SHAPE, step_range=(cut, n), **kw)
    split = tail(z=head(z=tz, noise=tn[:cut], **io), noise=tn[cut:], **io)
    assert torch.equal(split, full)
    jio = {k_: jnp.asarray(v) for k_, v in (("observation", obs), ("mask", mask))} if imputation else {}
    _, ref = jfs.get_fast_pc_sampler(jsde.SubVPSDE(N=n), fm, params, SHAPE,
                                     corrector="langevin", imputation=imputation,
                                     step_range=(cut, n))(
        KEY, z=jnp.asarray(head(z=tz, noise=tn[:cut], **io).numpy()),
        noise=jnp.asarray(noise[cut:]), **jio)
    close(split, ref)
    g = torch.Generator().manual_seed(3)
    full_g = tfs.get_fast_pc_sampler(ts, tm, SHAPE, **kw)(g, z=tz, **io)
    g = torch.Generator().manual_seed(3)
    assert torch.equal(tail(g, z=head(g, z=tz, **io), **io), full_g)
    with pytest.raises(ValueError):
        tfs.get_fast_pc_sampler(ts, tm, SHAPE, step_range=(5, 21), device="cpu")


@pytest.mark.parametrize("corrector", ["none", "langevin"])
def test_pc_sampler_imputation_matches_fast_sampler(models, corrector):
    """The plain predictor-corrector loop with imputation is the tabled
    sampler's algorithm on the same slabs."""
    _, _, tm = models
    ts = tsde.SubVPSDE(N=20)
    k = (1 if corrector == "langevin" else 0) + 3
    z, noise = torch.from_numpy(_normal(SHAPE, 10)), torch.from_numpy(_normal((20, k) + SHAPE, 11))
    obs, mask = map(torch.from_numpy, _obs_mask())
    generic = get_pc_sampler(ts, SHAPE, get_score_fn(ts, tm), corrector=corrector,
                             imputation=True, device="cpu")(
        observation=obs, mask=mask, z=z, noise=noise)
    fast = tfs.get_fast_pc_sampler(ts, tm, SHAPE, corrector=corrector, imputation=True,
                                   device="cpu")(observation=obs, mask=mask, z=z, noise=noise)
    close(fast, generic)


@pytest.mark.parametrize("which", ["ddim", "dpm"])
def test_few_step_imputation_overwrites_observed_dims(models, which):
    """After the last row's re-imputation the observed dims hold the
    observation at the last grid point's noise level."""
    _, _, tm = models
    obs, mask = map(torch.from_numpy, _obs_mask())
    get = tfew.get_ddim_sampler if which == "ddim" else tfew.get_dpm_sampler
    sampler = get(tsde.SubVPSDE(N=1000), tm, SHAPE, n_steps=6, imputation=True,
                  denoise=which == "dpm", device="cpu")
    n_rows = 6 if which == "ddim" else 7
    noise = torch.zeros((n_rows, 2) + SHAPE)  # zero normals: obs*mean_coeff exactly
    nfe, out = sampler(torch.Generator().manual_seed(0), observation=obs, mask=mask,
                       noise=noise)
    assert nfe == n_rows and torch.isfinite(out).all()
    t_last = 1e-3 if which == "dpm" else float(tfew.step_grid(tsde.SubVPSDE(N=1000), 7, 1e-3)[-2])
    mc = float(tsde.SubVPSDE().marginal_prob(torch.ones(1), torch.tensor(t_last))[0])
    torch.testing.assert_close((out * mask), mc * obs * mask, rtol=1e-5, atol=1e-6)
    a = sampler(torch.Generator().manual_seed(1), observation=obs, mask=mask)[1]
    b = sampler(torch.Generator().manual_seed(1), observation=obs, mask=mask)[1]
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        sampler(observation=obs, mask=mask, noise=noise[:-1])


@pytest.mark.parametrize("which", ["ddim", "dpm", "hybrid", "cuda_ddim", "cuda_hybrid"])
def test_hypo_samplers_tile_rows(models, which):
    _, _, tm = models
    obs, mask = map(torch.from_numpy, _obs_mask())
    ts, hypo = tsde.SubVPSDE(N=40), 3
    kw = dict(device="cpu")
    if "hybrid" in which:
        kw.update(n_head=3, m_tail=4, tail_corrector="langevin")
    else:
        kw.update(n_steps=4)
    build = getattr(tfew, f"get_{which}_hypo_sampler")
    nfe, out = build(ts, tm, SHAPE, hypo, **kw)(torch.Generator().manual_seed(2), obs, mask)
    assert out.shape == (SHAPE[0], hypo, SHAPE[1]) and torch.isfinite(out).all()
    assert nfe == (3 + 4 * 2 if "hybrid" in which else 5)  # 4 steps + the x0 projection
    # hypotheses differ where the pose is sampled
    assert float((out[:, 0] - out[:, 1]).abs().max()) > 1e-3
