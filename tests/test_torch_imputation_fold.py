"""The masked re-noise folded into K2's EM epilogue (``head_em(...,
observed=...)``, the imputation instantiation of ``csrc/head_em.cu``) and the
kernel sampler's loop order around it.

On the CPU the wrappers run the plain versions: the fused plain K2 is held
bit for bit to the sequence it replaces (K2, then K4 at the step, then K4 at
the next step), the corrector-free imputation sampler to
``get_pallas_em_sampler(imputation=True, interpret=True)`` on the same
weights and injected noise, and the host slabs drawn one step ahead to the
draw order they replace. The CUDA kernel is held to the unfused kernels on
the card by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.ops.pallas.fused_em import get_pallas_em_sampler
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.ops.cuda import fused_em
from dposer_tpu_torch.ops.cuda.fused_em import (get_cuda_em_sampler, head_em,
                                                head_em_plain_into, host_slabs,
                                                masked_renoise_plain_into)

from test_torch_kernels import _head_inputs, _obs_mask
from test_torch_model import SMALL, flax_and_torch
from test_torch_sampling import _injected


def _fold_inputs(seed=21):
    h, w_post, _, b_post, coefs, x, z = _head_inputs(seed=seed)
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=x.shape).astype(np.float32)
    mask = (rng.random(x.shape) < 0.4).astype(np.float32)
    zp, zn = (rng.normal(size=x.shape).astype(np.float32) for _ in range(2))
    t = {k: torch.from_numpy(v) for k, v in dict(h=h, b_post=b_post, coefs=coefs, x=x, z=z,
                                                 obs=obs, mask=mask, zp=zp, zn=zn).items()}
    return t, w_post


@pytest.mark.parametrize("wrapper", [head_em_plain_into, head_em])
@pytest.mark.parametrize("renoise_next", [False, True])
def test_fused_head_em_equals_head_em_then_masked_renoise(wrapper, renoise_next):
    """The EM update with the re-noise after it (slab + 1) and, with
    ``renoise_next``, the next step's re-noise (its slab 0), against the
    plain K2 -> K4 (-> K4 at step + 1) on the same host slabs: the same
    bits, and x_mean the state before the re-noise."""
    t, w_post = _fold_inputs()
    step, slab = 2, 1
    observed = (t["obs"], t["mask"])
    zs = (t["zp"], t["zn"]) if renoise_next else (t["zp"],)
    x, x_mean = t["x"].clone(), torch.empty_like(t["x"])
    wrapper(t["h"], w_post, t["b_post"], t["coefs"], step, "em", x=x, x_mean=x_mean,
            noise=t["z"], slab=slab, observed=observed, renoise_noise=zs,
            renoise_next=0 if renoise_next else None)
    want, want_mean = t["x"].clone(), torch.empty_like(t["x"])
    head_em_plain_into(t["h"], w_post, t["b_post"], t["coefs"], step, "em", x=want,
                       x_mean=want_mean, noise=t["z"], slab=slab)
    assert torch.equal(x_mean, want_mean)
    em = want.clone()
    masked_renoise_plain_into(want, *observed, t["coefs"], step, noise=t["zp"], slab=slab + 1)
    if renoise_next:
        masked_renoise_plain_into(want, *observed, t["coefs"], step + 1, noise=t["zn"], slab=0)
    assert torch.equal(x, want)
    free = t["mask"] == 0  # the free dims keep the EM update, the observed ones do not
    assert torch.equal(x[free], em[free]) and not torch.equal(x[~free], em[~free])


def test_fused_head_em_rejects_bad_operands():
    t, w_post = _fold_inputs(seed=22)
    args = (t["h"], w_post, t["b_post"], t["coefs"])
    observed = (t["obs"], t["mask"])
    with pytest.raises(ValueError):  # the re-noise follows the EM update only
        head_em(*args, 1, "score", score=torch.empty_like(t["x"]),
                score_sq=torch.empty(t["x"].shape[0]), observed=observed)
    with pytest.raises(ValueError):  # two re-noises need two host slabs
        head_em(*args, 1, "em", x=t["x"].clone(), noise=t["z"], observed=observed,
                renoise_noise=(t["zp"],), renoise_next=0)
    with pytest.raises(ValueError):  # the next step's row must be in the table
        last = t["coefs"].shape[0] - 1
        head_em(*args, last, "em", x=t["x"].clone(), noise=t["z"], observed=observed,
                renoise_noise=(t["zp"], t["zn"]), renoise_next=0)
    with pytest.raises(ValueError):  # in-kernel normals need the card
        head_em(*args, 1, "em", x=t["x"].clone(), seed=3, observed=observed)


@pytest.mark.parametrize("denoise", [True, False])
def test_corrector_free_imputation_sampler_matches_pallas_interpret(denoise):
    """The corrector-free imputation sampler, whose K2 re-noises for the next
    step (plain versions on CPU tensors), against
    ``get_pallas_em_sampler(imputation=True)`` in interpret mode on identical
    z and [N, 3, B, D] slabs, at the bound of
    test_imputation_kernel_sampler_matches_pallas_interpret."""
    fm, params, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    n, shape = 20, (8, 63)
    z, noise = _injected(shape, n, 3, seed=23)
    obs, mask = _obs_mask(shape)
    kw = dict(eps=1e-3, corrector="none", imputation=True, denoise=denoise)
    _, ref = get_pallas_em_sampler(jsde.SubVPSDE(N=n), fm, params, shape, interpret=True,
                                   rng_mode="host", **kw)(
        jax.random.PRNGKey(0), observation=jnp.asarray(obs), mask=jnp.asarray(mask),
        z=jnp.asarray(z), noise=jnp.asarray(noise))
    ref = np.asarray(ref)
    out = get_cuda_em_sampler(tsde.SubVPSDE(N=n), tm, shape, device="cpu", **kw)(
        observation=torch.from_numpy(obs), mask=torch.from_numpy(mask),
        z=torch.from_numpy(z), noise=torch.from_numpy(noise))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2 * scale)
    # the observed dims went through no network: they agree to rounding
    np.testing.assert_allclose(out.numpy()[:, 39:45], ref[:, 39:45],
                               atol=(2e-2 if denoise else 1e-5) * scale)


@pytest.mark.parametrize("cut", [1, 13, 19])
def test_corrector_free_step_range_split_equals_full_run(cut):
    """Head then tail: the head's last K2 re-noises for no next step, the
    tail's first step runs K4; the full run's K2 at step cut - 1 re-noises
    for step cut. The same bits."""
    _, _, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    n, shape = 20, (6, 63)
    z, noise = (torch.from_numpy(a) for a in _injected(shape, n, 3, seed=24))
    io = {k: torch.from_numpy(a) for k, a in zip(("observation", "mask"), _obs_mask(shape))}
    kw = dict(corrector="none", imputation=True, device="cpu")
    ts = tsde.SubVPSDE(N=n)
    full = get_cuda_em_sampler(ts, tm, shape, **kw)(z=z, noise=noise, **io)
    head = get_cuda_em_sampler(ts, tm, shape, denoise=False, step_range=(0, cut), **kw)
    tail = get_cuda_em_sampler(ts, tm, shape, step_range=(cut, n), **kw)
    assert torch.equal(tail(z=head(z=z, noise=noise[:cut], **io), noise=noise[cut:], **io), full)


@pytest.mark.parametrize("source", ["generator", "injected"])
def test_host_slabs_drawn_ahead_are_the_step_order_draws(source):
    """Steps 3..9: a step's slabs, and the next step's drawn one step early,
    are what one torch.randn a step in step order draws from one generator,
    or the injected noise indexed by the step."""
    shape, lo, hi = (3, 5, 63), 3, 10
    g = torch.Generator().manual_seed(25)
    want = [torch.randn(shape, generator=g) for _ in range(lo, hi)]
    g = torch.Generator().manual_seed(25)
    noise = torch.stack(want) if source == "injected" else None
    got = list(host_slabs(noise, lo, hi, shape, g, "cpu"))
    assert len(got) == hi - lo
    for j, (slabs, nxt) in enumerate(got):
        assert torch.equal(slabs, want[j])
        if j + 1 < len(want):
            assert torch.equal(nxt, want[j + 1])
        else:
            assert nxt is None


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("corrector", ["none", "langevin"])
def test_masked_renoise_runs_standalone_once_a_call_without_corrector(monkeypatch, plain,
                                                                     corrector):
    """Mock-counted: without a corrector the standalone re-noise (K4) runs
    once a call, at its first step, and K2 re-noises every step (for the
    next one too, but at the last); after a corrector K4 runs once a step."""
    _, _, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    n, shape = 12, (5, 63)
    k = (1 if corrector == "langevin" else 0) + 3
    z, noise = (torch.from_numpy(a) for a in _injected(shape, n, k, seed=26))
    io = {k_: torch.from_numpy(a) for k_, a in zip(("observation", "mask"), _obs_mask(shape))}
    calls = {"renoise": [], "fold": []}
    names = ("masked_renoise_plain_into", "head_em_plain_into") if plain else \
        ("masked_renoise", "head_em")

    def counted(name, key):
        fn = getattr(fused_em, name)

        def wrapped(*a, **kw):
            if key == "renoise":
                calls[key].append(a[4])
            elif kw.get("observed") is not None:
                calls[key].append((a[4], kw.get("renoise_next")))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fused_em, names[0], counted(names[0], "renoise"))
    monkeypatch.setattr(fused_em, names[1], counted(names[1], "fold"))
    get_cuda_em_sampler(tsde.SubVPSDE(N=n), tm, shape, corrector=corrector, imputation=True,
                        device="cpu", plain=plain)(z=z, noise=noise, **io)
    if corrector == "none":
        assert calls["renoise"] == [0]
        assert calls["fold"] == [(i, 0 if i + 1 < n else None) for i in range(n)]
    else:
        assert calls["renoise"] == list(range(n))
        assert calls["fold"] == [(i, None) for i in range(n)]


def test_corrector_free_sampler_draws_its_slabs_in_step_order():
    """The sampler's own host draws (one step ahead) against the same
    generator's draws a step at a time injected as noise: the same bits."""
    _, _, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    n, shape = 12, (5, 63)
    z = torch.from_numpy(_injected(shape, n, 3, seed=27)[0])
    io = {k: torch.from_numpy(a) for k, a in zip(("observation", "mask"), _obs_mask(shape))}
    sampler = get_cuda_em_sampler(tsde.SubVPSDE(N=n), tm, shape, corrector="none",
                                  imputation=True, device="cpu")
    got = sampler(torch.Generator().manual_seed(28), z=z, **io)
    g = torch.Generator().manual_seed(28)
    noise = torch.stack([torch.randn((3,) + shape, generator=g) for _ in range(n)])
    assert torch.equal(got, sampler(z=z, noise=noise, **io))


def test_pc_step_with_in_kernel_normals_hands_k2_no_host_slabs(monkeypatch):
    """Mock-counted, in-kernel normals (seed=): no host slab exists, so K2
    gets the seed, its slab and the next step's re-noise slab, and K4 runs
    only where no K2 re-noised before it."""
    _, _, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    shape = (5, 63)
    net, coefs = fused_em.build_sampler_operands(tsde.SubVPSDE(N=6), tm, 1e-3,
                                                 "euler_maruyama", "cpu")
    calls = []
    monkeypatch.setattr(fused_em, "masked_renoise",
                        lambda *a, **kw: calls.append(("K4", a[4], kw["seed"], kw["slab"])))
    monkeypatch.setattr(fused_em, "head_em", lambda *a, **kw: calls.append(
        ("K2", a[4], kw["seed"], kw["slab"], kw["renoise_noise"], kw["renoise_next"])))
    x = torch.zeros(shape)
    observed = tuple(torch.from_numpy(a) for a in _obs_mask(shape))
    scratch = fused_em.pc_scratch(net, shape[0], 0, "cpu")
    for i in range(3):
        fused_em.pc_step(net, coefs, i, x, scratch, [None] * 3, n_corr=0, snr=0.16, seed=5,
                         observed=observed, renoised=i > 0, renoise_next=i < 2)
    assert calls == [("K4", 0, 5, 0), ("K2", 0, 5, 1, None, 0), ("K2", 1, 5, 1, None, 0),
                     ("K2", 2, 5, 1, None, None)]
    with pytest.raises(ValueError):  # after a corrector the re-noise is K4's
        fused_em.pc_step(net, coefs, 0, x, fused_em.pc_scratch(net, shape[0], 1, "cpu"),
                         [None] * 4, n_corr=1, snr=0.16, seed=5, observed=observed,
                         renoise_next=True)
