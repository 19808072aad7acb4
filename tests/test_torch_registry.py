"""The port's predictor-corrector registry, ``get_pc_sampler``'s
``return_trajectory`` and ``start_step``, the guided EM update, the kernel
sampler's ``trajectory_steps`` and TimeMLPs, against the JAX package on the
same inputs with JAX's normals injected (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu.diffusion import sampling as jsampling
from dposer_tpu.diffusion import sde as jsde
from dposer_tpu.diffusion.score_fn import get_score_fn as jax_get_score_fn
from dposer_tpu.models import TimeMLPs as FlaxTimeMLPs
from dposer_tpu_torch.config import get_config
from dposer_tpu_torch.diffusion import sampling as tsampling
from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.score_fn import get_score_fn
from dposer_tpu_torch.models import TimeMLPs, create_score_model
from dposer_tpu_torch.ops.cuda.fused_em import get_cuda_em_sampler
from dposer_tpu_torch.parallel import make_mesh
from dposer_tpu_torch.utils.checkpoint import (load_params_for_inference,
                                               state_dict_from_flax,
                                               time_mlps_parameter_order)

from test_torch_model import SMALL, flax_and_torch

M0, S0, DIM, B = 0.7, 0.6, 4, 6
SDES = {"vp": (jsde.VPSDE, tsde.VPSDE, 1e-3), "subvp": (jsde.SubVPSDE, tsde.SubVPSDE, 1e-3),
        "ve": (jsde.VESDE, tsde.VESDE, 1e-5)}
STEP_TOL, RUN_TOL = 1e-5, 1e-4  # times max(1, |ref|): one update; a whole run


def _pair(name, n=20):
    jcls, tcls, eps = SDES[name]
    return jcls(N=n), tcls(N=n), eps


def _jscore(sde):
    """The score of Gaussian data N(M0, S0^2) at time t, in closed form."""
    def score(x, t):
        mean, std = sde.marginal_prob(jnp.ones_like(x), jnp.broadcast_to(t, x.shape[:1]))
        return -(x - mean * M0) / ((mean * S0) ** 2 + std[:, None] ** 2)

    return score


def _tscore(sde):
    def score(x, t):
        mean, std = sde.marginal_prob(torch.ones_like(x), t.expand(x.shape[0]))
        return -(x - mean * M0) / ((mean * S0) ** 2 + std[:, None] ** 2)

    return score


def _t(a):
    return torch.from_numpy(np.array(a))


def close(out, ref, tol):
    ref = np.asarray(ref)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _state_and_time(js, eps, vector, seed=0):
    rng = np.random.default_rng(seed)
    x = (M0 + 2.0 * rng.normal(size=(B, DIM))).astype(np.float32)
    grid = np.asarray(js.timesteps(eps))
    t = grid[rng.integers(0, js.N, size=B)] if vector else grid[js.N // 3]
    return x, np.asarray(t, np.float32)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar_t", "row_t"])
@pytest.mark.parametrize("sde,predictor", [
    ("subvp", "euler_maruyama"), ("vp", "reverse_diffusion"), ("ve", "reverse_diffusion"),
    ("vp", "ancestral_sampling"), ("ve", "ancestral_sampling"), ("subvp", "none")])
def test_predictor_step_matches_jax(sde, predictor, vector):
    js, ts, eps = _pair(sde)
    x, t = _state_and_time(js, eps, vector)
    key = jax.random.PRNGKey(3)
    ref = jsampling.get_predictor(predictor)(js, _jscore(js))(key, jnp.asarray(x),
                                                               jnp.asarray(t))
    z = jax.random.normal(key, x.shape, jnp.float32)
    out = tsampling.get_predictor(predictor)(ts, _tscore(ts))(_t(x), _t(t), _t(z))
    for o, r in zip(out, ref):
        close(o, r, STEP_TOL)


def test_ancestral_predictor_refuses_subvp_and_probability_flow():
    for get in (jsampling.get_predictor, tsampling.get_predictor):
        with pytest.raises(NotImplementedError):
            get("ancestral_sampling")(jsde.SubVPSDE(N=20) if get is jsampling.get_predictor
                                      else tsde.SubVPSDE(N=20), None)
    with pytest.raises(AssertionError):
        tsampling.get_predictor("ancestral_sampling")(tsde.VPSDE(N=20), None, True)


def test_ve_ancestral_first_step_has_no_noise():
    """At grid step 0 VE's adjacent sigma is 0, so the update is the mean."""
    _, ts, _ = _pair("ve")
    x = torch.ones(B, DIM)
    new, mean = tsampling.get_predictor("ancestral_sampling")(ts, _tscore(ts))(
        x, torch.tensor(0.0), torch.ones(B, DIM))
    assert torch.equal(new, mean)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar_t", "row_t"])
@pytest.mark.parametrize("sde", ["vp", "subvp", "ve"])
@pytest.mark.parametrize("corrector", ["langevin", "ald", "none"])
def test_corrector_matches_jax(corrector, sde, vector):
    js, ts, eps = _pair(sde)
    x, t = _state_and_time(js, eps, vector, seed=1)
    key, n_steps = jax.random.PRNGKey(5), 2
    ref = jsampling.get_corrector(corrector)(js, _jscore(js), 0.16, n_steps)(
        key, jnp.asarray(x), jnp.asarray(t))
    zs = [jax.random.normal(jax.random.fold_in(key, i), x.shape, jnp.float32)
          for i in range(n_steps)]
    out = tsampling.get_corrector(corrector)(ts, _tscore(ts), 0.16, n_steps)(
        _t(x), _t(t), _t(np.stack(zs)))
    for o, r in zip(out, ref):
        close(o, r, STEP_TOL)


def jax_pc_noise(key, n, start, shape, n_corr, imputation):
    """The draws of JAX's ``get_pc_sampler`` at steps ``start..n-1`` in the
    port's slab order (corr_0.., imput_c, predictor, imput_p): ``kc, kci,
    kp, kpi = split(fold_in(key, i), 4)``, the corrector's step j from
    ``fold_in(kc, j)`` (sampling.py:255)."""
    steps = []
    for i in range(start, n):
        kc, kci, kp, kpi = jax.random.split(jax.random.fold_in(key, i), 4)
        slabs = [jax.random.normal(jax.random.fold_in(kc, j), shape) for j in range(n_corr)]
        if imputation:
            slabs.append(jax.random.normal(kci, shape))
        slabs.append(jax.random.normal(kp, shape))
        if imputation:
            slabs.append(jax.random.normal(kpi, shape))
        steps.append(np.stack([np.asarray(s) for s in slabs]))
    return np.stack(steps).astype(np.float32)


PC_CASES = [("subvp", "euler_maruyama", "langevin", False, 0),
            ("vp", "ancestral_sampling", "ald", False, 5),
            ("ve", "reverse_diffusion", "ald", True, 0),
            ("ve", "ancestral_sampling", "none", False, 12),
            ("subvp", "euler_maruyama", "none", True, 7),
            ("vp", "none", "langevin", False, 0)]


@pytest.mark.parametrize("sde,predictor,corrector,imputation,start", PC_CASES)
def test_pc_sampler_trajectory_and_start_step_match_jax(sde, predictor, corrector, imputation,
                                                        start):
    js, ts, eps = _pair(sde)
    shape = (B, DIM)
    rng = np.random.default_rng(2)
    z = rng.normal(size=shape).astype(np.float32) * (1.0 if sde != "ve" else 50.0)
    obs = rng.normal(size=shape).astype(np.float32)
    mask = (rng.uniform(size=shape) < 0.5).astype(np.float32)
    kw = dict(predictor=predictor, corrector=corrector, snr=0.16, n_steps=1, eps=eps,
              imputation=imputation, start_step=start, return_trajectory=True)
    key = jax.random.PRNGKey(9)
    imp = dict(observation=obs, mask=mask) if imputation else {}
    rtrajs, rx = jsampling.get_pc_sampler(js, shape, _jscore(js), jit=False, **kw)(
        key, z=jnp.asarray(z), **{k: jnp.asarray(v) for k, v in imp.items()})
    noise = jax_pc_noise(key, js.N, start, shape, 0 if corrector == "none" else 1, imputation)
    trajs, x = tsampling.get_pc_sampler(ts, shape, _tscore(ts), device="cpu", **kw)(
        z=_t(z), noise=_t(noise), **{k: _t(v) for k, v in imp.items()})
    assert trajs.shape == (js.N - start,) + shape
    close(trajs, rtrajs, RUN_TOL)
    close(x, rx, RUN_TOL)
    # without the trajectory the sampler returns the final state alone
    plain = tsampling.get_pc_sampler(ts, shape, _tscore(ts), device="cpu",
                                     **dict(kw, return_trajectory=False))(
        z=_t(z), noise=_t(noise), **{k: _t(v) for k, v in imp.items()})
    assert torch.equal(plain, x)


def test_guided_em_update_matches_jax():
    js, ts, eps = _pair("subvp", 50)
    x, t = _state_and_time(js, eps, True, seed=4)
    rng = np.random.default_rng(5)
    obs = rng.normal(size=x.shape).astype(np.float32)
    mask = (rng.uniform(size=x.shape) < 0.5).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = jsampling.get_guided_em_update(js, _jscore(js), grad_step=0.7)(
        key, jnp.asarray(x), jnp.asarray(t), jnp.asarray(obs), jnp.asarray(mask))
    z = jax.random.normal(key, x.shape, jnp.float32)
    out = tsampling.get_guided_em_update(ts, _tscore(ts), grad_step=0.7)(
        _t(x), _t(t), _t(obs), _t(mask), _t(z))
    for o, r in zip(out, ref):
        close(o, r, RUN_TOL)


def _kernel_case(corrector, imputation, n=20, batch=4):
    _, _, tm = flax_and_torch(**dict(SMALL, scale_by_sigma=True))
    ts = tsde.SubVPSDE(N=n)
    k = (2 if corrector == "langevin" else 1) + (2 if imputation else 0)
    rng = np.random.default_rng(13)
    inputs = dict(z=_t(rng.normal(size=(batch, 63)).astype(np.float32)),
                  noise=_t(rng.normal(size=(n, k, batch, 63)).astype(np.float32)))
    if imputation:
        inputs.update(observation=_t(rng.normal(size=(batch, 63)).astype(np.float32)),
                      mask=_t((rng.uniform(size=(batch, 63)) < 0.5).astype(np.float32)))
    kw = dict(corrector=corrector, imputation=imputation, device="cpu", plain=True)
    return tm, ts, inputs, kw


STEPS = (0, 4, 9, 13, 19)


@pytest.mark.parametrize("corrector,imputation", [("none", False), ("langevin", False),
                                                  ("none", True), ("langevin", True)])
def test_kernel_sampler_trajectory(corrector, imputation):
    """``trajectory_steps`` on the plain route: the final state bit-equal to
    the sampler without it, each frame bit-equal to a ``step_range=(0, s +
    1)`` call without the denoise, and the frames within the kernels'
    bf16 bound of the plain PC loop's trajectory on the same noise."""
    tm, ts, inputs, kw = _kernel_case(corrector, imputation)
    shape = tuple(inputs["z"].shape)
    trajs, x = get_cuda_em_sampler(ts, tm, shape, trajectory_steps=STEPS, **kw)(**inputs)
    assert trajs.shape == (len(STEPS),) + shape
    assert torch.equal(x, get_cuda_em_sampler(ts, tm, shape, **kw)(**inputs))
    for j, s in enumerate(STEPS):
        head = get_cuda_em_sampler(ts, tm, shape, denoise=False, step_range=(0, s + 1), **kw)
        assert torch.equal(trajs[j], head(**dict(inputs, noise=inputs["noise"][:s + 1]))), s
    ref, _ = tsampling.get_pc_sampler(ts, shape, get_score_fn(ts, tm), corrector=corrector,
                                      imputation=imputation, device="cpu",
                                      return_trajectory=True)(**inputs)
    ref = ref[list(STEPS)]
    # the kernels round the matmul operands to bf16 (test_torch_kernels.py's bound)
    close(trajs, ref, 2e-2)


@pytest.mark.parametrize("corrector", ["none", "langevin"])
def test_kernel_sampler_trajectory_on_a_mesh(corrector):
    """On a CPU mesh of two shards each shard records its own rows: the
    joined trajectory's rows are those of the single-device sampler on the
    shard's rows, the trajectories joined along their rows (axis 1)."""
    tm, ts, inputs, kw = _kernel_case(corrector, False)
    shape = tuple(inputs["z"].shape)
    mesh = make_mesh(devices=["cpu"] * 2)
    trajs, x = get_cuda_em_sampler(ts, tm, shape, trajectory_steps=STEPS, mesh=mesh,
                                   **kw)(**inputs)
    assert trajs.shape == (len(STEPS),) + shape
    half = shape[0] // 2
    for r in range(2):
        rows = slice(r * half, (r + 1) * half)
        t_r, x_r = get_cuda_em_sampler(ts, tm, (half, 63), trajectory_steps=STEPS, **kw)(
            z=inputs["z"][rows], noise=inputs["noise"][:, :, rows].contiguous())
        assert torch.equal(trajs[:, rows], t_r) and torch.equal(x[rows], x_r)


def test_kernel_sampler_trajectory_checks():
    tm, ts, inputs, kw = _kernel_case("none", False)
    with pytest.raises(ValueError, match="trajectory_steps"):
        get_cuda_em_sampler(ts, tm, (4, 63), trajectory_steps=[20], **kw)
    with pytest.raises(ValueError, match="trajectory_steps"):
        get_cuda_em_sampler(ts, tm, (4, 63), trajectory_steps=[3, 3], **kw)
    with pytest.raises(ValueError, match="trajectory_steps"):
        get_cuda_em_sampler(ts, tm, (4, 63), trajectory_steps=[3], step_range=(5, 10), **kw)


def _time_mlps(seed=0):
    fm = FlaxTimeMLPs(n_poses=21, pose_dim=3, hidden_dim=64, n_blocks=2, dropout=0.0)
    params = jax.tree.map(np.asarray, fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 63)),
                                               jnp.ones((1,)))["params"])
    tm = TimeMLPs(n_poses=21, pose_dim=3, hidden_dim=64, n_blocks=2, dropout=0.0).eval()
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return fm, params, tm


def test_time_mlps_matches_flax():
    fm, params, tm = _time_mlps()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(7, 63)).astype(np.float32)
    for t in (np.float32(321.0), rng.uniform(0, 999, size=(7,)).astype(np.float32)):
        ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
        with torch.no_grad():
            close(tm(_t(x), _t(t)), ref, 1e-5)


def test_time_mlps_reference_pth_round_trip(tmp_path):
    """A reference-layout TimeMLPs ``.pth`` (``net.*`` keys, the EMA shadow
    in parameter order) loads into the port's module, the EMA taken."""
    _, _, tm = _time_mlps()
    assert [n for n, _ in tm.named_parameters()] == time_mlps_parameter_order(2)
    sd = tm.state_dict()
    shadow = [sd[n] * 0.5 for n in time_mlps_parameter_order(2)]
    torch.save({"model_state_dict": sd, "optimizer_state_dict": {}, "epoch": 0, "step": 3,
                "ema": {"decay": 0.99, "num_updates": 3, "shadow_params": shadow}},
               tmp_path / "tm.pth")
    loaded, step = load_params_for_inference(str(tmp_path / "tm.pth"))
    config = get_config()
    config.model.type, config.model.HIDDEN_DIM, config.model.N_BLOCKS = "TimeMLPs", 64, 2
    config.data.rot_rep = "axis"
    model = create_score_model(config)
    assert isinstance(model, TimeMLPs)
    model.load_state_dict(loaded, strict=True)
    assert step == 3
    for n, s in zip(time_mlps_parameter_order(2), shadow):
        assert torch.equal(model.state_dict()[n], s)


@pytest.mark.parametrize("predictor,corrector", [("ancestral_sampling", "none"),
                                                 ("euler_maruyama", "ald")])
def test_time_mlps_samples_like_jax(predictor, corrector):
    """A TimeMLPs model through the ancestral predictor and through ald at N =
    20 (VP at beta_1 10: at 20 the last DDPM beta of beta_1 20 is 1, where the
    ancestral update divides by 0) on JAX's draws: no kernel covers it, the
    plain PC loop does."""
    fm, params, tm = _time_mlps(seed=1)
    js, ts = jsde.VPSDE(beta_1=10.0, N=20), tsde.VPSDE(beta_1=10.0, N=20)
    shape, key = (5, 63), jax.random.PRNGKey(2)
    z = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    kw = dict(predictor=predictor, corrector=corrector, snr=0.16, n_steps=1, eps=1e-3)
    jscore = jax_get_score_fn(js, lambda x, t: fm.apply({"params": params}, x, t))
    _, ref = jsampling.get_pc_sampler(js, shape, jscore, jit=False, **kw)(key, z=jnp.asarray(z))
    noise = jax_pc_noise(key, 20, 0, shape, 0 if corrector == "none" else 1, False)
    out = tsampling.get_pc_sampler(ts, shape, get_score_fn(ts, tm), device="cpu", **kw)(
        z=_t(z), noise=_t(noise))
    assert np.isfinite(np.asarray(ref)).all()
    close(out, ref, RUN_TOL)
