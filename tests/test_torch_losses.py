"""The port's losses, optimizer, EMA and rotations against the JAX package
(CPU): the same seeded weights, batches and noise through both.

The noise is JAX's own draw (its key split, as ``get_sde_loss_fn`` splits
it) injected into the port's losses, so each loss is held pointwise."""
import os

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import optax
import pytest
import torch

from dposer_tpu.body_model.smplx_jax import BodyModel as JaxBodyModel
from dposer_tpu.diffusion import losses as jlosses
from dposer_tpu.diffusion.ema import ema_init as jema_init, ema_update as jema_update
from dposer_tpu.diffusion.sde import SubVPSDE as JSubVP, VESDE as JVE, VPSDE as JVP
from dposer_tpu.models import ScoreModelFC as FlaxScoreModelFC, TimeMLPs as FlaxTimeMLPs
from dposer_tpu.models.score_mlp import make_model_apply as jmake_apply
from dposer_tpu.ops import rotations as jrot
from dposer_tpu_torch.body_model import BodyModel
from dposer_tpu_torch.diffusion import losses as tlosses
from dposer_tpu_torch.diffusion.sde import SubVPSDE, VESDE, VPSDE
from dposer_tpu_torch.models import ScoreModelFC, TimeMLPs
from dposer_tpu_torch.ops import rotations as trot
from dposer_tpu_torch.utils.checkpoint import state_dict_from_flax
from fixtures import make_synthetic_body_model

torch.set_num_threads(1)
B, D = 16, 63
SMALL = dict(n_poses=21, pose_dim=3, hidden_dim=128, embed_dim=32, n_blocks=2, dropout=0.0)
SDES = {"subvp": (JSubVP, SubVPSDE), "vp": (JVP, VPSDE), "ve": (JVE, VESDE)}


def models(seed=0, **kw):
    kw = dict(SMALL, **kw)
    fm = FlaxScoreModelFC(**kw)
    params = fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, D)), jnp.ones((1,)))["params"]
    params = jax.tree.map(np.asarray, params)
    tm = ScoreModelFC(**kw)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return fm, params, tm


def batch_np(seed=1, n=B):
    return (0.5 * np.random.default_rng(seed).normal(size=(n, D))).astype(np.float32)


def jax_tz(key, sde_j, batch, eps=1e-5):
    """The t and z JAX's continuous loss draws from ``key``."""
    k_t, k_z, _ = jax.random.split(key, 3)
    t = jax.random.uniform(k_t, (batch.shape[0],), jnp.float32, minval=eps, maxval=sde_j.T)
    z = jax.random.normal(k_z, batch.shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z))


def torch_grads_by_flax_name(model):
    """The port's grads in the flax layout (kernel [in, out], scale)."""
    out = {}
    for name, p in model.named_parameters():
        if name.startswith("pre_dense_cond"):
            continue
        prefix, leaf = name.rsplit(".", 1)
        flax = "shared_time_embed_0" if prefix == "shared_time_embed.0" else prefix
        g = p.grad.numpy()
        if "gnorm" in flax:
            out[(flax, "scale" if leaf == "weight" else "bias")] = g
        else:
            out[(flax, "kernel" if leaf == "weight" else "bias")] = g.T if leaf == "weight" else g
    return out


def assert_grads_close(jgrads, model, rel):
    tg = torch_grads_by_flax_name(model)
    for (mod, leaf), g in tg.items():
        ref = np.asarray(jgrads[mod][leaf])
        err = np.linalg.norm(g - ref) / (np.linalg.norm(ref) + 1e-12)
        assert err < rel, f"{mod}.{leaf}: relative error {err}"


@pytest.mark.parametrize("sde_name", ["subvp", "vp", "ve"])
@pytest.mark.parametrize("reduce_mean", [True, False])
@pytest.mark.parametrize("lw", [False, True])
def test_sde_loss_matches_jax(sde_name, reduce_mean, lw):
    fm, params, tm = models()
    sj, st = SDES[sde_name]
    sde_j, sde_t = sj(N=1000), st(N=1000)
    x = batch_np()
    key = jax.random.PRNGKey(7)
    jloss = jlosses.get_sde_loss_fn(sde_j, True, jmake_apply(fm), reduce_mean=reduce_mean,
                                    likelihood_weighting=lw)
    l_ref, g_ref = jax.value_and_grad(jloss)(params, key, jnp.asarray(x))
    t, z = jax_tz(key, sde_j, x)
    tloss = tlosses.get_sde_loss_fn(sde_t, True, tlosses.make_model_apply(tm),
                                    reduce_mean=reduce_mean, likelihood_weighting=lw)
    loss = tloss(tlosses.params_of(tm), torch.from_numpy(x), t=t, z=z)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-5)
    assert_grads_close(g_ref, tm, 1e-4)


@pytest.mark.parametrize("sde_name", ["subvp", "ve"])
def test_time_mlps_sde_loss_matches_jax(sde_name):
    """The DSM loss and its gradients through a TimeMLPs (the trainer's
    autograd route for it) on JAX's draws."""
    kw = dict(n_poses=21, pose_dim=3, hidden_dim=64, n_blocks=2, dropout=0.0)
    fm = FlaxTimeMLPs(**kw)
    params = jax.tree.map(np.asarray, fm.init(jax.random.PRNGKey(4), jnp.zeros((1, D)),
                                              jnp.ones((1,)))["params"])
    tm = TimeMLPs(**kw)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    sj, st = SDES[sde_name]
    sde_j, sde_t = sj(N=1000), st(N=1000)
    x = batch_np()
    key = jax.random.PRNGKey(9)
    jloss = jlosses.get_sde_loss_fn(sde_j, True, jmake_apply(fm), reduce_mean=True)
    l_ref, g_ref = jax.value_and_grad(jloss)(params, key, jnp.asarray(x))
    t, z = jax_tz(key, sde_j, x)
    loss = tlosses.get_sde_loss_fn(sde_t, True, tlosses.make_model_apply(tm), reduce_mean=True)(
        tlosses.params_of(tm), torch.from_numpy(x), t=t, z=z)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-5)
    ref_sd = state_dict_from_flax(jax.tree.map(np.asarray, g_ref))
    for name, p in tm.named_parameters():
        ref = ref_sd[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref) / (np.linalg.norm(ref) + 1e-12)
        assert err < 1e-4, f"{name}: relative error {err}"


def test_time_mlps_dropout_masks():
    """A TimeMLPs draws one [B, H] mask per hidden block, and the apply
    multiplies each block's activation by its mask."""
    tm = TimeMLPs(n_poses=21, pose_dim=3, hidden_dim=64, n_blocks=2, dropout=0.25)
    assert tlosses.dropout_layers(tm) == (0.25, 2)
    g = torch.Generator().manual_seed(0)
    masks = tlosses.draw_masks(tm, 5, "cpu", generator=g)
    assert len(masks) == 2 and all(m.shape == (5, 64) for m in masks)
    assert set(torch.unique(torch.cat(masks)).tolist()) <= {0.0, float(torch.tensor(1 / 0.75))}
    apply = tlosses.make_model_apply(tm)
    x, labels = torch.from_numpy(batch_np(n=5)), torch.full((5,), 321.0)
    ones = [torch.ones(5, 64)] * 2
    with torch.no_grad():
        torch.testing.assert_close(apply(tlosses.params_of(tm), x, labels, ones),
                                   tm.eval()(x, labels), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["smld", "ddpm"])
def test_discrete_losses_match_jax(kind):
    fm, params, tm = models()
    x = batch_np()
    key = jax.random.PRNGKey(3)
    k_l, k_z, _ = jax.random.split(key, 3)
    if kind == "smld":
        sde_j, sde_t = JVE(N=100), VESDE(N=100)
        jloss = jlosses.get_smld_loss_fn(sde_j, True, jmake_apply(fm), reduce_mean=False)
        tloss = tlosses.get_smld_loss_fn(sde_t, True, tlosses.make_model_apply(tm),
                                         reduce_mean=False)
    else:
        sde_j, sde_t = JVP(N=100), VPSDE(N=100)
        jloss = jlosses.get_ddpm_loss_fn(sde_j, True, jmake_apply(fm), reduce_mean=True)
        tloss = tlosses.get_ddpm_loss_fn(sde_t, True, tlosses.make_model_apply(tm),
                                         reduce_mean=True)
    labels = np.asarray(jax.random.randint(k_l, (B,), 0, sde_j.N))
    noise = np.asarray(jax.random.normal(k_z, x.shape, jnp.float32))
    l_ref, g_ref = jax.value_and_grad(jloss)(params, key, jnp.asarray(x))
    loss = tloss(tlosses.params_of(tm), torch.from_numpy(x),
                 labels=torch.from_numpy(labels).long(), noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-5)
    assert_grads_close(g_ref, tm, 1e-4)


def test_auxiliary_loss_matches_jax(tmp_path):
    """The auxiliary body loss (multi-step denoise, SMPL-X v2v and j2j) in
    the eval step under EMA parameters, on the synthetic SMPL-X body."""
    fm, params, tm = models()
    sde_j, sde_t = JSubVP(N=1000), SubVPSDE(N=1000)
    bm_path, _ = make_synthetic_body_model(str(tmp_path / "smplx.npz"), "smplx")
    jbody = JaxBodyModel(bm_path=bm_path, num_betas=10, batch_size=B, model_type="smplx")
    tbody = BodyModel(bm_path, num_betas=10, model_type="smplx")
    mean = np.linspace(-0.2, 0.2, D).astype(np.float32)
    std = np.linspace(0.5, 1.0, D).astype(np.float32)
    x = batch_np()
    key = jax.random.PRNGKey(11)

    def jbody_fn(pose):
        out = jbody(pose_body=pose)
        return out.v, out.Jtr

    def tbody_fn(pose):
        out = tbody(pose_body=pose)
        return out.v, out.Jtr

    jstep = jlosses.get_step_fn(
        sde_j, False, jmake_apply(fm), reduce_mean=True, auxiliary_loss=True,
        denormalize=lambda p: p * std + mean, body_model_fn=jbody_fn, rot_rep="axis",
        denoise_steps=3)
    jstate = jlosses.TrainState(step=jnp.asarray(0), params=params, opt_state=None,
                                ema=jema_init(params))
    _, ref = jstep(jstate, key, jnp.asarray(x))
    tstep = tlosses.get_step_fn(
        sde_t, False, tlosses.make_model_apply(tm), reduce_mean=True, auxiliary_loss=True,
        denormalize=lambda p: p * torch.from_numpy(std) + torch.from_numpy(mean),
        body_model_fn=tbody_fn, rot_rep="axis", denoise_steps=3)
    config = ml_collections.ConfigDict(dict(
        optim=dict(optimizer="Adam", lr=1e-3, beta1=0.9, eps=1e-8, warmup=0, grad_clip=1.0,
                   weight_decay=0),
        model=dict(ema_rate=0.999)))
    tstate = tlosses.init_train_state(config, tm)
    t, z = jax_tz(key, sde_j, x)
    got = tstep(tstate, torch.from_numpy(x), t=t, z=z)
    assert set(got) == set(ref) == {"step_loss", "score_loss", "v2v_loss", "j2j_loss"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, err_msg=k)
    # and the train step's gradient reaches the network through the body model
    tstep_train = tlosses.get_step_fn(
        sde_t, True, tlosses.make_model_apply(tm), reduce_mean=True, auxiliary_loss=True,
        denormalize=lambda p: p * torch.from_numpy(std) + torch.from_numpy(mean),
        body_model_fn=tbody_fn, rot_rep="axis", denoise_steps=3)
    tstep_train(tstate, torch.from_numpy(x), t=t, z=z)
    assert tstate.step == 1


def _opt_config(weight_decay=0.0):
    return ml_collections.ConfigDict(dict(
        optim=dict(optimizer="Adam", lr=1e-3, beta1=0.9, eps=1e-8, warmup=3, grad_clip=1.0,
                   weight_decay=weight_decay),
        model=dict(ema_rate=0.999)))


def _to_torch_layout(tree):
    return state_dict_from_flax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_optimizer_and_ema_match_optax(weight_decay):
    """Five updates on the same gradients (JAX's, of five batches) through
    optax and through the port's Tx and EMA: the first update at lr 0, the
    global-norm clip firing (an untrained net's gradient norm is far above
    1), weight decay after the clip, and the EMA's warm-up decay. Each
    element to 1e-5 relative, or 1e-7 (a ten-thousandth of one step at lr
    1e-3) where an update cancels a weight to near 0."""
    fm, params, tm = models()
    sde_j = JSubVP(N=1000)
    config = _opt_config(weight_decay)
    jstate, tx = jlosses.init_train_state(config, params)
    jloss = jlosses.get_sde_loss_fn(sde_j, True, jmake_apply(fm), reduce_mean=True)
    tstate = tlosses.init_train_state(config, tm)
    named = [(n, p) for n, p in tm.named_parameters() if p.requires_grad]
    p0 = {n: p.detach().clone() for n, p in named}
    for i in range(5):
        grads = jax.grad(jloss)(jstate.params, jax.random.PRNGKey(100 + i),
                                jnp.asarray(batch_np(seed=10 + i)))
        updates, opt_state = tx.update(grads, jstate.opt_state, jstate.params)
        new_params = optax.apply_updates(jstate.params, updates)
        jstate = jstate.replace(params=new_params, opt_state=opt_state,
                                ema=jema_update(jstate.ema, new_params))
        g = _to_torch_layout(grads)
        tstate.tx.zero_grad()
        for n, p in named:
            if not n.startswith("pre_dense_cond"):
                p.grad = g[n].clone()
        tlosses.apply_train_update(tstate)
        assert float(tstate.tx.last_norm) > 1.0, "the clip does not fire"
        if i == 0:  # lr 0 at the first update: nothing moved but Adam's moments
            assert all(torch.equal(p, p0[n]) for n, p in named)
        want, want_ema = _to_torch_layout(jstate.params), _to_torch_layout(jstate.ema.shadow_params)
        for (n, p), s in zip(named, tstate.ema.shadow_params):
            if n.startswith("pre_dense_cond"):
                continue
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{n} at update {i + 1}")
            np.testing.assert_allclose(s.numpy(), want_ema[n].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=f"ema {n} at update {i + 1}")
    assert tstate.ema.num_updates == int(jstate.ema.num_updates) == 5
    assert tstate.tx.count() == 5


def test_train_step_matches_jax_step():
    """Five whole train steps (loss, gradient, clip, Adam, EMA) against
    get_step_fn + optax on JAX's noise: the losses to 1e-5, each parameter
    leaf to 1e-3 relative (the two frameworks' gradients differ by float
    rounding, ~1e-5, and Adam carries that into every update)."""
    fm, params, tm = models()
    sde_j, sde_t = JSubVP(N=1000), SubVPSDE(N=1000)
    config = _opt_config()
    jstate, tx = jlosses.init_train_state(config, params)
    jstep = jlosses.get_step_fn(sde_j, True, jmake_apply(fm), tx=tx, reduce_mean=True)
    tstate = tlosses.init_train_state(config, tm)
    tstep = tlosses.get_step_fn(sde_t, True, tlosses.make_model_apply(tm), reduce_mean=True)
    for i in range(5):
        x = batch_np(seed=10 + i)
        key = jax.random.PRNGKey(100 + i)
        jstate, jld = jstep(jstate, key, jnp.asarray(x))
        t, z = jax_tz(key, sde_j, x)
        ld = tstep(tstate, torch.from_numpy(x), t=t, z=z)
        np.testing.assert_allclose(float(ld["step_loss"]), float(jld["step_loss"]), rtol=1e-5)
    want = _to_torch_layout(jstate.params)
    for n, p in tm.named_parameters():
        if not n.startswith("pre_dense_cond"):
            rel = float((p.detach() - want[n]).norm() / max(float(want[n].norm()), 1e-6))
            assert rel < 1e-3, f"{n}: relative error {rel}"
    assert tstate.step == int(jstate.step) == 5


def test_clip_rule_is_optax():
    """No scaling below the threshold; ``max_norm / norm`` at or above it."""
    g = [torch.full((4,), 0.25), torch.full((2, 2), 0.25)]  # norm 0.7071
    norm = tlosses.clip_by_global_norm_(g, 1.0)
    assert abs(float(norm) - 0.5 ** 0.5) < 1e-6
    assert all(torch.equal(t, torch.full_like(t, 0.25)) for t in g)
    g = [torch.full((4,), 3.0), torch.full((2, 2), 4.0)]  # norm 10
    tlosses.clip_by_global_norm_(g, 1.0)
    np.testing.assert_allclose(g[0].numpy(), 0.3, rtol=1e-6)
    np.testing.assert_allclose(g[1].numpy(), 0.4, rtol=1e-6)


def _aa(rng, n, small=False):
    scale = 1e-5 if small else 1.5
    return (scale * rng.normal(size=(n, 3))).astype(np.float32)


def _rot(rng, n):
    return np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(_aa(rng, n))))


def _pts(rng, n=20):
    return rng.normal(size=(n, 3)).astype(np.float32)


ROTATION_CASES = {
    "axis_angle_to_matrix": lambda r: (_aa(r, 32),),
    "axis_angle_to_matrix_small": lambda r: (_aa(r, 8, small=True),),
    "matrix_to_quaternion": lambda r: (_rot(r, 32),),
    "quaternion_to_axis_angle": lambda r: (
        np.asarray(jrot.matrix_to_quaternion(jnp.asarray(_rot(r, 32)))),),
    "matrix_to_axis_angle": lambda r: (_rot(r, 32),),
    "rot6d_to_matrix": lambda r: (r.normal(size=(32, 6)).astype(np.float32),),
    "matrix_to_rot6d": lambda r: (_rot(r, 32),),
    "axis_angle_to_rot6d": lambda r: (_aa(r, 32),),
    "rot6d_to_axis_angle": lambda r: (r.normal(size=(32, 6)).astype(np.float32),),
    "cam_crop2full": lambda r: (r.uniform(0.5, 1.5, (8, 3)).astype(np.float32),
                                r.uniform(50, 200, (8, 2)).astype(np.float32),
                                r.uniform(0.5, 2, (8,)).astype(np.float32),
                                np.tile(np.float32([[480, 640]]), (8, 1)),
                                np.float32(800.0)),
    "estimate_focal_length": lambda r: (np.float32(480.0), np.float32(640.0)),
    "world_to_camera_frame": lambda r: (_pts(r), _rot(r, 1)[0], _pts(r, 1).T),
    "camera_to_world_frame": lambda r: (_pts(r), _rot(r, 1)[0], _pts(r, 1).T),
    "cam2pixel": lambda r: (_pts(r) + np.float32([0, 0, 5]), np.float32([500, 510]),
                            np.float32([320, 240])),
    "pixel2cam": lambda r: (_pts(r) + np.float32([0, 0, 5]), np.float32([500, 510]),
                            np.float32([320, 240])),
    "rotate_points": lambda r: (_pts(r), _rot(r, 1)[0]),
    "get_rotation_matrix_x": lambda r: (np.float32(0.7),),
    "get_rotation_matrix_y": lambda r: (np.float32(-1.2),),
    "procrustes": lambda r: (_pts(r), _pts(r)),
    "align_to_gt": lambda r: (_pts(r), _pts(r)),
    "rigid_transform_3d": lambda r: (_pts(r), _pts(r)),
    "rigid_align": lambda r: (_pts(r), _pts(r)),
}


def _leaves(out):
    if isinstance(out, dict):
        return [v for k in sorted(out) for v in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in _leaves(o)]
    return [np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out, np.float64)]


@pytest.mark.parametrize("case", sorted(ROTATION_CASES))
def test_rotations_match_jax(case):
    name = case.replace("_small", "")
    args = ROTATION_CASES[case](np.random.default_rng(5))
    ref = getattr(jrot, name)(*[jnp.asarray(a) for a in args])
    got = getattr(trot, name)(*[torch.as_tensor(a) for a in args])
    for g, r in zip(_leaves(got), _leaves(ref), strict=True):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=2e-5, err_msg=case)


def test_port_files_import_neither_jax_nor_the_jax_package():
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "dposer_tpu_torch")
    bad = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            for i, line in enumerate(open(path), 1):
                s = line.strip()
                if s.startswith(("import ", "from ")) and (
                        s.split()[1].split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                       "dposer_tpu")):
                    bad.append(f"{path}:{i}: {s}")
    assert not bad, bad
