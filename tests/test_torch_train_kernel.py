"""The kernel route of the DSM train step (ops/cuda/fused_train.py) on the
CPU, where its wrappers run the kernels' plain versions, against the JAX
package: its fused train kernel in interpret mode and
``jax.value_and_grad(get_sde_loss_fn)``, on the same seeded weights and
batch, with JAX's t and z injected (its key split, fused_train.py:439).

The dropout streams differ by design (a counter hash here, the TPU's PRNG
there), so JAX is compared at dropout 0; at dropout 0.1 the route is held
to autograd of the network fed the same hash masks, and the masks to their
keep rate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dposer_tpu.diffusion import losses as jlosses
from dposer_tpu.diffusion.sde import SubVPSDE as JSubVP, VPSDE as JVP
from dposer_tpu.models import ScoreModelFC as FlaxScoreModelFC
from dposer_tpu.models.score_mlp import make_model_apply as jmake_apply
from dposer_tpu.ops.pallas.fused_train import get_pallas_train_loss_and_grad
from dposer_tpu_torch.diffusion import losses as tlosses
from dposer_tpu_torch.diffusion.sde import SubVPSDE, VESDE, VPSDE
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.ops.cuda import fused_train as ft
from dposer_tpu_torch.utils.checkpoint import state_dict_from_flax

torch.set_num_threads(1)
B, D, H = 32, 63, 128
SMALL = dict(n_poses=21, pose_dim=3, hidden_dim=H, embed_dim=32, n_blocks=2)


def models(dropout=0.0, seed=0):
    kw = dict(SMALL, dropout=dropout)
    fm = FlaxScoreModelFC(**kw)
    params = fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, D)), jnp.ones((1,)))["params"]
    params = jax.tree.map(np.asarray, params)
    tm = ScoreModelFC(**kw)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return fm, params, tm


def batch_np(seed=1):
    return (0.3 * np.random.default_rng(seed).normal(size=(B, D))).astype(np.float32)


def jax_tz(key, sde_j, eps=1e-5):
    k_t, k_z, _ = jax.random.split(key, 3)
    t = jax.random.uniform(k_t, (B,), jnp.float32, minval=eps, maxval=sde_j.T)
    z = jax.random.normal(k_z, (B, D), jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z))


def flax_layout(grads):
    """The port's {name: grad} in JAX's {module: {leaf}} layout."""
    out = {}
    for name, g in grads.items():
        if name.startswith("pre_dense_cond"):
            continue
        prefix, leaf = name.rsplit(".", 1)
        mod = "shared_time_embed_0" if prefix == "shared_time_embed.0" else prefix
        g = g.detach().numpy()
        if "gnorm" in mod:
            out.setdefault(mod, {})["scale" if leaf == "weight" else "bias"] = g
        elif leaf == "weight":
            out.setdefault(mod, {})["kernel"] = g.T
        else:
            out.setdefault(mod, {})["bias"] = g
    return out


def leaf_pairs(ref, got):
    for mod, leaves in ref.items():
        for leaf, r in leaves.items():
            yield f"{mod}.{leaf}", np.asarray(r).ravel(), got[mod][leaf].ravel()


@pytest.mark.parametrize("sde_name", ["subvp", "vp"])
@pytest.mark.parametrize("reduce_mean", [True, False])
@pytest.mark.parametrize("lw", [False, True])
def test_fp32_route_matches_jax(sde_name, reduce_mean, lw):
    """fp32 exactness mode: loss to 1e-4 and every gradient leaf to 5e-4
    relative, against JAX's kernel (fp32, interpret mode) and against
    value_and_grad of its XLA loss (JAX's own bar, test_pallas_train.py)."""
    sj, st = {"subvp": (JSubVP, SubVPSDE), "vp": (JVP, VPSDE)}[sde_name]
    fm, params, tm = models()
    x = batch_np()
    key = jax.random.PRNGKey(7)
    jloss = jlosses.get_sde_loss_fn(sj(N=1000), True, jmake_apply(fm), reduce_mean=reduce_mean,
                                    likelihood_weighting=lw)
    refs = [jax.value_and_grad(jloss)(params, key, jnp.asarray(x)),
            get_pallas_train_loss_and_grad(sj(N=1000), fm, reduce_mean=reduce_mean,
                                           likelihood_weighting=lw, interpret=True,
                                           compute_dtype=jnp.float32)(params, key,
                                                                      jnp.asarray(x))]
    t, z = jax_tz(key, sj(N=1000))
    loss, grads = ft.get_cuda_train_loss_and_grad(
        st(N=1000), tm, reduce_mean=reduce_mean, likelihood_weighting=lw,
        compute_dtype=torch.float32)(torch.from_numpy(x), t=t, z=z, dropout_seed=0)
    got = flax_layout(grads)
    for l_ref, g_ref in refs:
        np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-4)
        for name, r, g in leaf_pairs(g_ref, got):
            rel = np.linalg.norm(g - r) / (np.linalg.norm(r) + 1e-12)
            assert rel < 5e-4, f"{name}: relative error {rel}"


def test_bf16_route_close_to_fp32_jax():
    """The card's mode (bf16 operands, fp32 GroupNorm) against JAX's fp32
    value_and_grad: loss to 3e-3, each leaf at cosine > 0.995 and relative
    error < 0.12 (JAX's bar for its bf16 kernel)."""
    fm, params, tm = models()
    x = batch_np()
    key = jax.random.PRNGKey(7)
    jloss = jlosses.get_sde_loss_fn(JSubVP(N=1000), True, jmake_apply(fm), reduce_mean=True)
    l_ref, g_ref = jax.value_and_grad(jloss)(params, key, jnp.asarray(x))
    t, z = jax_tz(key, JSubVP(N=1000))
    loss, grads = ft.get_cuda_train_loss_and_grad(SubVPSDE(N=1000), tm, reduce_mean=True)(
        torch.from_numpy(x), t=t, z=z, dropout_seed=0)
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=3e-3)
    for name, r, g in leaf_pairs(g_ref, flax_layout(grads)):
        cos = float((r * g).sum() / (np.linalg.norm(r) * np.linalg.norm(g) + 1e-30))
        rel = np.linalg.norm(g - r) / (np.linalg.norm(r) + 1e-12)
        assert cos > 0.995 and rel < 0.12, f"{name}: cosine {cos}, relative error {rel}"


def _layer_inputs(seed, K=H, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)

    def rn(*s, sc=1.0):
        return sc * torch.randn(*s, generator=g)

    return (rn(B, K), rn(K, H, sc=K ** -0.5).to(dtype), rn(B, H, sc=0.3).to(dtype),
            1 + 0.1 * rn(H), 0.1 * rn(H), rn(B, H), rn(B, H))


@pytest.mark.parametrize("keep", [1.0, 0.9])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("K", [63, H])
def test_layer_plain_versions_match_autograd(keep, residual, K):
    """Plain K10 against one layer written with F.group_norm and F.silu, and
    plain K12 against its autograd VJP (with W^T the identity, so the hop
    hands the cotangent through unchanged; g_res adds a second one)."""
    a, w, proj, gamma, beta, res, cot = _layer_inputs(3, K)
    seed, layer = 12345, 2
    mask = ft.dropout_mask(seed, layer, B, H, keep)
    resid = res if residual else None
    out, stash, xhat, rstd = ft.dense_gn_silu_train_plain(a, w, proj, gamma, beta, seed, layer,
                                                          keep, resid)
    h = (a @ w + proj).requires_grad_(True)
    gm, bt = gamma.clone().requires_grad_(True), beta.clone().requires_grad_(True)
    y = F.silu(F.group_norm(h, 32, gm, bt, eps=1e-5))
    if mask is not None:
        y = y * mask
    if resid is not None:
        y = y + resid
    torch.testing.assert_close(out, y.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stash, out)
    dh_ref, dg_ref, db_ref = torch.autograd.grad(y, (h, gm, bt), cot + res)
    dh, g, dg, db = ft.dense_gn_silu_bwd_plain(cot, torch.eye(H), xhat, rstd, gamma, beta,
                                               seed, layer, keep, g_res=res)
    torch.testing.assert_close(g, cot + res)
    for got, want in ((dh, dh_ref), (dg, dg_ref), (db, db_ref)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_dropout_hash_is_murmur3_fmix32():
    """The int64 tensor arithmetic against numpy's wrapping uint32 arithmetic."""
    def fmix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))

    seed, layer, rows, cols = 0xDEADBEEF, 4, 40, 70
    with np.errstate(over="ignore"):
        lkey = fmix(np.uint32(seed) ^ fmix(np.uint32((layer + 0x9E3779B9) & 0xFFFFFFFF)))
        rkey = fmix(lkey ^ (np.arange(rows, dtype=np.uint32) * np.uint32(0x9E3779B9)))
        u = fmix(rkey[:, None] ^ (np.arange(cols, dtype=np.uint32) * np.uint32(0x85EBCA6B)))
    want = (u >> np.uint32(8)) < np.uint32(ft.keep_threshold(0.9))
    np.testing.assert_array_equal(ft.dropout_keep(seed, layer, rows, cols, 0.9).numpy(), want)


def test_dropout_masks_regenerate_and_keep_rate():
    """K12 regenerates K10's mask from (seed, layer): the elements K10
    zeroed take no gradient, and a different layer or seed gives another
    mask. The keep rate over 1M elements lies within 5 binomial sigmas."""
    a, w, proj, gamma, beta, res, cot = _layer_inputs(4)
    seed, keep = 777, 0.9
    out, _, xhat, rstd = ft.dense_gn_silu_train_plain(a, w, proj, gamma, beta, seed, 1, keep)
    dropped = ~ft.dropout_keep(seed, 1, B, H, keep)
    assert torch.equal(out == 0, dropped)
    _, _, dg, _ = ft.dense_gn_silu_bwd_plain(cot * dropped, torch.eye(H), xhat, rstd, gamma,
                                             beta, seed, 1, keep)
    assert float(dg.abs().max()) == 0.0  # only dropped elements carried a cotangent
    assert not torch.equal(dropped, ~ft.dropout_keep(seed, 2, B, H, keep))
    assert not torch.equal(dropped, ~ft.dropout_keep(seed + 1, 1, B, H, keep))
    kept = torch.cat([ft.dropout_keep(s, j, 256, 1024, keep).flatten()
                      for s, j in ((1, 0), (2, 3), (3, 1), (99, 4))])
    n = kept.numel()
    sigma = (keep * (1 - keep) / n) ** 0.5
    assert abs(float(kept.float().mean()) - keep) < 5 * sigma


def test_dropout_route_equals_autograd_with_the_same_masks():
    """At dropout 0.1 the kernel route (plain versions, fp32) gives the loss
    and gradients of autograd through the network fed the same hash masks."""
    _, _, tm = models(dropout=0.1)
    x = torch.from_numpy(batch_np())
    g = torch.Generator().manual_seed(5)
    t = torch.rand(B, generator=g) * (1 - 1e-5) + 1e-5
    z = torch.randn(B, D, generator=g)
    sde = SubVPSDE(N=1000)
    loss, grads = ft.get_cuda_train_loss_and_grad(sde, tm, reduce_mean=True,
                                                  compute_dtype=torch.float32)(
        x, t=t, z=z, dropout_seed=424242)
    ref_loss = tlosses.get_sde_loss_fn(sde, True, tlosses.make_model_apply(tm),
                                       reduce_mean=True)(tlosses.params_of(tm), x, t=t, z=z,
                                                         dropout_seed=424242)
    ref_loss.backward()
    np.testing.assert_allclose(float(loss), float(ref_loss.detach()), rtol=1e-5)
    for n, p in tm.named_parameters():
        if p.grad is None:
            continue
        rel = float((grads[n] - p.grad).norm() / (p.grad.norm() + 1e-12))
        assert rel < 1e-4, f"{n}: relative error {rel}"
    # and the masks really dropped something: without them the loss differs
    no_drop = tlosses.get_sde_loss_fn(sde, False, tlosses.make_model_apply(tm),
                                      reduce_mean=True)(tlosses.params_of(tm), x, t=t, z=z)
    assert abs(float(no_drop.detach()) - float(loss)) > 1e-3 * float(loss)


def test_kernel_step_trains_like_the_autograd_step():
    """get_cuda_step_fn composes with the TrainState as losses.get_step_fn
    does: at fp32 and dropout 0, three steps give the same losses and
    parameters."""
    import ml_collections

    config = ml_collections.ConfigDict(dict(
        optim=dict(optimizer="Adam", lr=2e-3, beta1=0.9, eps=1e-8, warmup=0, grad_clip=1.0,
                   weight_decay=0), model=dict(ema_rate=0.999)))
    sde = SubVPSDE(N=1000)
    states, losses = [], []
    for route in ("autograd", "kernel"):
        _, _, tm = models()
        state = tlosses.init_train_state(config, tm)
        step = (tlosses.get_step_fn(sde, True, tlosses.make_model_apply(tm), reduce_mean=True)
                if route == "autograd" else
                ft.get_cuda_step_fn(sde, tm, reduce_mean=True, compute_dtype=torch.float32))
        g = torch.Generator().manual_seed(9)
        losses.append([float(step(state, torch.from_numpy(batch_np(seed=i)), generator=g,
                                  dropout_seed=0)["step_loss"]) for i in range(3)])
        states.append(state)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    assert states[0].step == states[1].step == 3
    for (n, a), b in zip(states[0].model.named_parameters(), states[1].model.parameters()):
        rel = float((a - b).norm() / (a.norm() + 1e-12))
        assert rel < 1e-4, f"{n}: relative error {rel}"


@pytest.mark.parametrize("case", ["ve", "fourier", "act", "blocks", "hidden", "aux", "dim"])
def test_scope_guards(case):
    sde = VESDE(N=1000) if case == "ve" else SubVPSDE(N=1000)
    kw = dict(SMALL)
    if case == "fourier":
        kw["embedding_type"] = "fourier"
    if case == "act":
        kw["act_name"] = "relu"
    if case == "blocks":
        kw["n_blocks"] = 4
    if case == "hidden":
        kw["hidden_dim"] = 96  # group size 3
    if case == "dim":
        kw["pose_dim"] = 6
    model = ScoreModelFC(**kw)
    aux = case == "aux"
    assert ft.scope_error(sde, model, auxiliary_loss=aux) is not None
    if not aux:
        with pytest.raises(NotImplementedError):
            ft.get_cuda_train_loss_fn(sde, model)
        with pytest.raises(NotImplementedError):
            ft.get_cuda_step_fn(sde, model)
    assert ft.scope_error(SubVPSDE(N=1000), ScoreModelFC(**SMALL)) is None
