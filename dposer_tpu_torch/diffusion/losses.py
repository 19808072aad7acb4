"""Score-matching losses, the optimizer and the train/eval step (port of
``dposer_tpu/diffusion/losses.py``; ref lib/algorithms/advanced/losses.py).

- continuous denoising score matching: ``t ~ U(eps, T)``, perturbation
  through ``marginal_prob``, loss ``|score*std + z|^2`` (or the
  likelihood-weighted ``g^2 |score + z/std|^2``), ``reduce_mean`` or 0.5*sum
  (ref :61-137); the optional auxiliary body-model loss: a multi-step
  denoise back to x0, both poses through SMPL-X, SNR-weighted v2v and j2j
  terms (ref :239-258);
- the discrete SMLD and DDPM losses (ref :140-184);
- Adam with a linear warmup and optax's global-norm clip (ref :31-58);
- one train step: loss, gradient, clip, Adam and EMA, updating the
  ``TrainState`` in place; and the eval step under the EMA parameters.

Every loss takes its noise injected (``t=``, ``z=``; ``labels=``, ``noise=``
for the discrete losses) and a ``dropout_seed`` (the mask hash of the train
kernels, ``ops/cuda/fused_train.py::dropout_mask``) for pointwise parity;
otherwise it draws all of them from ``generator``. ``model_apply(params, x,
labels, masks=None)`` is the network on a dict of named parameters with
explicit dropout masks (``make_model_apply``).

The optimizer matches optax's chain exactly where they differ by default:
the schedule reads the update count before it increments it, so the first
update has lr 0 (``LambdaLR`` stepped after ``optimizer.step()``); the clip
scales by ``max_norm / norm`` only when ``norm >= max_norm``
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``); weight
decay is added after the clip (torch Adam's ``weight_decay``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..models import TimeMLPs
from ..models.time_embedding import get_timestep_embedding
from ..utils import profiling
from .ema import EMAState, ema_init, ema_update
from .score_fn import get_score_fn
from .sde import SDE, VESDE, VPSDE, batch_mul, linspace_f32


def batch_rows(batch: int, rows=None):
    """``(global_batch, slice)``: the batch the draws are made at and the
    rows of ``batch`` in it. The whole batch, or under ``rows=(row_offset,
    global_batch)`` (a data-parallel rank's share) those rows, which must lie
    inside the global batch."""
    if rows is None:
        return batch, slice(0, batch)
    row_offset, global_batch = rows
    if not 0 <= row_offset <= global_batch - batch:
        raise ValueError(f"rows {row_offset}..{row_offset + batch} outside the global "
                         f"batch of {global_batch}")
    return global_batch, slice(row_offset, row_offset + batch)


# ---------------------------------------------------------------------------
# Optimizer (ref losses.py:31-58)
# ---------------------------------------------------------------------------

def lr_factor(config, count: int) -> float:
    """The warmup factor at update ``count`` (optax reads the count before
    incrementing it: the first update has factor 0)."""
    warmup = config.optim.warmup
    return min(count / warmup, 1.0) if warmup > 0 else 1.0


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: ``g * max_norm / norm`` when
    ``norm >= max_norm``, else unchanged. Returns the norm; never syncs."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))
    return norm


class Tx:
    """Adam + linear warmup + global-norm clip, mirroring
    ``optimization_manager`` (ref losses.py:31-58) and the JAX package's
    optax chain. ``params`` are the trainable parameters, in order."""

    def __init__(self, config, params):
        if config.optim.optimizer != "Adam":
            raise NotImplementedError(f"Optimizer {config.optim.optimizer} not supported yet!")
        self.config = config
        self.params = [p for p in params if p.requires_grad]
        self.grad_clip = config.optim.grad_clip
        self.last_norm = None  # the last step's gradient norm before the clip
        # on the card, torch's fused Adam: one launch for all parameters
        fused = True if all(p.is_cuda for p in self.params) else None
        self.optimizer = torch.optim.Adam(self.params, lr=config.optim.lr,
                                          betas=(config.optim.beta1, 0.999),
                                          eps=config.optim.eps,
                                          weight_decay=config.optim.weight_decay, fused=fused)
        self._schedule()

    def _schedule(self):
        """The LR schedule at the optimizer's own update count."""
        for group in self.optimizer.param_groups:
            group["initial_lr"] = self.config.optim.lr
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda c: lr_factor(self.config, c), last_epoch=self.count() - 1)

    def count(self) -> int:
        """Updates applied so far (optax's count)."""
        states = [s for s in self.optimizer.state.values() if "step" in s]
        return int(states[0]["step"]) if states else 0

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        """Clip the gradients, then one Adam update at the scheduled lr."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.grad_clip >= 0 and grads:
            self.last_norm = clip_by_global_norm_(grads, self.grad_clip)
        self.optimizer.step()
        self.scheduler.step()

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict):
        self.optimizer.load_state_dict(state)
        self._schedule()


def build_optimizer(config, params) -> Tx:
    return Tx(config, params)


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    tx: Tx
    ema: EMAState


def init_train_state(config, model) -> TrainState:
    """The state before the first step: the optimizer (its first build
    imports ``torch._dynamo``) and the EMA; the set-up span ``train.init``."""
    with profiling.setup_span("train.init"):
        params = [p for p in model.parameters() if p.requires_grad]
        return TrainState(step=0, model=model, tx=build_optimizer(config, params),
                          ema=ema_init(params, decay=config.model.ema_rate))


def apply_train_update(state: TrainState) -> None:
    """Clip, Adam, EMA and the step count, after the gradients are in."""
    state.tx.step()
    ema_update(state.ema, state.tx.params)
    state.step += 1


def params_of(model) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def ema_params_of(state: TrainState) -> Dict[str, torch.Tensor]:
    """The model's parameters with the EMA shadow in place of the trained
    ones (ref losses.py:265-271 store/copy/restore)."""
    params = params_of(state.model)
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    params.update(zip(names, state.ema.shadow_params))
    return params


# ---------------------------------------------------------------------------
# The network on named parameters, with explicit dropout masks
# ---------------------------------------------------------------------------

def make_model_apply(model) -> Callable:
    """``apply(params, x, labels, masks=None) -> out``: ``model``'s forward
    (ScoreModelFC or TimeMLPs) on the named parameters ``params``; ``masks``
    (one [B, H] factor of 0 and 1/keep per dropout layer, in network order:
    ``dropout_layers``) replace the Dropout modules' draws, None means no
    dropout."""
    if isinstance(model, TimeMLPs):
        return _time_mlps_apply(model)
    act = model.act
    n_blocks = model.n_blocks

    def dense(p, name, h):
        return F.linear(h, p[name + ".weight"], p[name + ".bias"])

    def apply(params, x, labels, masks=None):
        p = params
        labels = torch.atleast_1d(labels)
        if model.embedding_type == "fourier":
            used_sigmas = labels
            proj = torch.log(labels)[:, None] * p["gauss_proj.W"][None, :] * 2 * torch.pi
            temb = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        else:
            used_sigmas = model.sigmas[labels.long()]
            temb = get_timestep_embedding(labels, model.embed_dim)
        temb = act(dense(p, "shared_time_embed.0", temb))

        def layer(j, name, gn, h_in):
            h = dense(p, name, h_in) + dense(p, name + "_t", temb)
            h = act(F.group_norm(h, 32, p[gn + ".weight"], p[gn + ".bias"], eps=1e-5))
            return h if masks is None else h * masks[j]

        h = layer(0, "pre_dense", "pre_gnorm", x)
        for idx in range(n_blocks):
            b = f"b{idx + 1}_"
            h1 = layer(1 + 2 * idx, b + "dense1", b + "gnorm1", h)
            h = h + layer(2 + 2 * idx, b + "dense2", b + "gnorm2", h1)
        res = dense(p, "post_dense", h)
        if model.scale_by_sigma:
            res = res / used_sigmas.reshape((-1, 1))
        return res

    apply.model = model
    return apply


def _time_mlps_apply(model: TimeMLPs) -> Callable:
    """``make_model_apply`` for TimeMLPs: the time label appended to the
    pose, a dropout mask after each hidden block's activation."""
    act = model.net[1]
    n_blocks = model.n_blocks

    def dense(p, i, h):
        return F.linear(h, p[f"net.{i}.weight"], p[f"net.{i}.bias"])

    def apply(params, x, labels, masks=None):
        labels = torch.atleast_1d(labels).to(x.dtype).expand(x.shape[0])
        h = act(dense(params, 0, torch.cat([x, labels[:, None]], dim=1)))
        for b in range(n_blocks):
            h = act(dense(params, 2 + 3 * b, h))
            if masks is not None:
                h = h * masks[b]
        return dense(params, 2 + 3 * n_blocks, h)

    apply.model = model
    return apply


def dropout_layers(model) -> tuple:
    """``(p, n)``: ``model``'s dropout rate and its number of dropout layers
    (ScoreModelFC: one per GroupNorm layer; TimeMLPs: one per hidden block)."""
    if isinstance(model, TimeMLPs):
        drops = [m for m in model.net if isinstance(m, torch.nn.Dropout)]
        return (float(drops[0].p) if drops else 0.0), len(drops)
    return float(model.dropout.p), 1 + 2 * model.n_blocks


def draw_masks(model, batch: int, device, dropout_seed: Optional[int] = None,
               generator: Optional[torch.Generator] = None, rows=None):
    """One dropout factor [B, H] per dropout layer: the train kernels' hash
    masks for ``dropout_seed``, else bernoulli(keep) draws from
    ``generator``; None when the model has no dropout. ``rows=(row_offset,
    global_batch)``: the batch is those rows of a global batch, whose masks
    are drawn (or hashed) at the global shape and sliced."""
    from ..ops.cuda.fused_train import dropout_mask

    p_drop, n_tp = dropout_layers(model)
    keep = 1.0 - p_drop
    H = model.hidden_dim
    if keep >= 1.0:
        return None
    n, sl = batch_rows(batch, rows)
    if dropout_seed is not None:
        return [dropout_mask(dropout_seed, j, batch, H, keep, device, sl.start)
                for j in range(n_tp)]
    u = torch.rand((n_tp, n, H), generator=generator, device=device)[:, sl]
    return list((u < keep).float() * torch.tensor(1.0 / keep, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Continuous SDE loss (ref losses.py:61-137)
# ---------------------------------------------------------------------------

def _reduce(reduce_mean: bool):
    return (lambda x: torch.mean(x, dim=-1)) if reduce_mean \
        else (lambda x: 0.5 * torch.sum(x, dim=-1))


def get_sde_loss_fn(sde: SDE, train: bool, model_apply: Callable, reduce_mean: bool = False,
                    continuous: bool = True, likelihood_weighting: bool = False,
                    eps: float = 1e-5, return_data: bool = False, denoise_steps: int = 5):
    """``loss_fn(params, batch, *, t=None, z=None, dropout_seed=None,
    generator=None, rows=None) -> loss`` (``(loss, data)`` with
    ``return_data``). ``rows=(row_offset, global_batch)``: ``batch`` is those
    rows of a global batch (a data-parallel rank's share); every draw is made
    at the global shape and sliced, so the ranks together draw what one
    device draws. The loss is the mean over ``batch``'s own rows."""
    reduce_op = _reduce(reduce_mean)

    def multi_step_denoise(score_fn, x_t, t, t_end, N):
        """Ref losses.py:91-106: DDIM-style multi-step denoise to x0_hat."""
        alpha_grid = linspace_f32(0.0, 1.0, N + 1, device=x_t.device)
        score_first = None
        x_current = x_t
        for i in range(N):
            t_current = (1 - alpha_grid[i]) * t + alpha_grid[i] * t_end
            t_before = (1 - alpha_grid[i + 1]) * t + alpha_grid[i + 1] * t_end
            a_cur, s_cur = sde.return_alpha_sigma(t_current)
            a_bef, s_bef = sde.return_alpha_sigma(t_before)
            score = score_fn(x_current, t_current)
            if i == 0:
                score_first = score
            noise_pred = -score * s_cur[:, None]
            x_current = (a_bef / a_cur) * (x_current - s_cur[:, None] * noise_pred) \
                + s_bef[:, None] * noise_pred
        return score_first, x_current

    def loss_fn(params, batch, *, t=None, z=None, dropout_seed=None, generator=None,
                rows=None):
        B = batch.shape[0]
        dev = batch.device
        n, sl = batch_rows(B, rows)
        if t is None:
            t = (torch.rand(n, generator=generator, device=dev) * (sde.T - eps) + eps)[sl]
        if z is None:
            z = torch.randn((n,) + tuple(batch.shape[1:]), generator=generator, device=dev)[sl]
        mean, std = sde.marginal_prob(batch, t)
        perturbed = mean + batch_mul(std, z)
        masks = (draw_masks(model_apply.model, B, dev, dropout_seed, generator, rows)
                 if train else None)
        score_fn = get_score_fn(sde, lambda x, labels: model_apply(params, x, labels, masks),
                                continuous=continuous)
        if return_data:
            alpha, sigma = sde.return_alpha_sigma(t)
            snr = alpha / sigma[:, None]
            score, estimated = multi_step_denoise(score_fn, perturbed, t,
                                                  t_end=t / (2 * denoise_steps), N=denoise_steps)
        else:
            score = score_fn(perturbed, t)

        if not likelihood_weighting:
            losses = torch.square(batch_mul(std, score) + z)
            losses = reduce_op(losses.reshape(B, -1))
        else:
            g2 = sde.sde(torch.zeros_like(batch), t)[1] ** 2
            losses = torch.square(score + batch_mul(1.0 / std, z))
            losses = reduce_op(losses.reshape(B, -1)) * g2
        loss = torch.mean(losses)
        if return_data:
            return loss, {"clean_sample": estimated, "SNR": snr, "t": t}
        return loss

    return loss_fn


# ---------------------------------------------------------------------------
# Discrete losses (ref losses.py:140-184)
# ---------------------------------------------------------------------------

def get_smld_loss_fn(vesde: VESDE, train: bool, model_apply: Callable,
                     reduce_mean: bool = False):
    """``loss_fn(params, batch, *, labels=None, noise=None, dropout_seed=None,
    generator=None, rows=None)``; ``noise`` is the standard normal before
    scaling; ``rows`` as in ``get_sde_loss_fn``."""
    assert isinstance(vesde, VESDE), "SMLD training only works for VESDEs."
    reduce_op = _reduce(reduce_mean)

    def loss_fn(params, batch, *, labels=None, noise=None, dropout_seed=None,
                generator=None, rows=None):
        B = batch.shape[0]
        dev = batch.device
        n, sl = batch_rows(B, rows)
        smld_sigmas = vesde.discrete_sigmas(dev).flip(0)  # descending
        if labels is None:
            labels = torch.randint(0, vesde.N, (n,), generator=generator, device=dev)[sl]
        if noise is None:
            noise = torch.randn((n,) + tuple(batch.shape[1:]), generator=generator,
                                device=dev)[sl]
        sigmas = smld_sigmas[labels]
        noise = batch_mul(sigmas, noise)
        perturbed = noise + batch
        masks = (draw_masks(model_apply.model, B, dev, dropout_seed, generator, rows)
                 if train else None)
        score = model_apply(params, perturbed, labels, masks)
        target = -batch_mul(1.0 / sigmas ** 2, noise)
        losses = torch.square(score - target)
        losses = reduce_op(losses.reshape(B, -1)) * sigmas ** 2
        return torch.mean(losses)

    return loss_fn


def get_ddpm_loss_fn(vpsde: VPSDE, train: bool, model_apply: Callable,
                     reduce_mean: bool = True):
    """``loss_fn(params, batch, *, labels=None, noise=None, dropout_seed=None,
    generator=None, rows=None)``; ``rows`` as in ``get_sde_loss_fn``."""
    assert isinstance(vpsde, VPSDE), "DDPM training only works for VPSDEs."
    reduce_op = _reduce(reduce_mean)

    def loss_fn(params, batch, *, labels=None, noise=None, dropout_seed=None,
                generator=None, rows=None):
        B = batch.shape[0]
        dev = batch.device
        n, sl = batch_rows(B, rows)
        alphas_cumprod = torch.cumprod(vpsde.alphas(dev), 0)
        sqrt_ac, sqrt_1m_ac = torch.sqrt(alphas_cumprod), torch.sqrt(1.0 - alphas_cumprod)
        if labels is None:
            labels = torch.randint(0, vpsde.N, (n,), generator=generator, device=dev)[sl]
        if noise is None:
            noise = torch.randn((n,) + tuple(batch.shape[1:]), generator=generator,
                                device=dev)[sl]
        perturbed = batch_mul(sqrt_ac[labels], batch) + batch_mul(sqrt_1m_ac[labels], noise)
        masks = (draw_masks(model_apply.model, B, dev, dropout_seed, generator, rows)
                 if train else None)
        score = model_apply(params, perturbed, labels, masks)
        losses = torch.square(score - noise)
        return torch.mean(reduce_op(losses.reshape(B, -1)))

    return loss_fn


# ---------------------------------------------------------------------------
# Train / eval step (ref losses.py:187-275)
# ---------------------------------------------------------------------------

def get_step_fn(sde: SDE, train: bool, model_apply: Callable, reduce_mean: bool = False,
                continuous: bool = True, likelihood_weighting: bool = False,
                auxiliary_loss: bool = False, denormalize: Optional[Callable] = None,
                body_model_fn: Optional[Callable] = None, rot_rep: str = "rot6d",
                denoise_steps: int = 5, rot6d_to_axis: Optional[Callable] = None):
    """``step_fn(state, batch, *, rows=None, grad_hook=None, **noise) -> loss
    dict``. Training updates ``state`` in place (gradient, clip, Adam, EMA,
    step); evaluation computes the loss under the EMA parameters without
    dropout. ``noise`` is the loss's injected draws (``t``, ``z``,
    ``dropout_seed``, ``generator``). A data-parallel rank passes ``rows=
    (row_offset, global_batch)``, its rows of the step's global batch (the
    draws are made at the global shape and sliced), and ``grad_hook(grads,
    losses) -> losses``, which runs between the backward and the update on
    the trained parameters' gradients (in order; None where a parameter has
    none) and the detached losses (the all-reduce of
    ``parallel.sharding.data_parallel_step``). Without them the step is the
    one-device step.
    With ``auxiliary_loss`` the body-model v2v and j2j terms are added
    (ref losses.py:239-258); ``body_model_fn(pose_axis [B, 63]) -> (v, Jtr)``
    must be differentiable."""
    if continuous:
        loss_fn = get_sde_loss_fn(sde, train, model_apply, reduce_mean=reduce_mean,
                                  continuous=True, likelihood_weighting=likelihood_weighting,
                                  return_data=auxiliary_loss, denoise_steps=denoise_steps)
    else:
        assert not likelihood_weighting, \
            "Likelihood weighting is not supported for original SMLD/DDPM training."
        if isinstance(sde, VESDE):
            loss_fn = get_smld_loss_fn(sde, train, model_apply, reduce_mean=reduce_mean)
        elif isinstance(sde, VPSDE):
            loss_fn = get_ddpm_loss_fn(sde, train, model_apply, reduce_mean=reduce_mean)
        else:
            raise ValueError(f"Discrete training for {type(sde).__name__} is not recommended.")
    if auxiliary_loss:
        assert denormalize is not None and body_model_fn is not None

    def full_loss(params, batch, **noise):
        if not auxiliary_loss:
            loss = loss_fn(params, batch, **noise)
            return loss, {"step_loss": loss, "score_loss": loss}
        score_loss, data = loss_fn(params, batch, **noise)
        weight = torch.log(1.0 + data["SNR"])  # [B, 1]
        estimate = denormalize(data["clean_sample"])
        gt = denormalize(batch)
        if rot_rep == "rot6d":
            n = estimate.shape[0]
            estimate = rot6d_to_axis(estimate.reshape(-1, 6)).reshape(n, -1)
            gt = rot6d_to_axis(gt.reshape(-1, 6)).reshape(n, -1)
        gt_v, gt_j = body_model_fn(gt)
        pred_v, pred_j = body_model_fn(estimate)
        loss_v2v = torch.mean(weight * torch.square(gt_v - pred_v).sum(-1))
        loss_j2j = torch.mean(weight * torch.square(gt_j - pred_j).sum(-1))
        loss = score_loss + loss_v2v + loss_j2j
        return loss, {"step_loss": loss, "score_loss": score_loss,
                      "v2v_loss": loss_v2v, "j2j_loss": loss_j2j}

    if train:

        def step_fn(state: TrainState, batch, *, rows=None, grad_hook=None, **noise):
            state.tx.zero_grad()
            loss, loss_dict = full_loss(params_of(state.model), batch, rows=rows, **noise)
            loss.backward()
            losses = {k: v.detach() for k, v in loss_dict.items()}
            if grad_hook is not None:
                losses = grad_hook([p.grad for p in state.tx.params], losses)
            apply_train_update(state)
            return losses
    else:

        @torch.no_grad()
        def step_fn(state: TrainState, batch, *, rows=None, **noise):
            _, loss_dict = full_loss(ema_params_of(state), batch, rows=rows, **noise)
            return loss_dict

    return step_fn
