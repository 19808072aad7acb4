"""Motion denoising: noisy 3D joints -> a clean pose sequence. Port of
``dposer_tpu/tasks/motion_denoising.py`` (ref run/motion_denoising.py:63-300).

The per-frame poses [T, 63] are fitted by Adam (lr 0.03, b1 0.9, b2 0.999)
to a temporal vertex-smoothness term, a joint data term and the DPoser
prior, for ``iterations x steps_per_iter`` steps with ``it = step //
steps_per_iter``:

- the weights: temp ``10(1+it)``, data ``100/(1+it^2)``, dposer
  ``0.1(1+it) * dposer_weight`` (ref :156-162);
- the prior unweighted, its sum over the T frames divided by T, the time
  strategy's offset 2 (ref :125-143, :240-247);
- the init ``0.01 * randn``, not the noisy joints (ref :74);
- a final gaussian smoothing (window 3, sigma 2) that keeps both endpoints
  (ref :283-285); MPJPE and MPVPE against the ground truth in cm (ref
  :292-299).

The gradient flows through the body model and the prior's L2 (the denoised
estimate is detached). JAX runs the schedule as one ``lax.scan``; here it is
an eager loop. ``optimize_batch`` fits F fragments as one loss summed over
the fragments: Adam is elementwise, so each fragment's trajectory is its own
``optimize``'s (each fragment draws its own time every step under strategy
'1', as JAX's vmap over per-fragment keys does).

``MotionDenoise(mesh=)`` splits the fragments of ``optimize_batch`` over a
``parallel.sharding.Mesh`` (JAX shards the vmapped fragment axis): each
shard fits its fragments on its device with their own generators, the shards
one after the other from this thread, and the poses are joined on this
task's device. A chunk that does not divide the mesh is padded with its last
fragment (on a copy of its generator) and trimmed. A shard on another device
than the body model's runs on the parts ``replica(device) -> (score_fn,
body_model, normalizer)`` builds there.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..diffusion.sde import SDE
from ..parallel.sharding import Mesh, generator_on, padded_split
from ..ops.smoothing import gaussian_smoothing
from .optim import Adam
from .prior import DPoserPrior, sample_quan_t

POSE_DIM = 63
TRACE_TERMS = ("temp", "data", "dposer", "w_temp", "w_data", "w_dposer")


def _safe_norm(d: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``sqrt(max(sum d^2, 1e-12))``: a finite gradient at d = 0, where
    ``torch.linalg.norm``'s is NaN."""
    return torch.sqrt(torch.clamp((d * d).sum(dim), min=1e-12))


class MotionDenoise:
    """Sequence pose optimiser against noisy 3D joints."""

    def __init__(self, sde: SDE, score_fn: Callable, body_model, normalizer,
                 dposer_weight: float = 1.0, batch_size: int = 60, lr: float = 0.03,
                 mesh: Optional[Mesh] = None, replica: Optional[Callable] = None):
        self.sde = sde
        self.body_model = body_model
        self.device = body_model.v_template.device
        self.prior = DPoserPrior(sde, score_fn, device=self.device)
        self.normalizer = normalizer
        self.dposer_weight = dposer_weight
        # kept for the reference's signature; the prior divides by the
        # fragment's own length T
        self.batch_size = batch_size
        self.lr = lr
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.replica = replica
        self._on = {self.device: self}

    def task_on(self, device) -> "MotionDenoise":
        """This task's single-device form on ``device``: itself on its own
        device, else one built (once) on ``replica(device)``'s parts."""
        device = torch.device(device)
        if device not in self._on:
            if self.replica is None:
                raise ValueError(f"a shard on {device}, off the body model's {self.device}, "
                                 "needs replica=")
            self._on[device] = MotionDenoise(self.sde, *self.replica(device),
                                             dposer_weight=self.dposer_weight,
                                             batch_size=self.batch_size, lr=self.lr)
        return self._on[device]

    def _run_sharded(self, joints3d, generators, poses0, z, t_idx, **kw):
        """``_run`` of each shard's fragments on its device, joined here."""
        F = joints3d.shape[0]
        outs, p0 = [], 0
        for dev, rows in zip(self.mesh.devices, padded_split(self.mesh, F)):
            # a fragment's own generator where it runs on its device; a copy
            # for a pad (positions F and on) or on another device
            gens = None if generators is None else [
                generators[i] if p < F and generators[i].device == dev
                else generator_on(generators[i], dev) for p, i in enumerate(rows, p0)]
            p0 += len(rows)
            sel = torch.tensor(rows)
            outs.append(self.task_on(dev)._run(
                joints3d[sel].to(dev), gens, poses0=None if poses0 is None else poses0[sel].to(dev),
                z=None if z is None else z[:, sel].to(dev),
                t_idx=None if t_idx is None else t_idx[:, sel], **kw))
        return torch.cat([o.to(self.device) for o in outs])[:F]

    def _body(self, poses: torch.Tensor):
        out = self.body_model(pose_body=poses)
        return out.v, out.Jtr

    def _loss(self, poses, init_joints, t, z, it):
        """The schedule's loss of F fragments ``poses`` [F, T, 63], summed
        over the fragments; ``t`` [F] is each fragment's prior time."""
        F, T = poses.shape[:2]
        flat = poses.reshape(F * T, POSE_DIM)
        normed = self.normalizer.offline_normalize(flat, from_axis=True)
        vec_t = t.to(poses.dtype).repeat_interleave(T)
        # the sum over all fragments / T is the sum of each fragment's prior
        dposer = self.prior.loss(normed, vec_t, weighted=False, reduction="sum_per_batch",
                                 batch_size=T, z=z.reshape(F * T, POSE_DIM))
        v, jtr = self._body(flat)
        v, jtr = v.reshape(F, T, *v.shape[1:]), jtr.reshape(F, T, *jtr.shape[1:])
        temp = _safe_norm(v[:, :-1] - v[:, 1:]).mean((1, 2)).sum()
        data = _safe_norm(jtr[:, :, :22] - init_joints).mean((1, 2)).sum()
        # float32 weights, as the JAX loop computes them from the int step
        it = np.float32(it)
        w_temp = float(np.float32(10.0) * (np.float32(1.0) + it))
        w_data = float(np.float32(100.0) / (np.float32(1.0) + it * it))
        w_dposer = float(np.float32(0.1) * (np.float32(1.0) + it)
                         * np.float32(self.dposer_weight))
        terms = {"temp": temp, "data": data, "dposer": dposer, "w_temp": w_temp * temp,
                 "w_data": w_data * data, "w_dposer": w_dposer * dposer}
        return w_temp * temp + w_data * data + w_dposer * dposer, terms

    def _run(self, joints3d, generators, time_strategy, sample_trun, sample_time,
             iterations, steps_per_iter, poses0, z, t_idx, instrument=False):
        """``joints3d`` [F, T, 22, 3] -> the smoothed poses [F, T, 63]; with
        ``instrument`` ``(poses, trace)``, ``trace`` each loss term (JAX's
        names, summed over the fragments) a step as numpy [steps]."""
        F, T = joints3d.shape[:2]
        if time_strategy == "1" and t_idx is None and generators is None:
            raise ValueError("time strategy '1' draws each step's time from the fragments' "
                             "generators: pass generators= or inject t_idx=")
        init_joints = joints3d.detach()
        if poses0 is None:
            poses0 = torch.stack([0.01 * torch.randn(T, POSE_DIM, generator=g,
                                                     device=self.device)
                                  for g in generators])
        poses = poses0.detach().clone().requires_grad_(True)
        opt = Adam([poses], self.lr)
        total = iterations * steps_per_iter
        timesteps = self.prior.timesteps
        trace = []
        for i in range(total):
            # fragment f draws its time, then its normals, from generators[f],
            # as optimize draws from its generator
            if t_idx is not None:
                quan_t = [int(q) for q in t_idx[i]]
            elif time_strategy == "1":
                quan_t = [sample_quan_t(i, total, self.sde.N, time_strategy, generator=g)
                          for g in generators]
            else:
                quan_t = [sample_quan_t(i, total, self.sde.N, time_strategy, sample_trun,
                                        sample_time, offset=2)] * F
            if z is not None:
                z_i = z[i]
            else:
                z_i = torch.stack([torch.randn(T, POSE_DIM, generator=g, device=self.device)
                                   for g in generators])
            loss, terms = self._loss(poses, init_joints, timesteps[quan_t], z_i,
                                     i // steps_per_iter)
            opt.step(torch.autograd.grad(loss, poses))
            if instrument:
                trace.append(torch.stack([terms[k].detach() for k in TRACE_TERMS]))
        poses = poses.detach()
        # smoothing for the demo's sake, the endpoints kept (ref :283-285)
        smooth = torch.stack([gaussian_smoothing(p, window_size=3, sigma=2.0) for p in poses])
        smooth[:, 0], smooth[:, -1] = poses[:, 0], poses[:, -1]
        if not instrument:
            return smooth
        steps = torch.stack(trace).cpu().numpy() if trace else np.zeros((0, len(TRACE_TERMS)))
        return smooth, {k: steps[:, j] for j, k in enumerate(TRACE_TERMS)}

    def optimize_batch(self, joints3d: torch.Tensor, time_strategy: str = "3",
                       sample_trun: float = 2.0, sample_time: int = 990,
                       iterations: int = 5, steps_per_iter: int = 50,
                       generators: Optional[Sequence[torch.Generator]] = None,
                       poses0: Optional[torch.Tensor] = None,
                       z: Optional[torch.Tensor] = None,
                       t_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Denoise F fragments ``joints3d`` [F, T, 22, 3] at once -> poses
        [F, T, 63]. Fragment f draws its init, and every step its time
        (strategy '1') and its prior normals, from ``generators[f]``, so its
        result is that of ``optimize`` with that generator. ``poses0`` [F, T,
        63], ``z`` [steps, F, T, 63] and ``t_idx`` [steps, F] (the time
        indices) inject them instead. Under ``mesh=`` the fragments split over
        the mesh's shards (a copy of a generator on another device draws what
        the generator would)."""
        if generators is None and (poses0 is None or z is None):
            generators = [torch.Generator(device=self.device) for _ in range(len(joints3d))]
        kw = dict(time_strategy=time_strategy, sample_trun=sample_trun, sample_time=sample_time,
                  iterations=iterations, steps_per_iter=steps_per_iter)
        if self.mesh is not None:
            return self._run_sharded(joints3d, generators, poses0, z, t_idx, **kw)
        return self._run(joints3d, generators, poses0=poses0, z=z, t_idx=t_idx, **kw)

    def optimize(self, joints3d: torch.Tensor, gt_poses: Optional[torch.Tensor] = None,
                 time_strategy: str = "3", sample_trun: float = 2.0, sample_time: int = 990,
                 iterations: int = 5, steps_per_iter: int = 50, verbose: bool = False,
                 generator: Optional[torch.Generator] = None,
                 poses0: Optional[torch.Tensor] = None,
                 z: Optional[torch.Tensor] = None,
                 t_idx: Optional[torch.Tensor] = None,
                 instrument: bool = False) -> Dict[str, np.ndarray]:
        """``joints3d`` [T, 22, 3] noisy joints -> the metrics in cm (with
        ``gt_poses``); the denoised poses [T, 63] are left on
        ``self.last_poses``. ``poses0`` [T, 63], ``z`` [steps, T, 63] and
        ``t_idx`` [steps] inject the init, the prior's normals and its time
        indices. ``instrument`` also leaves the per-step raw and weighted
        loss terms on ``self.last_trace`` (``temp``, ``data``, ``dposer``,
        ``w_temp``, ``w_data``, ``w_dposer``, numpy [steps] each; ref
        :63-116), the diagnostic seam of the protocol."""
        if generator is None and (poses0 is None or z is None):
            generator = torch.Generator(device=self.device)
        out = self._run(joints3d[None], None if generator is None else [generator],
                        time_strategy, sample_trun, sample_time, iterations,
                        steps_per_iter, None if poses0 is None else poses0[None],
                        None if z is None else z[:, None],
                        None if t_idx is None else t_idx[:, None], instrument=instrument)
        if instrument:
            out, self.last_trace = out
        poses = out[0]
        self.last_poses = poses
        results: Dict[str, np.ndarray] = {}
        if gt_poses is not None:
            results = self.metrics(poses, joints3d, gt_poses)
            if verbose:
                print("before denoising:{:0.8f} cm".format(results["init_MPJPE"].mean()))
                print("after denoising:{:0.8f} cm".format(results["MPJPE"].mean()))
        return results

    @torch.no_grad()
    def metrics(self, poses: torch.Tensor, joints3d: torch.Tensor,
                gt_poses: torch.Tensor) -> Dict[str, np.ndarray]:
        """Per-frame init MPJPE, MPJPE and MPVPE in cm (ref :292-299)."""
        v_gt, j_gt = self._body(gt_poses)
        v_out, j_out = self._body(poses)

        def cm(a, b):
            return (_safe_norm(a - b).mean(-1) * 100.0).cpu().numpy()

        return {"init_MPJPE": cm(joints3d, j_gt[:, :22]), "MPJPE": cm(j_out[:, :22], j_gt[:, :22]),
                "MPVPE": cm(v_out, v_gt)}


def noise_schedule_kwargs(std: float) -> Dict:
    """The per-noise-level optimisation schedules (ref :329-336)."""
    if std == 0.02:
        return {"iterations": 3, "steps_per_iter": 40, "sample_trun": 10.0, "sample_time": 495}
    if std == 0.04:
        return {"iterations": 3, "steps_per_iter": 60, "sample_trun": 4.0, "sample_time": 490}
    if std == 0.1:
        return {"iterations": 3, "steps_per_iter": 80, "sample_trun": 3.0, "sample_time": 480}
    raise NotImplementedError(f"no schedule for noise std {std}")
