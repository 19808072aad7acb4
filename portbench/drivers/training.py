"""Training traffic: the trainer's step path, ``parallel.sharding.
data_parallel_multi_step_indexed`` over ``fused_train.get_cuda_step_fn`` in
one process (the loss, the gradient, the clip, Adam and the EMA), on batches
gathered by index from synthetic rows held on the device, as the trainer
holds its split. A request is one dispatch: the trainer's default number of
steps between loss reads (``train.parse_args([]).steps_per_dispatch``), its
index window uploaded as the trainer uploads it, its losses read back.

Traffic keys: ``rows`` (the device-resident split), ``check_steps``,
``trace_requests``; the batch and the optimizer are the configuration's.

Set-up builds the train state and drives it through its first
``check_steps`` steps by the same call; the window goes on from there with
the same state. The check runs those steps in the reference from the same
weights, rows, times, normals and dropout seeds, and compares each step's
loss, the first gradient as the optimizer holds it (its first moment after
one step), and the change of the parameters and of their EMA after the
last of them, leaf by leaf by norm.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from .. import inputs, program
from ..reference import scorefc
from ..reference import train as ref_train
from ..trace import setup_phase, span

LOSS_EPS = 1e-5  # the trainer's t ~ U(eps, 1)
SKIP_SHARE = 1e-3  # leaves whose reference gradient is below this share of the median's


def index_stream(n: int, batch: int, seed: int):
    """Shuffled row indices, one epoch's permutation after another, the last
    partial batch dropped (the trainer's stream)."""
    rng = np.random.default_rng(seed)
    end = n - n % batch
    while True:
        perm = rng.permutation(n)
        for i in range(0, end, batch):
            yield perm[i:i + batch].astype(np.int32)


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keep) -> float:
    """The worst leaf's gap of norms, ``| |got| - |want| |``, against the
    larger of the leaf's reference norm and the median leaf's."""
    norms = {k: float(want[k].norm()) for k in keep}
    median = float(np.median(list(norms.values())))
    return max(abs(float(got[k].norm()) - norms[k]) / max(norms[k], median) for k in keep)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control=None):
        with setup_phase("program imports"):
            from dposer_tpu_torch import train as trainer
            from dposer_tpu_torch.diffusion.losses import init_train_state
            from dposer_tpu_torch.ops.cuda.fused_train import get_cuda_step_fn
            from dposer_tpu_torch.parallel import sharding

        self.config, self.traffic, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.control = control
        m, t = config["model"], config["training"]
        self.dim = int(m["n_poses"]) * int(m["pose_dim"])
        self.batch = int(t["batch_size"])
        self.k = max(1, trainer.parse_args([]).steps_per_dispatch)
        with setup_phase("weights", self.dev):
            self.weights = inputs.make_weights(m, seed, self.dev)
        with setup_phase("model", self.dev):
            self.model = program.build_model(config, self.weights, self.dev, train=True)
        cfg = SimpleNamespace(
            optim=SimpleNamespace(optimizer=t["optimizer"], lr=t["lr"], beta1=t["beta1"],
                                  eps=t["eps"], weight_decay=t["weight_decay"],
                                  warmup=t["warmup"], grad_clip=t["grad_clip"]),
            model=SimpleNamespace(ema_rate=t["ema_rate"]))
        with setup_phase("train state", self.dev):
            self.state = init_train_state(cfg, self.model)
            step_fn = get_cuda_step_fn(program.build_sde(config), self.model,
                                       reduce_mean=t["reduce_mean"],
                                       likelihood_weighting=t["likelihood_weighting"],
                                       eps=LOSS_EPS)
        self.step_host_s: List[float] = []
        self.timing = False

        def timed_step(state, batch, **kw):  # a host span: the step holds no sync
            t0 = time.perf_counter()
            out = step_fn(state, batch, **kw)
            if self.timing:
                self.step_host_s.append(time.perf_counter() - t0)
            return out

        self.multi_step = sharding.data_parallel_multi_step_indexed(timed_step)
        with setup_phase("data", self.dev):
            self.data = inputs.pose_mixture(seed, int(traffic["rows"]), self.dim, self.dev)
        self.stream = index_stream(int(traffic["rows"]), self.batch, inputs.derive(seed, 6))
        self.gen = torch.Generator(device=self.dev)
        self.step, self.losses = 0, []
        self.first: List[np.ndarray] = []
        # the first steps, by the window's own call, recorded for the check
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        self.m1, n_check = None, int(traffic["check_steps"])
        with setup_phase("first steps", self.dev):  # the first builds the kernels' operands
            for i in range(n_check):
                self._dispatch(record=True)
                if i == 0:
                    st = self.state.tx.optimizer.state
                    self.m1 = {n: st[p]["exp_avg"].clone() for n, p in
                               zip(names, self.state.tx.params) if p in st}
        self.p_checked = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.ema_checked = dict(zip(names, (s.clone() for s in self.state.ema.shadow_params)))
        self.checked_losses = list(self.losses)
        self.losses.clear()

    def _draws(self, step: int):
        return inputs.derive(self.seed, 30, step), inputs.derive(self.seed, 31, step) & 0x7FFFFFFF

    def _noise(self, j: int) -> dict:
        g_seed, d_seed = self._draws(self.step + j)
        self.gen.manual_seed(g_seed)
        return dict(generator=self.gen, dropout_seed=d_seed)

    def _dispatch(self, record: bool = False) -> None:
        idx = np.stack([next(self.stream) for _ in range(self.k)])
        if record:
            self.first.extend(idx)
        up = torch.from_numpy(idx)
        if self.dev.type == "cuda":
            up = up.pin_memory().to(self.dev, non_blocking=True)
        with span("steps"):
            out = self.multi_step(self.state, up, self.data, self._noise)
        self.step += self.k
        self.losses.extend(d["step_loss"] for d in out)

    def request(self, i: int, timed_device: bool = False) -> int:
        self.timing = timed_device
        self._dispatch()
        return self.k * self.batch

    def failed(self) -> int:
        return sum(int(not np.isfinite(v)) for v in self.losses + self.checked_losses)

    def work(self, n: int) -> Dict[str, float]:
        m = self.config["model"]
        h, e, d, nb = (int(m["hidden_dim"]), int(m["embed_dim"]), self.dim, int(m["n_blocks"]))
        steps = n * self.k
        row_macs = d * h + 2 * nb * h * h + h * d + e * e + e * (1 + 2 * nb) * h
        return dict(rows=self.batch, hidden=h, dim=d, n_blocks=nb, train_steps=steps,
                    flops_bf16=3 * 2 * steps * self.batch * row_macs, ops_int8=0)

    def release(self) -> None:
        self.multi_step = self.state = self.model = None

    @torch.no_grad()
    def _inputs(self, step: int):
        g_seed, d_seed = self._draws(step)
        g = torch.Generator(device=self.dev).manual_seed(g_seed)
        t = torch.rand(self.batch, generator=g, device=self.dev) * (1.0 - LOSS_EPS) + LOSS_EPS
        z = torch.randn((self.batch, self.dim), generator=g, device=self.dev)
        return t, z, d_seed

    def _reference(self, operand=None):
        """The reference's first steps on the same inputs: ``(losses, trainer)``."""
        ref = ref_train.Trainer(self.weights, self.config["model"], self.config["sde"],
                                self.config["training"], operand)
        losses = []
        for step, idx in enumerate(self.first):
            t, z, d_seed = self._inputs(step)
            x0 = self.data[torch.as_tensor(idx, device=self.dev).long()]
            losses.append(ref.step(x0, t, z, d_seed))
        return losses, ref

    def check(self) -> Dict[str, float]:
        scorefc.no_tf32()
        losses, ref = self._reference()
        stand_in = self._reference("fp8") if self.control == "reference_fp8" else None
        b1 = float(self.config["training"]["beta1"])
        with torch.no_grad():
            g_ref = ref.clipped[0]
            med = float(np.median([float(v.norm()) for v in g_ref.values()]))
            keep = [k for k, v in g_ref.items() if float(v.norm()) >= SKIP_SHARE * med]
            if stand_in is not None:  # the stand-in in the program's place
                got_losses, lo = stand_in
                g_got = lo.clipped[0]
                p_got, e_got = ({k: v.detach() for k, v in lo.p.items()}, lo.ema)
            else:
                got_losses = self.checked_losses
                g_got = {k: self.m1.get(k, torch.zeros_like(g_ref[k])) / (1.0 - b1) for k in keep}
                p_got, e_got = self.p_checked, self.ema_checked
            change = lambda p: {k: p[k] - self.weights[k] for k in keep}  # noqa: E731
            return {
                "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got_losses, losses)),
                "grad_gap": leaf_gap(g_got, g_ref, keep),
                "change_gap": leaf_gap(change(p_got), change(ref.p), keep),
                "ema_change_gap": leaf_gap(change(e_got), change(ref.ema), keep),
            }
