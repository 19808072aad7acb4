"""Completion traffic: one ``DPoserComp(backend="cuda").optimize_hypos`` call a
request, each call's hypotheses copied to the host.

Traffic keys: ``poses`` (a batch), ``hypotheses``, ``eps`` (the time grid's
end), ``batches`` (observation batches drawn at set-up from the pose
mixture, taken in turn), ``parts`` (the occluded body parts by name, as
joint indices; each request's part is drawn from the seed), ``lr``,
``iterations``, ``steps_per_iter``, ``time_strategy``, ``sample_trun``,
``sample_time``, ``check_requests``, ``trace_requests``. Occluded dims are
observed as N(0, 1) noise, as the completion task fills them.

The check reruns whole solves of requests sampled from the seed in the
reference, from the same observation, mask and normals, and compares the
hypotheses relative to how far the reference moved them from the
observation, at the widest (``solve_gap_max``) and in root mean square
(``solve_gap_rms``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import inputs, program
from ..reference import philox, scorefc, tasks
from ..trace import setup_phase, span


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control=None):
        with setup_phase("program imports"):
            from dposer_tpu_torch.tasks.completion import DPoserComp

        self.config, self.traffic, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.control = control
        m = config["model"]
        self.rot = int(m["pose_dim"])
        self.dim = int(m["n_poses"]) * self.rot
        self.poses, self.hypo = int(traffic["poses"]), int(traffic["hypotheses"])
        with setup_phase("weights", self.dev):
            self.weights = inputs.make_weights(m, seed, self.dev)
        model = program.build_model(config, self.weights, self.dev)
        self.comp = DPoserComp(program.build_sde(config), model=model, lr=traffic["lr"],
                               iterations=traffic["iterations"],
                               steps_per_iter=traffic["steps_per_iter"],
                               time_strategy=traffic["time_strategy"],
                               sample_trun=traffic["sample_trun"],
                               sample_time=traffic["sample_time"], backend="cuda",
                               device=self.dev)
        nb, parts = int(traffic["batches"]), list(traffic["parts"].values())
        poses = inputs.pose_mixture(seed, nb * self.poses, self.dim, self.dev)
        fill = torch.randn(poses.shape, generator=inputs.generator(seed, 4, device=self.dev),
                           device=self.dev)
        masks = torch.ones((len(parts), self.dim), device=self.dev)
        for p, joints in enumerate(parts):
            for j in joints:
                masks[p, j * self.rot:(j + 1) * self.rot] = 0.0
        self.masks = masks[:, None, :].expand(-1, self.poses, -1).contiguous()
        poses, fill = (t.reshape(nb, 1, self.poses, self.dim) for t in (poses, fill))
        self.obs = poses * self.masks + fill * (1.0 - self.masks)  # [batch, part, poses, dim]
        self.part_of = np.random.default_rng(inputs.derive(seed, 5)).integers(
            0, len(parts), size=int(traffic.get("max_requests", 1 << 20)))
        self.kernel_normals = self.dev.type == "cuda"
        self.kept = inputs.Reservoir(int(traffic["check_requests"]), seed)
        self.bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.events: List = []
        with setup_phase("warm-up", self.dev):  # the first call builds and captures
            self.comp.optimize_hypos(self.obs[0, 0], self.masks[0], self.hypo,
                                     inputs.generator(seed, 9, device=self.dev))

    def inputs_of(self, i: int):
        p = int(self.part_of[i])
        return self.obs[i % self.obs.shape[0], p], self.masks[p]

    def request(self, i: int, timed_device: bool = False) -> int:
        obs, mask = self.inputs_of(i)
        g = inputs.generator(self.seed, 10, i, device=self.dev)
        if timed_device:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        with span("optimize_hypos"):
            out = self.comp.optimize_hypos(obs, mask, self.hypo, g)
        if timed_device:
            ev[1].record()
            self.events.append(ev)
        with span("copy_to_host"):
            out.cpu()
        self.bad += (~torch.isfinite(out)).any()
        self.kept.offer(i, out)
        return 1

    def failed(self) -> int:
        """Requests whose hypotheses were not all finite."""
        return int(self.bad)

    def work(self, n: int) -> Dict[str, float]:
        m, t = self.config["model"], self.traffic
        h, d, nb = int(m["hidden_dim"]), self.dim, int(m["n_blocks"])
        rows = self.poses * self.hypo
        steps = n * int(t["iterations"]) * int(t["steps_per_iter"])
        macs = rows * (d * h + 2 * nb * h * h + h * d)
        return dict(rows=rows, hidden=h, dim=d, n_blocks=nb, forwards=steps, adam_heads=steps,
                    perturbs=steps - n, flops_bf16=2 * steps * macs, ops_int8=0)

    def call_device_s(self) -> List[float]:
        if not self.events:
            return []
        torch.cuda.synchronize()
        return [a.elapsed_time(b) * 1e-3 for a, b in self.events]

    def release(self) -> None:
        self.comp = None

    def _normals(self, i: int, rows: int):
        g = inputs.generator(self.seed, 10, i, device=self.dev)
        if self.kernel_normals:
            pseed = program.draw_seed_value(g)
            return lambda s: philox.normals_grid(pseed, s, 0, rows, self.dim, device=self.dev)
        total = int(self.traffic["iterations"]) * int(self.traffic["steps_per_iter"])
        steps = [torch.randn((rows, self.dim), generator=g, device=self.dev)
                 for _ in range(total)]
        return lambda s: steps[s]

    @torch.no_grad()
    def check(self) -> Dict[str, float]:
        scorefc.no_tf32()
        sde = scorefc.SubVP(self.config["sde"])
        grid = sde.grid(float(self.traffic["eps"]))
        m = self.config["model"]
        net = scorefc.ScoreFC(self.weights, m)
        stand_in = None
        if self.control == "reference_int8":
            g = inputs.generator(self.seed, 12, device=self.dev)
            z = torch.randn((256, self.dim), generator=g, device=self.dev)
            noise = torch.randn((sde.N, 256, self.dim), generator=g, device=self.dev)
            amax = tasks.calibrate_per_channel(net, sde, float(self.traffic["eps"]), z, noise)
            stand_in = scorefc.ScoreFC(self.weights, m, scorefc.Quant.per_channel(
                self.weights, amax, int(m["n_blocks"]), 127))
        rows = self.poses * self.hypo
        gap_max, gap_rms = 0.0, 0.0
        for i, kept in sorted(self.kept.items, key=lambda kv: kv[0]):
            obs, mask = (t.repeat(self.hypo, 1) for t in self.inputs_of(i))
            normals = self._normals(i, rows)
            args = (sde, grid, obs, mask, self.poses * self.dim, normals, self.traffic)
            want = tasks.complete(net, *args)
            got = (tasks.complete(stand_in, *args) if stand_in is not None else
                   kept.transpose(0, 1).reshape(rows, self.dim))
            moved, diff = want - obs, (got - want).abs()
            gap_max = max(gap_max, float(diff.max() / moved.abs().max()))
            gap_rms = max(gap_rms, float(diff.pow(2).mean().sqrt() / moved.pow(2).mean().sqrt()))
        return {"solve_gap_max": gap_max, "solve_gap_rms": gap_rms}
