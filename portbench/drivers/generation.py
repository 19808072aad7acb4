"""Generation traffic: one ``get_cuda_em_sampler`` call a request, each call's
poses copied to the host.

Traffic keys: ``rows`` (poses a call), ``eps``, ``record_steps`` (grid steps
whose state the sampler records for the check), ``check_requests``,
``trace_requests``. The configuration's ``quant`` (W8A8, per channel) runs the
hidden layers on the int8 kernels, calibrated at set-up on ``calib_rows``
poses.

The check follows the program step by step: from each recorded state the
reference computes the next step with the same normals, and from the state
before the last step the denoised output. It compares each with what the
program recorded, relative to the step's model term (``-g^2 score dt``), at
its widest (``step_gap_max``) and in root mean square (``step_gap_rms``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import inputs, program
from ..reference import philox, scorefc, tasks
from ..trace import setup_phase, span

# A step's model term below this share of the state is lost in the state's
# float32 rounding on both sides (the last steps near t = eps): the gap is
# measured against the term or this floor, whichever is larger.
FLOOR = 2.0 ** -14


def rms(t: torch.Tensor) -> torch.Tensor:
    return t.pow(2).mean().sqrt()


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control=None):
        with setup_phase("program imports"):
            from dposer_tpu_torch.ops.cuda import quant as quant_lib
            from dposer_tpu_torch.ops.cuda.fused_em import get_cuda_em_sampler

        self.config, self.traffic, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.control = control
        m = config["model"]
        self.dim = int(m["n_poses"]) * int(m["pose_dim"])
        self.rows, self.eps = int(traffic["rows"]), float(traffic["eps"])
        self.n_steps = int(config["sde"]["num_scales"])
        self.record = [int(s) for s in traffic["record_steps"]]
        with setup_phase("weights", self.dev):
            self.weights = inputs.make_weights(m, seed, self.dev)
        with setup_phase("model", self.dev):
            model = program.build_model(config, self.weights, self.dev)
            sde = program.build_sde(config)
        qcfg = config.get("quant") or ({"calib_rows": 256} if control == "program_int8" else None)
        self.cal = None
        act_amax = None
        if qcfg is not None:
            with setup_phase("calibration", self.dev):
                self.cal = self._calibration_inputs(int(qcfg["calib_rows"]))
                act_amax = quant_lib.calibrate_act_amax_per_channel(
                    sde, model, (self.cal[0].shape[0], self.dim), eps=self.eps, z=self.cal[0],
                    noise=self.cal[1], device=self.dev)
        self.kernel_normals = self.dev.type == "cuda"
        with setup_phase("sampler", self.dev):
            self.sampler = get_cuda_em_sampler(
                sde, model, (self.rows, self.dim), eps=self.eps, denoise=True,
                rng_mode="kernel" if self.kernel_normals else "host",
                quant="int8" if qcfg is not None else None, act_amax=act_amax, device=self.dev,
                trajectory_steps=self.record)
        self.kept = inputs.Reservoir(int(traffic["check_requests"]), seed)
        self.bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.events: List = []
        with setup_phase("warm-up", self.dev):  # the first call builds and captures
            self.sampler(inputs.generator(seed, 9, device=self.dev),
                         z=torch.zeros((self.rows, self.dim), device=self.dev))

    def _calibration_inputs(self, rows: int):
        g = inputs.generator(self.seed, 12, device=self.dev)
        z = torch.randn((rows, self.dim), generator=g, device=self.dev)
        noise = torch.randn((self.n_steps, 1, rows, self.dim), generator=g, device=self.dev)
        return z, noise

    def _z(self, i: int) -> torch.Tensor:
        return torch.randn((self.rows, self.dim), device=self.dev,
                           generator=inputs.generator(self.seed, 11, i, device=self.dev))

    def request(self, i: int, timed_device: bool = False) -> int:
        z = self._z(i)
        g = inputs.generator(self.seed, 10, i, device=self.dev)
        if timed_device:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        with span("sampler_call"):
            trajs, out = self.sampler(g, z=z)
        if timed_device:
            ev[1].record()
            self.events.append(ev)
        with span("copy_to_host"):
            out.cpu()
        self.bad += (~torch.isfinite(out)).any()
        self.kept.offer(i, (trajs, out))
        return self.rows

    def failed(self) -> int:
        """Requests whose poses were not all finite."""
        return int(self.bad)

    def work(self, n: int) -> Dict[str, float]:
        m = self.config["model"]
        h, d, nb = int(m["hidden_dim"]), self.dim, int(m["n_blocks"])
        steps = n * self.n_steps
        hidden_macs = self.rows * (d * h + 2 * nb * h * h)
        head_macs = self.rows * h * d
        int8 = bool(self.config.get("quant"))
        return dict(rows=self.rows, hidden=h, dim=d, n_blocks=nb, forwards=steps,
                    em_heads=steps, flops_bf16=2 * steps * (head_macs + (0 if int8 else
                                                                         hidden_macs)),
                    ops_int8=2 * steps * hidden_macs if int8 else 0)

    def call_device_s(self) -> List[float]:
        if not self.events:
            return []
        torch.cuda.synchronize()
        return [a.elapsed_time(b) * 1e-3 for a, b in self.events]

    # -- the check ----------------------------------------------------------

    def _normals(self, i: int):
        """``normals(step)`` of request ``i``: the in-kernel Philox stream from
        the seed the call drew, or on the CPU the host stream it drew."""
        g = inputs.generator(self.seed, 10, i, device=self.dev)
        if self.kernel_normals:
            pseed = program.draw_seed_value(g)
            return lambda s: philox.normals_grid(pseed, s, 0, self.rows, self.dim,
                                                 device=self.dev)
        steps = [torch.randn((1, self.rows, self.dim), generator=g, device=self.dev)[0]
                 for _ in range(self.n_steps)]
        return lambda s: steps[s]

    def _reference(self, levels: Optional[int]):
        """The reference network: float32, or integer with the configuration's
        calibration (``levels`` 127 for int8, 7 for int4)."""
        w, m = self.weights, self.config["model"]
        net = scorefc.ScoreFC(w, m)
        if levels is None:
            return net
        cal = self.cal if self.cal is not None else self._calibration_inputs(
            int((self.config.get("quant") or {}).get("calib_rows", 256)))
        sde = scorefc.SubVP(self.config["sde"])
        amax = tasks.calibrate_per_channel(net, sde, self.eps, cal[0], cal[1][:, 0])
        return scorefc.ScoreFC(w, m, scorefc.Quant.per_channel(w, amax, int(m["n_blocks"]),
                                                              levels))

    def release(self) -> None:
        self.sampler = None

    @torch.no_grad()
    def check(self) -> Dict[str, float]:
        scorefc.no_tf32()
        sde = scorefc.SubVP(self.config["sde"])
        grid = sde.grid(self.eps)
        states = self.config.get("quant")
        ref = self._reference(127 if states else None)
        stand_in = self._reference(7) if self.control == "reference_int4" else None
        pos = {s: j for j, s in enumerate(self.record)}
        gap_max, gap_rms = 0.0, 0.0
        for i, (trajs, out) in sorted(self.kept.items, key=lambda kv: kv[0]):
            normals = self._normals(i)
            pairs = [(self._z(i), 0, trajs[pos[0]])] if 0 in pos else []
            pairs += [(trajs[pos[s]], s + 1, trajs[pos[s + 1]]) for s in self.record
                      if s + 1 in pos]
            if self.n_steps - 2 in pos:
                pairs.append((trajs[pos[self.n_steps - 2]], self.n_steps - 1, out))
            for x, step, got in pairs:
                last = step == self.n_steps - 1
                x_new, x_mean, term = tasks.em_step(ref, sde, grid, step, x, normals(step))
                want = x_mean if last else x_new
                if stand_in is not None:
                    s_new, s_mean, _ = tasks.em_step(stand_in, sde, grid, step, x, normals(step))
                    got = s_mean if last else s_new
                diff = (got - want).abs()
                gap_max = max(gap_max, float(diff.max() / (term.abs().max()
                                                          + FLOOR * x.abs().max())))
                gap_rms = max(gap_rms, float(rms(diff) / (rms(term) + FLOOR * rms(x))))
        return {"step_gap_max": gap_max, "step_gap_rms": gap_rms}
