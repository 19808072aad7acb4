"""A run with the timed path broken underneath comes out not correct; the
same run unbroken comes out correct. On the CPU at a tiny size: the look
for a card is skipped (``device="cpu"``), the rest of the run is the
harness's own, with the program's plain versions under the drivers."""
import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny


def run(root, workload, **kw):
    return harness.run(root, workload, 2 ** 33 + 11, 0.2, False, time.perf_counter(),
                       device="cpu", err=open("/dev/null", "w"), **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def break_sampler(monkeypatch, fault):
    from dposer_tpu_torch.ops.cuda import fused_em

    real = fused_em.get_cuda_em_sampler

    def build(*a, **kw):
        sampler = real(*a, **kw)

        def broken(generator=None, z=None, **k):
            trajs, out = sampler(generator, z=z, **k)
            if fault == "unchanged":  # no step moves the state
                return z.expand_as(trajs).clone(), z.clone()
            if fault == "half":  # the second half of the rows never sampled
                half = out.shape[0] // 2
                trajs[:, half:], out[half:] = trajs[:, :half], out[:half]
            if fault == "altered":  # one pose element altered where it is produced
                out[0, 0] = -out[0, 0] + 1.0
            return trajs, out

        broken.loops = sampler.loops
        return broken

    monkeypatch.setattr(fused_em, "get_cuda_em_sampler", build)


def break_solver(monkeypatch, fault):
    from dposer_tpu_torch.tasks.completion import DPoserComp

    real = DPoserComp.optimize_hypos

    def broken(self, observation, mask, hypo, generator=None):
        out = real(self, observation, mask, hypo, generator)
        if fault == "unchanged":
            return observation[:, None, :].expand_as(out).clone()
        if fault == "half":
            half = out.shape[0] // 2
            out[half:] = out[:half]
        if fault == "altered":
            out[0, 0, 13] = -out[0, 0, 13] + 1.0
        return out

    monkeypatch.setattr(DPoserComp, "optimize_hypos", broken)


def break_train_step(monkeypatch, fault):
    from dposer_tpu_torch.ops.cuda import fused_train

    real = fused_train.get_cuda_step_fn

    def build(*a, **kw):
        step_fn = real(*a, **kw)

        def broken(state, batch, **k):
            if fault == "half":  # half of the batch left out, the mean over the rest
                return step_fn(state, batch[: batch.shape[0] // 2], **k)
            before = [p.detach().clone() for p in state.tx.params]
            losses = step_fn(state, batch, **k)
            if fault == "unchanged":  # the update never lands
                with torch.no_grad():
                    for p, b in zip(state.tx.params, before):
                        p.copy_(b)
                    for s, b in zip(state.ema.shadow_params, before):
                        s.copy_(b)
            if fault == "altered":  # the loss read back altered
                losses = {k: v * 1.5 for k, v in losses.items()}
            return losses

        return broken

    monkeypatch.setattr(fused_train, "get_cuda_step_fn", build)


BREAK = {"gen_bf16_500x1000": break_sampler, "gen_int8ch_500x1000": break_sampler,
         "comp_bf16_100x10": break_solver, "train_bf16_b1280": break_train_step}


@pytest.mark.parametrize("workload", list(BREAK))
def test_unbroken_run_is_correct(root, workload):
    res = run(root, workload)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", list(BREAK))
def test_fault_is_caught(root, workload, fault, monkeypatch):
    BREAK[workload](monkeypatch, fault)
    res = run(root, workload)
    assert not res["correct"], res["checks"]
