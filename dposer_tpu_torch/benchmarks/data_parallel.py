"""Data-parallel training against one process: the kernel train step of the
pinned weights over a process group, one rank a device.

    python -m dposer_tpu_torch.benchmarks.data_parallel [--steps 100] \\
        [--batch 1280] [--ckpt-path P] [--device cuda|cpu]

One process first runs ``--steps`` kernel steps (``fused_train.
get_cuda_step_fn``: K10 x5, K11, K12 x5 a step; the flagship config's
dropout and optimizer) from the checkpoint's weights, on global batches of
``--batch`` rows drawn by index from ``POOL`` standard normal rows (the
normalized pose space), ``WINDOW`` steps a window through
``parallel.sharding.data_parallel_multi_step_indexed``. Then one process a
visible card runs the same steps over a process group at a localhost
rendezvous, each on its columns of every batch, the all-reduce on NCCL
(``init_distributed(backend="auto")``). Each rank times its windows, the
all-reduce inside every step (CUDA events around the step's
``allreduce_mean_``, between its backward and its update), and, after the
steps, the all-reduce alone; the last window of each run is traced with
``torch.profiler`` for the kernels' device time, which splits a step into
kernels, the all-reduce and the rest, when the device waits for its host.

Prints one JSON line: the ranks' backends, whether their parameters and EMA
are bit-equal (sha256), the largest relative difference of the first 20
losses from one process's and both last-50 means, ms a step of each rank and
of one process, the all-reduce's ms in a step and alone, its share of a step
and its bytes, the traced split of a step, the launches of a rank's step,
and the card's name and power limit. ``--device cpu`` with a small
``--batch`` and ``--steps`` checks the script (two gloo ranks, the kernels'
plain versions). Every process is joined within ``--timeout`` seconds.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import datetime
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dposer_tpu_torch import demo
from dposer_tpu_torch import train as train_cli
from dposer_tpu_torch.config import get_config
from dposer_tpu_torch.diffusion import losses as tlosses
from dposer_tpu_torch.diffusion.sde import SubVPSDE
from dposer_tpu_torch.ops.cuda import fused_em, fused_train
from dposer_tpu_torch.parallel import sharding

CKPT = os.path.join("artifacts", "trained_r5", "axis-zscore-400k-synth.pth")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WINDOW, POOL, ALLREDUCE_REPS, CHECK_STEPS = 10, 20000, 20, 20


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=1280, help="the global batch")
    ap.add_argument("--ckpt-path", default=CKPT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=300.0)
    return ap.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Time spans on ``device``'s clock: CUDA events in stream order on a
    card, the host's clock on the CPU (where the collectives block)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pairs = []

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def stop(self, start) -> None:
        self.pairs.append((start, self.mark()))

    def ms(self) -> list:
        """Each span's ms; the device must have passed every event."""
        return [a.elapsed_time(b) if self.cuda else 1e3 * (b - a) for a, b in self.pairs]


@contextlib.contextmanager
def timed_allreduce(spans: Spans):
    """Every ``sharding.allreduce_mean_`` call in the block, the all-reduce
    ``data_parallel_step`` runs between a step's backward and its update,
    timed by ``spans``: on a card the span also holds the time this rank's
    stream waits for the other ranks."""
    inner = sharding.allreduce_mean_

    def timed(grads, losses):
        start = spans.mark()
        out = inner(grads, losses)
        spans.stop(start)
        return out

    sharding.allreduce_mean_ = timed
    try:
        yield
    finally:
        sharding.allreduce_mean_ = inner


def device_split_ms(prof) -> dict:
    """Device ms in a ``torch.profiler`` trace: ``kernels`` (memory copies
    and sets included) and ``collective`` (NCCL's kernels); None for both
    where the trace holds no device time."""
    kernels = collective = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        us = e.time_range.end - e.time_range.start
        if "nccl" in e.name.lower():
            collective += us
        else:
            kernels += us
    if kernels + collective == 0.0:
        return dict(kernels=None, collective=None)
    return dict(kernels=kernels / 1e3, collective=collective / 1e3)


def train_steps(model, device, data: torch.Tensor, idx: torch.Tensor, profile: bool = False,
                window: int = WINDOW) -> dict:
    """The kernel steps of ``model`` on rows ``idx`` [steps, B] of ``data``
    (both on ``device``), ``window`` steps a window through
    ``data_parallel_multi_step_indexed``: alone the whole batch, in a group
    this rank's columns. Step s draws from a generator seeded by
    ``train.noise_seed(0, s)`` and hashes dropout with
    ``train.dropout_seed(0, s)``, as the trainer does. Returns the state,
    every step's loss, the launch and route counts, and, over the windows
    after the first: the median ms a step, the all-reduce's median ms inside
    a step and its median share of a window's wall. With ``profile`` and
    three windows or more, the last window runs under ``torch.profiler``
    (and its wall is left out): ``traced`` is its device ms a step
    (``device_split_ms``)."""
    state = tlosses.init_train_state(get_config(), model)
    run = sharding.data_parallel_multi_step_indexed(
        fused_train.get_cuda_step_fn(SubVPSDE(N=1000), model, reduce_mean=True))
    gen = torch.Generator(device=device)
    starts = list(range(0, idx.shape[0], window))
    traced_w = starts[-1] if profile and len(starts) >= 3 else None
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    losses, walls, in_step, shares, traced = [], [], [], [], None
    fused_em.reset_launch_counts()
    for w0 in starts:
        def noise(j, w0=w0):
            gen.manual_seed(train_cli.noise_seed(0, w0 + j))
            return dict(generator=gen, dropout_seed=train_cli.dropout_seed(0, w0 + j))

        cols = sharding.shard_global_multi_batch(idx[w0:w0 + window])
        spans = Spans(device)
        prof = (torch.profiler.profile(activities=acts) if w0 == traced_w
                else contextlib.nullcontext())
        sync(device)
        t0 = time.perf_counter()
        with prof, timed_allreduce(spans):
            rows = run(state, cols, data, noise)  # ends on the window's host read
        wall = time.perf_counter() - t0
        losses += [r["step_loss"] for r in rows]
        if w0 == traced_w:
            traced = {k: None if v is None else v / len(rows)
                      for k, v in device_split_ms(prof).items()}
            continue
        sync(device)
        walls.append(wall / len(rows))
        if spans.pairs:
            ms = spans.ms()
            in_step.append(float(np.median(ms)))
            shares.append(sum(ms) / (1e3 * wall))
    keep = slice(1, None) if len(walls) > 1 else slice(None)
    return dict(state=state, losses=losses, counts=fused_em.launch_counts(),
                routes=fused_em.route_counts(),
                ms_per_step=1e3 * float(np.median(walls[keep])),
                allreduce_in_step_ms=float(np.median(in_step[keep])) if in_step else None,
                allreduce_share=float(np.median(shares[keep])) if shares else None,
                traced=traced)


def state_digest(state) -> str:
    """sha256 of the parameters and the EMA, in order."""
    h = hashlib.sha256()
    for t in list(state.tx.params) + list(state.ema.shadow_params):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_main(url, rank, world, backend, device, ckpt, data_path, idx_path, out_path,
              timeout_s, profile=False, reps=ALLREDUCE_REPS) -> None:
    """One rank: ``train_steps`` in a group whose all-reduce runs on
    ``backend`` (``init_distributed``'s), on ``device``, then
    ``allreduce_mean_`` of the step's gradients and losses alone, ``reps``
    times; writes its losses, counts, digest and times as JSON."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sharding.init_distributed(url, world, rank, backend=backend,
                              timeout=datetime.timedelta(seconds=timeout_s))
    model, _ = demo.load_model(get_config(), ckpt, dev)
    r = train_steps(model.train(), dev, torch.as_tensor(np.load(data_path), device=dev),
                    torch.as_tensor(np.load(idx_path), device=dev), profile=profile)
    grads = [p.grad for p in r["state"].tx.params]
    losses = {k: torch.zeros((), device=dev) for k in ("step_loss", "score_loss")}
    for _ in range(3):
        sharding.allreduce_mean_(grads, losses)
    sync(dev)
    spans = Spans(dev)
    start = spans.mark()
    for _ in range(reps):
        sharding.allreduce_mean_(grads, losses)
    spans.stop(start)
    sync(dev)
    with open(out_path, "w") as f:
        json.dump(dict(losses=r["losses"], counts=r["counts"], routes=r["routes"],
                       digest=state_digest(r["state"]), ms_per_step=r["ms_per_step"],
                       allreduce_in_step_ms=r["allreduce_in_step_ms"],
                       allreduce_share=r["allreduce_share"], traced=r["traced"],
                       allreduce_alone_ms=spans.ms()[0] / reps,
                       grad_bytes=4 * sum(g.numel() for g in grads if g is not None),
                       backend=sharding.grad_backend(), world=sharding.process_count(),
                       device=str(dev)), f)
    dist.destroy_process_group()


RANK = """
import sys
sys.path.insert(0, {root!r})
from dposer_tpu_torch.benchmarks import data_parallel
data_parallel.rank_main(*{args!r})
"""


def start_ranks(args_by_rank):
    """``rank_main(*args)`` in one process a rank, all started at once."""
    return [subprocess.Popen([sys.executable, "-c", RANK.format(root=ROOT, args=tuple(a))],
                             cwd=os.getcwd(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for a in args_by_rank]


def join_ranks(procs, timeout_s: float, what: str) -> None:
    """Each process joined within ``timeout_s`` of this call; a hang or a
    non-zero exit raises; every process is stopped."""
    try:
        for r, proc in enumerate(procs):
            try:
                out, _ = proc.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"{what} rank {r}: no end within {timeout_s} s")
            if proc.returncode:
                raise RuntimeError(f"{what} rank {r} exited {proc.returncode}:\n{out[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run(model, device, data: torch.Tensor, idx: torch.Tensor, devices, backend: str,
        ckpt: str, timeout_s: float = 300.0, profile: bool = False) -> dict:
    """``train_steps`` of a copy of ``model`` here, then one rank a device of
    ``devices`` on the same rows (each loading ``ckpt``, which must hold
    ``model``'s weights), its all-reduce on ``backend``; returns ``one``
    (this process's run) and ``ranks`` (each rank's JSON) and the ranks'
    ``wall_s``. ``profile`` traces the last window of each run."""
    one = train_steps(copy.deepcopy(model).train(), device, data, idx, profile=profile)
    with tempfile.TemporaryDirectory(prefix="data_parallel_") as work:
        data_path, idx_path = os.path.join(work, "data.npy"), os.path.join(work, "idx.npy")
        np.save(data_path, data.cpu().numpy())
        np.save(idx_path, idx.cpu().numpy())
        url = f"tcp://127.0.0.1:{free_port()}"
        outs = [os.path.join(work, f"rank{r}.json") for r in range(len(devices))]
        t0 = time.perf_counter()
        join_ranks(start_ranks([(url, r, len(devices), backend, str(d), ckpt, data_path,
                                 idx_path, outs[r], timeout_s, profile)
                                for r, d in enumerate(devices)]), timeout_s, "data-parallel")
        wall = time.perf_counter() - t0
        ranks = []
        for p in outs:
            with open(p) as f:
                ranks.append(json.load(f))
    return dict(one=one, ranks=ranks, wall_s=wall)


def summary(res: dict) -> dict:
    """The comparison ``main`` prints: the ranks against one process. The
    all-reduce's share is of a step's wall, the all-reduce timed inside the
    step. ``split_ms_per_step`` splits each rank's and one process's step:
    ``kernels``, the traced device time of every kernel but NCCL's (the
    profiler slows the host, not the kernels); ``allreduce``, the span timed
    inside the untraced steps (the transfer and the wait for the slowest
    rank); ``other``, the rest of the step's wall, when the device waits for
    its host."""
    one, ranks = res["one"], res["ranks"]
    first = ranks[0]["losses"]
    rel = [abs(a / b - 1.0) for a, b in zip(first[:CHECK_STEPS], one["losses"][:CHECK_STEPS])]
    steps = len(first)

    def split(run):
        t = run["traced"]
        if t is None or t["kernels"] is None:
            return None
        ar = run.get("allreduce_in_step_ms") or 0.0
        return dict(kernels=t["kernels"], allreduce=ar,
                    other=run["ms_per_step"] - t["kernels"] - ar)

    return dict(
        ranks=len(ranks), backends=[r["backend"] for r in ranks],
        devices=[r["device"] for r in ranks],
        ranks_bit_equal=len({r["digest"] for r in ranks}) == 1
        and all(r["losses"] == first for r in ranks),
        first_losses_max_rel=max(rel), last50_means=[float(np.mean(first[-50:])),
                                                      float(np.mean(one["losses"][-50:]))],
        ms_per_step=[r["ms_per_step"] for r in ranks],
        one_process_ms_per_step=one["ms_per_step"],
        allreduce_in_step_ms=[r["allreduce_in_step_ms"] for r in ranks],
        allreduce_share=[r["allreduce_share"] for r in ranks],
        allreduce_alone_ms=[r["allreduce_alone_ms"] for r in ranks],
        grad_bytes=ranks[0]["grad_bytes"],
        split_ms_per_step=dict(ranks=[split(r) for r in ranks], one_process=split(one)),
        launches_per_step={k: v / steps for k, v in ranks[0]["counts"].items() if v},
        k10_routes=ranks[0]["routes"]["dense_gn_silu_train"], wall_s=res["wall_s"])


def main(argv=None) -> dict:
    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("data_parallel: no CUDA device (pass --device cpu to check "
                             "the script)")
        devices = [f"cuda:{r}" for r in range(torch.cuda.device_count())]
        backend = "auto"
    else:
        devices, backend = ["cpu"] * 2, "gloo"
    device = torch.device(devices[0])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    model, _ = demo.load_model(get_config(), args.ckpt_path, device)
    g = torch.Generator().manual_seed(5)
    data = torch.randn(POOL, model.n_poses * model.pose_dim, generator=g).to(device)
    idx = torch.randint(0, POOL, (args.steps, args.batch), generator=g).to(device)
    out = summary(run(model, device, data, idx, devices, backend, args.ckpt_path,
                      args.timeout, profile=True))
    out.update(steps=args.steps, global_batch=args.batch, card=card_line())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
