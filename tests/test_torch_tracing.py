"""The program's spans and counters (``dposer_tpu_torch/utils/profiling.py``):
off, a span records nothing and opens no ``record_function``; on, spans nest
with their parent and request id on the clock of the profiler's own events;
the task, the loop, the set-up and the train step emit their named spans in
order on the CPU; ``counters()`` reads the solver's builds and lookups. One
test needs the card: a graph replay's CUDA events and ``GraphLoop.replays``.

The file imports no JAX, so the card's test runs where JAX is not installed:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""
import contextlib
from types import SimpleNamespace

import pytest
import torch

from dposer_tpu_torch.diffusion import sde as tsde
from dposer_tpu_torch.diffusion.losses import init_train_state
from dposer_tpu_torch.models import ScoreModelFC
from dposer_tpu_torch.ops.cuda import graph_loop
from dposer_tpu_torch.ops.cuda.fused_comp import get_cuda_comp_solver
from dposer_tpu_torch.ops.cuda.fused_em import get_cuda_em_sampler
from dposer_tpu_torch.ops.cuda.fused_train import get_cuda_step_fn
from dposer_tpu_torch.parallel import sharding
from dposer_tpu_torch.tasks.completion import DPoserComp
from dposer_tpu_torch.utils import profiling

SHAPE = (4, 63)


@pytest.fixture(autouse=True)
def clean():
    """Every test starts and ends with spans off and nothing recorded."""
    profiling.enable(False)
    profiling.take()
    profiling.take_setup()
    yield
    profiling.enable(False)
    profiling.take()
    profiling.take_setup()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=128, embed_dim=64, n_blocks=2,
                        dropout=0.0)


def names(spans):
    return [s.name for s in spans]


def outline(spans):
    """``(name, parent's name)`` in the order the spans opened."""
    return [(s.name, None if s.parent is None else spans[s.parent].name) for s in spans]


def test_off_records_nothing(monkeypatch):
    """Off (the default): ``span``, ``request`` and ``device_events`` give the
    shared no-op, read no clock and open no ``record_function``."""
    def refuse(*a, **k):
        raise AssertionError("an off span reached the profiler or the clock")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    spanned = profiling.spanned("fn")(lambda x: x + 1)
    for _ in range(3):
        with profiling.request(7), profiling.span("outer"), profiling.span("inner"):
            with profiling.device_events():
                assert spanned(1) == 2
    assert profiling.span("a") is profiling.span("b") is profiling.request(1)
    assert profiling.take() == []


def test_on_records_nesting_parent_request_and_self_time():
    assert profiling.enable(True) is False
    with profiling.request(3):
        with profiling.span("outer"):
            with profiling.span("a"):
                pass
            with profiling.span("b"):
                with profiling.span("a"):
                    pass
    with profiling.span("after"):
        pass
    spans = profiling.take()
    assert outline(spans) == [("outer", None), ("a", "outer"), ("b", "outer"), ("a", "b"),
                              ("after", None)]
    assert [s.request for s in spans] == [3, 3, 3, 3, None]
    assert all(s.end_ns >= s.start_ns and s.device_s is None for s in spans)
    outer, a, b, a2, _ = spans
    assert outer.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= a2.start_ns <= b.end_ns
    selfs = profiling.self_seconds(spans)
    assert selfs[0] == pytest.approx(outer.seconds - a.seconds - b.seconds, abs=1e-12)
    assert selfs[2] == pytest.approx(b.seconds - a2.seconds, abs=1e-12)
    assert selfs[1] == pytest.approx(a.seconds, abs=1e-12)
    summary = profiling.summary(spans)
    assert summary["a"] == (2, pytest.approx(a.seconds + a2.seconds, abs=1e-12),
                            pytest.approx(a.seconds + a2.seconds, abs=1e-12))
    assert profiling.take() == []


def test_spans_share_the_profilers_clock():
    """Under a CPU ``torch.profiler`` window each span opens its ``dp.``
    copy, whose start in the profiler's events lies within 1 ms of the
    span's recorded start: no offset between the two clocks."""
    from torch.profiler import ProfilerActivity, profile

    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with profiling.request(i), profiling.span(f"s{i}"):
                torch.ones(16).sum()
    spans = profiling.take()
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith(profiling.PREFIX)}
    assert sorted(events) == ["dp.s0", "dp.s1", "dp.s2"]
    for s in spans:
        assert abs(events[profiling.PREFIX + s.name].start_ns() - s.start_ns) < 1_000_000


def test_setup_spans_are_timed_when_off():
    """A set-up span is timed and kept while spans are off, with its depth
    among set-up spans; on, it is a span besides."""
    with profiling.setup_span("build.x") as outer:
        with profiling.setup_span("quant.y") as inner:
            pass
    assert outer.seconds >= inner.seconds >= 0 and profiling.take() == []
    got = profiling.take_setup()
    assert [(n, d) for n, _, _, d in got] == [("quant.y", 1), ("build.x", 0)]
    assert got[1][2] - got[1][1] == pytest.approx(outer.seconds * 1e9, abs=1)
    profiling.enable(True)
    with profiling.setup_span("build.z"):
        pass
    assert names(profiling.take()) == ["build.z"]
    assert [n for n, *_ in profiling.take_setup()] == ["build.z"]


def test_eager_sampler_emits_its_spans(model):
    profiling.enable(True)
    sampler = get_cuda_em_sampler(tsde.SubVPSDE(N=6), model, SHAPE, device="cpu")
    g = torch.Generator().manual_seed(1)
    for i in range(2):
        with profiling.request(i):
            sampler(g)
    spans = profiling.take()
    assert outline(spans) == [("build.sampler", None),
                              ("loop.call", None), ("loop.eager", "loop.call"),
                              ("loop.call", None), ("loop.eager", "loop.call")]
    assert [s.request for s in spans] == [None, 0, 0, 1, 1]


def test_solver_and_optimize_hypos_emit_their_spans_and_count_the_builds(model):
    sde = tsde.SubVPSDE(N=100)
    kw = dict(iterations=1, steps_per_iter=3)
    profiling.enable(True)
    solve = get_cuda_comp_solver(sde, model, SHAPE, SHAPE[0] * SHAPE[1], device="cpu", **kw)
    obs, mask = torch.zeros(SHAPE), torch.ones(SHAPE)
    solve(torch.Generator().manual_seed(2), obs, mask)
    assert outline(profiling.take()) == [("build.solver", None), ("loop.call", None),
                                         ("loop.eager", "loop.call")]

    comp = DPoserComp(sde, model=model, backend="cuda", device="cpu", **kw)
    before = profiling.counters()
    g = torch.Generator().manual_seed(3)
    for i in range(3):
        with profiling.request(i):
            out = comp.optimize_hypos(obs[:2], mask[:2], 2, g)
    assert out.shape == (2, 2, 63)
    after = profiling.counters()
    assert after["solver_builds"] - before["solver_builds"] == 1
    assert after["solver_lookups"] - before["solver_lookups"] == 3
    spans = profiling.take()
    first = [("comp.optimize_hypos", None), ("comp.solver", "comp.optimize_hypos"),
             ("build.solver", "comp.solver"), ("loop.call", "comp.optimize_hypos"),
             ("loop.eager", "loop.call")]
    later = [first[0], first[1]] + first[3:]
    assert outline(spans) == first + later + later
    assert [s.request for s in spans] == [0] * 5 + [1] * 4 + [2] * 4
    task = profiling.self_seconds(spans)[0]
    assert 0 <= task <= spans[0].seconds


def test_plain_route_train_step_emits_its_spans(model):
    cfg = SimpleNamespace(
        optim=SimpleNamespace(optimizer="Adam", lr=2e-4, beta1=0.9, eps=1e-8, weight_decay=0.0,
                              warmup=0, grad_clip=1.0),
        model=SimpleNamespace(ema_rate=0.999))
    profiling.enable(True)
    state = init_train_state(cfg, model)
    step_fn = get_cuda_step_fn(tsde.SubVPSDE(N=1000), model, plain=True)
    assert names(profiling.take()) == ["train.init", "train.init"]
    assert [n for n, *_ in profiling.take_setup()] == ["train.init", "train.init"]
    multi = sharding.data_parallel_multi_step(step_fn)
    reads = profiling.counters()["train_host_reads"]
    g = torch.Generator().manual_seed(4)
    batches = [torch.randn(SHAPE, generator=g) for _ in range(2)]
    with profiling.request(0):
        out = multi(state, batches, lambda j: dict(generator=g, dropout_seed=j))
    assert len(out) == 2 and profiling.counters()["train_host_reads"] == reads + 1
    step = [("train.step", "train.window"), ("train.forward", "train.step"),
            ("train.backward", "train.step"), ("train.update", "train.step")]
    assert outline(profiling.take()) == ([("train.window", None)] + step + step
                                         + [("train.loss_read", "train.window")])


class _Stand:
    """Stands in for a CUDA stream: waits are no-ops."""

    def wait_stream(self, other):
        pass


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_spans_with_the_cards_calls_stood_in_for(monkeypatch):
    """``GraphLoop`` on the CPU with its CUDA calls stood in for: the first
    call's set-up spans (also timed with spans off, into ``warmup_s``,
    ``capture_s``, ``instantiate_s``), a ``loop.replay`` span a call and
    ``GraphLoop.replays`` once a call."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _Stand())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _Stand())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    out = torch.zeros(3)
    inputs = dict(z=torch.zeros(3))

    def body(warm_up=False):
        return out.copy_(inputs["z"] * 2)

    runner = graph_loop.GraphLoop(body, inputs, graph=True)
    replays = graph_loop.GraphLoop.replays
    runner(dict(z=torch.ones(3)))
    setup = profiling.take_setup()
    assert [n for n, *_ in setup] == ["loop.warmup", "loop.capture", "loop.instantiate"]
    got = [runner.warmup_s, runner.capture_s, runner.instantiate_s]
    assert got == [pytest.approx((e - s) * 1e-9, abs=1e-12) for _, s, e, _ in setup]
    assert profiling.take() == [] and graph_loop.GraphLoop.replays == replays + 1
    profiling.enable(True)
    monkeypatch.setattr(profiling, "device_events", lambda *a, **k: contextlib.nullcontext())
    runner(dict(z=torch.full((3,), 2.0)))
    assert names(profiling.take()) == ["loop.replay"]
    assert graph_loop.GraphLoop.replays == replays + 2


@pytest.mark.cuda
def test_graph_replay_records_its_device_time(model):
    """On the card: a replayed solve records one pair of CUDA events on its
    ``loop.replay`` span and adds one to ``GraphLoop.replays`` a call; the
    first call's capture is its set-up spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    m = ScoreModelFC(n_poses=21, pose_dim=3, hidden_dim=1024, embed_dim=512, n_blocks=2,
                     dropout=0.0).to(dev)
    rows = 64
    solve = get_cuda_comp_solver(tsde.SubVPSDE(N=1000), m, (rows, 63), rows * 63,
                                 iterations=1, steps_per_iter=4, rng_mode="kernel", device=dev)
    assert [lp.graph for lp in solve.loops] == [True]
    obs, mask = torch.zeros((rows, 63), device=dev), torch.ones((rows, 63), device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    solve(g, obs, mask)  # captures
    assert {n for n, *_ in profiling.take_setup()} >= {"build.solver", "loop.warmup",
                                                        "loop.capture", "loop.instantiate"}
    replays = graph_loop.GraphLoop.replays
    profiling.enable(True)
    for i in range(3):
        with profiling.request(i):
            solve(g, obs, mask)
    profiling.enable(False)
    spans = profiling.take()
    assert outline(spans) == [("loop.call", None), ("loop.replay", "loop.call")] * 3
    assert graph_loop.GraphLoop.replays == replays + 3
    for s in spans:
        if s.name == "loop.replay":
            assert s.device_s > 0
        else:
            assert s.device_s is None
