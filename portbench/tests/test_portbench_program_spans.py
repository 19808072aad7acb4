"""The readers of the program's own spans and counters (``metrics/_program.py``)
on the CPU at a tiny size: the program-traced phase runs once a run, after
the requests the harness timed, and each reader reads it; a program without
the recorder runs no phase and every reader reads None."""
import importlib
import io
import time
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.metrics import _program
from portbench.tests import tiny

NEW = {
    "gen_bf16_500x1000": ["replay_device_ms.gen", "loop_idle_pct.gen", "graph_hit_pct.gen",
                          "build_s.gen"],
    "comp_bf16_100x10": ["task_self_ms.comp", "replay_device_ms.comp", "loop_idle_pct.comp",
                         "graph_hit_pct.comp", "build_s.comp"],
    "train_bf16_b1280": ["fwd_host_ms.train", "bwd_host_ms.train", "update_host_ms.train",
                         "build_s.train"],
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def traced_run(root, workload):
    """A run as the harness leaves it before its readers: the cell set up on
    the CPU, its trace requests timed, a trace standing in for the
    profiler's."""
    spec = harness.cell_spec(root, workload)
    driver = importlib.import_module(f"portbench.drivers.{spec.traffic['driver']}")
    cell = driver.Cell(spec.config, spec.traffic, 2 ** 33 + 5, "cpu")
    n = int(spec.traffic["trace_requests"])
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        cell.request(i)
        lat.append(time.perf_counter() - t0)
    return SimpleNamespace(cell=cell, spec=spec, n=n, latencies=lat, trace=object())


@pytest.mark.parametrize("workload", list(NEW))
def test_the_phase_runs_once_and_each_reader_reads_it(root, workload, monkeypatch):
    run = traced_run(root, workload)
    err = io.StringIO()
    monkeypatch.setattr(_program.sys, "stderr", err)
    got = {name: harness.reader(name)(run) for name in NEW[workload]}
    p = run.program
    assert len(p.latencies) == run.n and p.wall_s > 0
    assert {s.request for s in p.spans} == set(range(2 * run.n + 1, 4 * run.n, 2))
    assert {m["name"] for m in run.spec.per_layer} >= set(NEW[workload])
    lines = err.getvalue().splitlines()
    assert any(line.startswith("span ") for line in lines)
    assert any(line.startswith("program spans: a request's mean host ms") for line in lines)
    assert got[f"build_s.{workload.split('_')[0]}"] > 0
    if workload.startswith("train"):
        assert all(got[m] > 0 for m in NEW[workload])
        assert p.counters["train_host_reads"] == run.n
        assert p.summary["train.step"][0] == p.summary["train.forward"][0]
    else:  # the CPU runs the eager loop: no replay, no graph hit
        assert got[f"replay_device_ms.{workload.split('_')[0]}"] is None
        assert got[f"loop_idle_pct.{workload.split('_')[0]}"] is None
        assert got[f"graph_hit_pct.{workload.split('_')[0]}"] == 0.0
        assert p.summary["loop.eager"][0] == run.n == p.summary["loop.call"][0]
    if workload.startswith("comp"):
        assert 0 < got["task_self_ms.comp"] < 1e3 * max(run.latencies + p.latencies)
        assert p.counters["solver_lookups"] == run.n and "solver_builds" not in p.counters
    before = run.program
    assert harness.reader(NEW[workload][0])(run) == got[NEW[workload][0]]
    assert run.program is before  # read once


def test_without_the_recorder_no_phase_runs(root, monkeypatch):
    run = traced_run(root, "comp_bf16_100x10")
    calls = []
    monkeypatch.setattr(run.cell, "request", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(_program, "recorder", lambda: None)
    assert all(harness.reader(m)(run) is None for m in NEW["comp_bf16_100x10"])
    assert calls == [] and run.program is None


def test_untraced_run_reads_nothing(root):
    run = traced_run(root, "gen_bf16_500x1000")
    run.trace = None
    assert all(harness.reader(m)(run) is None for m in NEW["gen_bf16_500x1000"])


def test_setup_summary_nests_by_depth():
    s = 1_000_000_000
    setup = [("quant.calibrate", 0, 2 * s, 1), ("build.sampler", 0, 3 * s, 0),
             ("loop.warmup", 4 * s, 5 * s, 0)]
    assert _program.setup_seconds(setup) == pytest.approx(4.0)
    summary = _program.setup_summary(setup)
    assert summary["build.sampler"] == (1, pytest.approx(3.0), pytest.approx(1.0))
    assert summary["quant.calibrate"] == (1, pytest.approx(2.0), pytest.approx(2.0))
