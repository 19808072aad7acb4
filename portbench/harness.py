"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the result line.

Everything a cell needs is found by name: the workload and its configuration
in ``BENCHMARK.json``, the configuration's file, ``portbench/traffic/<mix>.json``
(whose ``driver`` names a module of ``portbench/drivers``),
``portbench/limits/<workload>.json`` and one reader a metric,
``portbench/metrics/<metric>.py``.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

from . import trace as trace_lib

PACKAGE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dposer_tpu")


class RunError(Exception):
    """A run that prints no result; ``code`` is its exit code."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(root: Path, workload: str) -> SimpleNamespace:
    """The workload's entry, its configuration, traffic and limits, and the
    metrics it reports, from the files under ``root``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def reports(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return SimpleNamespace(
        cell=cell, config=load_json(root / cfg["file"]),
        traffic=load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(root / "portbench" / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)])


def reader(name: str):
    """The ``read(run)`` of ``portbench/metrics/<name>.py``."""
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    if spec is None or not path.exists():
        raise RunError(f"no reader for metric {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    v = sorted(values)
    at = (len(v) - 1) * q / 100.0
    lo = int(at)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (at - lo)


def closed_window(request, seconds: float, clock=time.perf_counter):
    """Requests one after the other until ``seconds`` have passed: ``(items,
    latencies, window_s)``, every request that started in the window counted,
    the window ending when the last one returns."""
    items, lat = 0, []
    start = clock()
    i = 0
    while True:
        t0 = clock()
        items += request(i)
        t1 = clock()
        lat.append(t1 - t0)
        i += 1
        if t1 - start >= seconds:
            return items, lat, t1 - start


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: Optional[str] = None, control: Optional[str] = None, err=sys.stderr) -> dict:
    """One run; returns the result's dict. With ``traced`` the window is the
    traffic's ``trace_requests`` requests timed by CUDA events and host spans,
    then as many under the profiler. ``device=None`` takes the card and
    refuses to run without as many as the cell asks for; a test passes
    ``"cpu"``. ``control`` swaps in a lower-precision stand-in, for the
    readings a limit is set from."""
    phases = trace_lib.SETUP_PHASES
    phases.clear()
    import torch

    phases.append(("torch import", time.perf_counter() - t_start))
    spec = cell_spec(root, workload)
    if device is None:
        with trace_lib.setup_phase("cuda init"):
            if not torch.cuda.is_available() or torch.cuda.device_count() < spec.cell["chips"]:
                raise RunError(f"the cell needs {spec.cell['chips']} CUDA device(s); "
                               f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                               f" visible", 3)
            device = f"cuda:{torch.cuda.current_device()}"
            torch.empty(0, device=device)  # the context
    cuda = torch.device(device).type == "cuda"
    with trace_lib.setup_phase("harness imports"):
        driver = importlib.import_module(f"portbench.drivers.{spec.traffic['driver']}")
    cell = driver.Cell(spec.config, spec.traffic, seed, device, control)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    tr, busy = None, []
    if traced:
        # first the timed requests (CUDA events and host spans, no profiler,
        # whose overhead would fall into both), then as many under the profiler
        n = int(spec.traffic["trace_requests"])
        t0 = time.perf_counter()
        lat, items = [], 0
        for i in range(n):
            t1 = time.perf_counter()
            items += cell.request(i, timed_device=cuda)
            lat.append(time.perf_counter() - t1)
        window_s = time.perf_counter() - t0
        traces: list = []
        with trace_lib.profiled(traces):
            for i in range(n, 2 * n):
                with trace_lib.span("request"):
                    cell.request(i)
        tr = traces[0]
    else:
        # an end-to-end metric of the device's time records the whole
        # window's device operations
        on_device = cuda and any(m["source"] == "device_trace" for m in spec.end_to_end)
        with trace_lib.device_busy(busy) if on_device else contextlib.nullcontext():
            items, lat, window_s = closed_window(cell.request, seconds)
            closed = time.perf_counter()
        trace_read_s = time.perf_counter() - closed
        n = len(lat)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = cell.failed()
    r = SimpleNamespace(cell=cell, spec=spec, n=n, items=items, latencies=lat,
                        window_s=window_s, setup_s=setup_s, trace=tr, work=cell.work(n),
                        device_busy_s=busy[0] if busy else None)
    metrics = {}
    for m in (spec.per_layer if traced else spec.end_to_end):
        value = reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = cell.check()
    t_check = time.perf_counter() - t_check
    checks = {k: {"value": v, "limit": spec.limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    bad = forbidden_modules()
    if bad:
        raise RunError(f"the run loaded {', '.join(bad)}", 4)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": spec.cell["chips"] if cuda else 0, "memory_peak_bytes": peak}
    res = {"correct": correct, "attempted": 2 * n if traced else n, "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        res["breakdown"] = tr.breakdown()
    for name, sec in trace_lib.SETUP_PHASES:
        print(f"setup {name} {sec!r}", file=err)
    if busy:
        print(f"after the window: the device trace read in {trace_read_s!r} s", file=err)
    print(f"after the window: the check in {t_check!r} s", file=err)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    res["checks"] = checks
    return res
