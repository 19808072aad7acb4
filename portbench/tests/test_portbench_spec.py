"""The benchmark's files: every name in BENCHMARK.json is found, and they
keep to the contract's shape."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and "portbench" in BENCH["paths"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for w in m.get("workloads", CELLS):
            spec = harness.cell_spec(REPO, w)
            assert m["moves"] in [e["name"] for e in spec.end_to_end], (m["name"], w)
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
def test_cell_finds_its_files(workload):
    """The configuration, the traffic and its driver, the limits and one
    reader a metric, all by name; every cell reports setup_s, another
    end-to-end metric and a per-layer one."""
    spec = harness.cell_spec(REPO, workload)
    assert isinstance(spec.config["reduced"], list) and spec.config["source"].startswith("https://")
    __import__(f"portbench.drivers.{spec.traffic['driver']}")
    assert spec.limits
    names = [m["name"] for m in spec.end_to_end + spec.per_layer]
    for name in names:
        assert callable(harness.reader(name))
    assert "setup_s" in names and len(spec.end_to_end) >= 2 and spec.per_layer


def test_rooflines_are_files():
    for m in BENCH["per_layer"]:
        if "_roofline" in m["name"]:
            kernel = m["name"].split("_roofline")[0]
            assert (REPO / "portbench" / "roofline" / f"{kernel}.py").exists()


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A cell added as a traffic file, a limits file and a workload entry
    runs, with no file of the harness edited."""
    import time

    from portbench.tests import tiny

    root = tiny.make(tmp_path)
    mix = json.loads((root / "portbench/traffic/gen_500x1000.json").read_text())
    mix["rows"] = 2
    (root / "portbench/traffic/gen_2x12.json").write_text(json.dumps(mix))
    (root / "portbench/limits/gen_bf16_2x12.json").write_text(
        (root / "portbench/limits/gen_bf16_500x1000.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="gen_bf16_2x12", config="dposer_subvp_bf16",
                                   traffic="gen_2x12", chips=1, why="a test cell"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "gen_bf16_500x1000" in m.get("workloads", []):
            m["workloads"].append("gen_bf16_2x12")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run(root, "gen_bf16_2x12", 3, 0.1, False, time.perf_counter(), device="cpu",
                      err=open("/dev/null", "w"))
    assert res["correct"] and set(res["metrics"]) == {"poses_per_s", "setup_s"}
