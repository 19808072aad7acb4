"""``python -m dposer_tpu_torch.bench``, the port's headline line: on the CPU
at a tiny size it prints one JSON line with ``bench.py``'s keys and metric
name; without a card it refuses the card run and prints no result."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_source"}


def _run(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "dposer_tpu_torch.bench", *args],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=600)


def _bench_py_metric():
    with open(os.path.join(REPO, "bench.py")) as f:
        return re.search(r'"metric": "(\w+)"', f.read()).group(1)


def test_bench_entry_prints_bench_py_line_on_cpu():
    p = _run("--device", "cpu", "--samples", "4", "--steps", "3")
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert BENCH_KEYS <= set(res)
    assert res["metric"] == _bench_py_metric() == "subvp_generation_poses_per_sec"
    assert res["value"] > 0 and res["vs_baseline"] > 0
    assert res["unit"] == "poses/s (4 samples x 3 steps)"
    assert res["baseline_source"] == "fresh" and res["device"] == "cpu"


def test_bench_entry_refuses_the_card_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card run would start")
    p = _run()
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr
