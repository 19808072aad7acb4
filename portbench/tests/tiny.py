"""A copy of the benchmark's files at a size the CPU runs in seconds: the
same cells, drivers, metrics and limits, with narrower layers, a short
reverse grid and small batches (the widths stay whole groups of 8 features
for GroupNorm(32))."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def make(root: Path, steps: int = 12, hidden: int = 256, embed: int = 64, rows: int = 4) -> Path:
    for sub in ("portbench/configs", "portbench/traffic", "portbench/limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["model"].update(hidden_dim=hidden, embed_dim=embed)
        cfg["sde"]["num_scales"] = steps
        cfg["training"]["batch_size"] = 1280
        if cfg.get("quant"):
            cfg["quant"]["calib_rows"] = 8
        (root / c["file"]).write_text(json.dumps(cfg))
    for t in (REPO / "portbench" / "traffic").glob("*.json"):
        tr = json.loads(t.read_text())
        if tr["driver"] == "generation":
            tr.update(rows=rows, record_steps=[0, 3, 4, steps - 2], check_requests=2,
                      trace_requests=2)
        elif tr["driver"] == "completion":
            tr.update(poses=rows, hypotheses=2, batches=3, iterations=2, steps_per_iter=3,
                      check_requests=2, trace_requests=2)
        elif tr["driver"] == "training":
            tr.update(rows=2000, trace_requests=2)
        (root / "portbench" / "traffic" / t.name).write_text(json.dumps(tr))
    for t in (REPO / "portbench" / "limits").glob("*.json"):
        shutil.copy(t, root / "portbench" / "limits" / t.name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
