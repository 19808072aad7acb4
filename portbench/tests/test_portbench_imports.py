"""A run loads neither JAX nor the JAX package: compared by whole top-level
names, so the port (``dposer_tpu_torch``) does not match ``dposer_tpu``."""
import subprocess
import sys
from pathlib import Path

from portbench import harness

REPO = Path(__file__).resolve().parents[2]

CODE = """
import sys, time, tempfile
from pathlib import Path
from portbench import harness
from portbench.tests import tiny
root = tiny.make(Path(tempfile.mkdtemp()))
for w in ("gen_bf16_500x1000", "comp_bf16_100x10", "train_bf16_b1280", "gen_int8ch_500x1000"):
    harness.run(root, w, 5, 0.05, False, time.perf_counter(), device="cpu",
                err=open("/dev/null", "w"))
    import portbench.run
print(harness.forbidden_modules(), "dposer_tpu_torch" in sys.modules)
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", CODE], capture_output=True, text=True,
                         cwd=REPO, timeout=600, check=True).stdout.strip().splitlines()[-1]
    assert out == "[] True"


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dposer_tpu_torch_x", sys)
    assert "dposer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
