"""The control: each cell with its lower-precision stand-in in the program's
place comes out not correct under the committed limits (on the CPU at a tiny
size; the readings the limits were set from come from the card at the
cells' own sizes, PERF.md)."""
import time

import pytest

from portbench import harness
from portbench.tests import tiny

CONTROL = {"gen_bf16_500x1000": "program_int8", "gen_int8ch_500x1000": "reference_int4",
           "comp_bf16_100x10": "reference_int8", "train_bf16_b1280": "reference_fp8"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
@pytest.mark.parametrize("workload", list(CONTROL))
def test_control_fails(root, workload, seed):
    res = harness.run(root, workload, seed, 0.1, False, time.perf_counter(), device="cpu",
                      control=CONTROL[workload], err=open("/dev/null", "w"))
    assert not res["correct"], res["checks"]
