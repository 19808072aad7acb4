"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload gen_bf16_500x1000 --seed 7 --seconds 15 --trace 0

From the root of a checkout. Prints, as the last line of standard output, one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit), and the numbers compared as the last lines of standard
error. Exits non-zero, printing no result, without as many CUDA devices as
the cell asks for, or if JAX or its package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = ".portbench_cache"


def fix_caches(root: Path) -> None:
    """Every kernel cache, and Python's bytecode, at a fixed directory inside
    the checkout. Where the environment forbids bytecode beside the sources
    (``PYTHONDONTWRITEBYTECODE``) and PyTorch ships none, every run would
    compile PyTorch's modules again: on the H100's host 2-3 s of ``torch``'s
    import and 3-5 s of ``torch._dynamo``'s."""
    base = root / CACHE
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(base / sub)
    sys.pycache_prefix = str(base / "pycache")
    sys.dont_write_bytecode = False


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="a lower-precision stand-in, for the readings a limit is set from")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = Path.cwd()
    fix_caches(root)
    from portbench import harness

    try:
        res = harness.run(root, args.workload, args.seed, args.seconds, bool(args.trace),
                          T_START, control=args.control)
    except harness.RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
