"""Run directories, logging and scalar metrics (port of
``dposer_tpu/utils/generic.py``; ref lib/utils/generic.py)."""
from __future__ import annotations

import json
import logging
import os
import time


def create_logger(output_dir: str = "output", train_dataset: str = "amass",
                  test_dataset: str = "amass", phase: str = "train",
                  name: str = "") -> tuple:
    """A timestamped run directory ``<output_dir>/<train>_<test>/<time>[-name]``
    and a logger writing to ``<phase>.log`` there and to the console
    (ref generic.py:7-48). Returns ``(logger, run directory)``."""
    run_name = f"{time.strftime('%Y-%m-%d-%H-%M-%S')}{'-' + name if name else ''}"
    final_output_dir = os.path.join(output_dir, f"{train_dataset}_{test_dataset}", run_name)
    os.makedirs(final_output_dir, exist_ok=True)
    # the run directory in the logger's name: two runs in one process (and
    # one second) keep their own handlers and files
    logger = logging.getLogger(f"dposer_tpu_torch:{final_output_dir}:{phase}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)-15s %(message)s")
        fh = logging.FileHandler(os.path.join(final_output_dir, f"{phase}.log"))
        fh.setFormatter(fmt)
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(ch)
    return logger, final_output_dir


def close_logger(logger: logging.Logger) -> None:
    """Close and detach the logger's handlers (its log file)."""
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)


class MetricWriter:
    """Scalar metrics: always mirrored to ``<logdir>/metrics.jsonl`` (one
    JSON object a line), and to TensorBoard where it can be imported, unless
    the environment sets ``DPOSER_TENSORBOARD=0`` (its import can pull in
    TensorFlow, tens of seconds)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._tb = None
        SummaryWriter = None
        if os.environ.get("DPOSER_TENSORBOARD", "1") != "0":
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
        if SummaryWriter is not None:
            self._tb = SummaryWriter(logdir)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step)}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
