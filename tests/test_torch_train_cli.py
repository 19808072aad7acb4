"""``python -m dposer_tpu_torch.train --device cpu`` on a tiny config and
data layout: a smoke run on each route, resume (4 steps equal 2 steps and a
resume of 2, to the bit), SIGTERM's resumable checkpoint, the written
``.pth`` in the port's and the JAX package's loaders, an evaluation from the
pinned checkpoint, an evaluation outside the kernels' scope (TimeMLPs under
ald), ``Trace`` with the program's spans, and the refusal to start without a card."""
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dposer_tpu.utils.checkpoint import convert_torch_checkpoint
from dposer_tpu_torch import train as train_cli
from dposer_tpu_torch.config import load_config
from dposer_tpu_torch.diffusion import losses as tlosses
from dposer_tpu_torch.models import create_score_model
from dposer_tpu_torch.utils.checkpoint import (load_params_for_inference,
                                               restore_train_state, torch_parameter_order)
from dposer_tpu_torch.utils import profiling
from fixtures import make_synthetic_body_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "trained_r5", "axis-zscore-400k-synth.pth")
ENV = dict(os.environ, DPOSER_TENSORBOARD="0", OMP_NUM_THREADS="2",
           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))

CONFIG = """
from dposer_tpu_torch.config import get_config as _base


def get_config():
    c = _base()
    c.OUTPUT_DIR = {out!r}
    {model}
    c.training.batch_size, c.training.n_iters = {batch}, {n_iters}
    c.training.log_freq, c.training.eval_freq, c.training.save_freq = 1, {eval_freq}, {save_freq}
    c.eval.batch_size = 2
    return c
"""


def write_layout(root, n_train=160, n_test=200):
    rng = np.random.default_rng(0)
    for subset, n in (("train", n_train), ("test", n_test)):
        d = os.path.join(root, "v1", subset)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "pose_body.npy"),
                (0.4 * rng.normal(size=(n, 63))).astype(np.float32))
    return root


TINY = "c.model.HIDDEN_DIM, c.model.EMBED_DIM, c.model.N_BLOCKS = 64, 32, 1"


def write_config(path, out, n_iters=4, eval_freq=10 ** 9, save_freq=2, model=TINY,
                 batch=16):
    with open(path, "w") as f:
        f.write(CONFIG.format(out=str(out), n_iters=n_iters, eval_freq=eval_freq,
                              save_freq=save_freq, model=model, batch=batch))
    return str(path)


def cli_args(config, data, *extra):
    return ["--config", config, "--dataset-folder", data, "--version", "v1",
            "--bodymodel-path", "", "--device", "cpu", "--seed", "3", *extra]


def run_cli(args, timeout=180):
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.train", *args], cwd=REPO,
                       env=ENV, capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return p.stdout + p.stderr


def run_dir(out):
    (sub,) = os.listdir(os.path.join(out, "amass_amass"))
    return os.path.join(out, "amass_amass", sub)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_layout(str(tmp_path_factory.mktemp("amass")))


@pytest.fixture(scope="module", params=["off", "on"])
def resumed(request, data, tmp_path_factory):
    """Run A: 4 steps, checkpoints at 2 and 4; run B: A's step-2 checkpoint
    resumed to step 4. ``--train-kernel on`` runs the kernels' plain versions."""
    tmp = tmp_path_factory.mktemp(f"route_{request.param}")
    out = {}
    for run in ("a", "b"):
        cfg = write_config(tmp / f"{run}.py", tmp / run)
        extra = ["--train-kernel", request.param]
        if run == "b":
            extra += ["--restore-dir", os.path.join(run_dir(str(tmp / "a")),
                                                    "checkpoint-step2.pth")]
        out[run] = (run_cli(cli_args(cfg, data, *extra)), run_dir(str(tmp / run)))
    return request.param, out


def test_cli_smoke(resumed):
    route, out = resumed
    log, rdir = out["a"]
    want = "autograd step" if route == "off" else "kernel step: K10/K11/K12 on their plain"
    assert f"train step: {want}" in log
    assert "device-resident" in log
    for s in (2, 4):
        assert os.path.exists(os.path.join(rdir, f"checkpoint-step{s}.pth"))
    lines = open(os.path.join(rdir, "tb", "metrics.jsonl")).read().splitlines()
    losses = [json.loads(ln)["value"] for ln in lines if "step_loss" in ln]
    assert len(losses) == 4 and all(np.isfinite(losses))


def test_cli_resume_is_bit_exact(resumed):
    """Step noise keyed by (seed, step), the index stream's skip= and the
    whole Adam and EMA state in the checkpoint: the resumed run ends on the
    uninterrupted run's bits."""
    _, out = resumed
    a = torch.load(os.path.join(out["a"][1], "checkpoint-step4.pth"), weights_only=True)
    b = torch.load(os.path.join(out["b"][1], "checkpoint-step4.pth"), weights_only=True)
    assert "loaded checkpoint (step 2; optimizer state restored)" in out["b"][0]
    assert a["step"] == b["step"] == 4
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, b["model_state_dict"][k]), k
    for sa, sb in zip(a["ema"]["shadow_params"], b["ema"]["shadow_params"], strict=True):
        assert torch.equal(sa, sb)
    assert a["ema"]["num_updates"] == b["ema"]["num_updates"] == 4
    for i, st in a["optimizer_state_dict"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer_state_dict"]["state"][i][k]), (i, k)


def test_written_pth_loads_in_port_and_jax(resumed):
    """The reference schema: the port's inference loader and the JAX
    package's converter read the same EMA and raw parameters."""
    _, out = resumed
    path = os.path.join(out["a"][1], "checkpoint-step4.pth")
    sd, step = load_params_for_inference(path)
    raw, _ = load_params_for_inference(path, use_ema=False)
    cv = convert_torch_checkpoint(path, n_blocks=1)
    assert step == cv["step"] == 4
    assert cv["ema_num_updates"] == 4
    for ours, theirs in ((sd, cv["ema_params"]), (raw, cv["params"])):
        for name in torch_parameter_order(1):
            if name.startswith("pre_dense_cond"):
                continue
            prefix, leaf = name.rsplit(".", 1)
            mod = "shared_time_embed_0" if prefix == "shared_time_embed.0" else prefix
            if "gnorm" in mod:
                want = theirs[mod]["scale" if leaf == "weight" else "bias"]
            else:
                want = theirs[mod]["kernel"].T if leaf == "weight" else theirs[mod]["bias"]
            np.testing.assert_array_equal(ours[name].numpy(), np.asarray(want), err_msg=name)


def test_sigterm_writes_a_resumable_checkpoint(data, tmp_path):
    cfg = write_config(tmp_path / "c.py", tmp_path / "out", n_iters=10 ** 6,
                       save_freq=10 ** 9)
    p = subprocess.Popen([sys.executable, "-m", "dposer_tpu_torch.train",
                          *cli_args(cfg, data)], cwd=REPO, env=ENV, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        for line in p.stdout:
            if "Iter: [3/" in line or time.time() > deadline:
                break
        p.send_signal(signal.SIGTERM)
        rest, _ = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0, rest[-3000:]
    assert "preemption checkpoint saved" in rest
    rdir = run_dir(str(tmp_path / "out"))
    (ckpt,) = [f for f in os.listdir(rdir) if f.startswith("checkpoint-step")]
    config = load_config(cfg)
    state = tlosses.init_train_state(config, create_score_model(config))
    info = restore_train_state(os.path.join(rdir, ckpt), state)
    assert info["optimizer_restored"] and state.step >= 3
    assert state.tx.count() == state.step == int(ckpt[len("checkpoint-step"):-4])


def test_eval_from_the_pinned_checkpoint(tmp_path, monkeypatch):
    """Resume the pinned reference-schema .pth (no optimizer state: a fresh
    Adam), train two steps at flagship width and evaluate under the EMA:
    bits/dim, the left-leg completion and the APD of its samples, and the
    best-by-APD checkpoint."""
    data = write_layout(str(tmp_path / "amass"))
    smplx, _ = make_synthetic_body_model(str(tmp_path / "smplx.npz"), "smplx")
    cfg = write_config(tmp_path / "eval.py", tmp_path / "out", n_iters=400002, eval_freq=2,
                       save_freq=10 ** 9, model="pass  # flagship widths", batch=8)
    monkeypatch.setenv("DPOSER_TENSORBOARD", "0")
    torch.set_num_threads(2)
    res = train_cli.main(["--config", cfg, "--dataset-folder", data, "--version", "v1",
                          "--bodymodel-path", smplx, "--device", "cpu",
                          "--restore-dir", CKPT])
    assert res["step"] == 400002 and res["route"] == "autograd step"
    assert all(0.0 < v < 5.0 for v in res["losses"])
    assert np.isfinite(res["best_apd"]) and res["best_apd"] > 0
    log = open(os.path.join(res["output_dir"], "train.log")).read()
    assert "optimizer state fresh" in log and "Sample bpd:" in log
    with np.load(os.path.join(res["output_dir"], "last_samples.npz")) as f:
        assert f["pose_samples"].shape == (1, 2, 63)
    assert os.path.exists(os.path.join(res["output_dir"], "best_model.pth"))
    # the EMA continued from the checkpoint's counter
    assert res["state"].ema.num_updates == 400002


def test_eval_trajectory_and_profile_dir(tmp_path, monkeypatch):
    """From the pinned checkpoint, 20 steps with ``--profile-dir`` and an
    eval at the last: ``last_samples.npz`` holds ``pose_trajs`` [10, rows,
    63], the eval sampler's states at steps 0, 100, ..., 900 of the last
    call (axis-angle), and the trace file of local steps 10-20 holds each
    step's ``dp.train_step_<s>`` span."""
    data = write_layout(str(tmp_path / "amass"))
    cfg = write_config(tmp_path / "prof.py", tmp_path / "out", n_iters=400020, eval_freq=20,
                       save_freq=10 ** 9, model="pass  # flagship widths", batch=8)
    monkeypatch.setenv("DPOSER_TENSORBOARD", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = train_cli.main(["--config", cfg, "--dataset-folder", data, "--version", "v1",
                              "--bodymodel-path", "", "--device", "cpu", "--restore-dir", CKPT,
                              "--profile-dir", str(tmp_path / "prof")])
    finally:
        torch.set_num_threads(n)
    assert res["step"] == 400020 and res["last_eval"]["step"] == 400020
    trajs = res["last_eval"]["trajs"]
    assert trajs.shape == (10, 2, 63) and torch.isfinite(trajs).all()
    with np.load(os.path.join(res["output_dir"], "last_samples.npz")) as f:
        assert f["pose_trajs"].shape == (10, 2, 63) and f["pose_samples"].shape == (1, 2, 63)
        assert np.isfinite(f["pose_trajs"]).all()
    (trace,) = os.listdir(tmp_path / "prof")
    text = open(tmp_path / "prof" / trace).read()
    traced = {int(s) for s in re.findall(r'"dp\.train_step_(\d+)"', text)}
    assert traced == set(range(400011, 400021)), sorted(traced)
    assert "trace of local steps 10-20 saved" in open(
        os.path.join(res["output_dir"], "train.log")).read()


TIME_MLPS_ALD = ("c.model.type, c.model.HIDDEN_DIM, c.model.N_BLOCKS = 'TimeMLPs', 64, 1\n"
                 "    c.model.num_scales, c.sampling.corrector = 20, 'ald'")


def test_eval_outside_the_kernels_scope(tmp_path, monkeypatch):
    """A TimeMLPs model under the ald corrector (N = 20), which no kernel
    covers, trains two steps and evaluates through the plain PC loop: the
    bits/dim, the left-leg completion's hypotheses, the APD and the
    trajectory at steps 0, 2, ..., 18, as the JAX trainer evaluates every
    config."""
    data = write_layout(str(tmp_path / "amass"))
    smplx, _ = make_synthetic_body_model(str(tmp_path / "smplx.npz"), "smplx")
    cfg = write_config(tmp_path / "tm.py", tmp_path / "out", n_iters=2, eval_freq=2,
                       save_freq=10 ** 9, model=TIME_MLPS_ALD, batch=8)
    monkeypatch.setenv("DPOSER_TENSORBOARD", "0")
    res = train_cli.main(["--config", cfg, "--dataset-folder", data, "--version", "v1",
                          "--bodymodel-path", smplx, "--device", "cpu", "--seed", "3"])
    assert res["step"] == 2 and res["last_eval"]["step"] == 2
    assert type(res["state"].model).__name__ == "TimeMLPs"
    log = open(os.path.join(res["output_dir"], "train.log")).read()
    assert ("eval sampler: plain PC loop (predictor=euler_maruyama, corrector=ald)" in log
            and "Sample bpd:" in log and "APD:" in log)
    assert res["last_eval"]["trajs"].shape == (10, 2, 63)
    with np.load(os.path.join(res["output_dir"], "last_samples.npz")) as f:
        assert f["pose_trajs"].shape == (10, 2, 63) and f["pose_samples"].shape == (1, 2, 63)
        assert np.isfinite(f["pose_trajs"]).all() and np.isfinite(f["pose_samples"]).all()


def test_profile_trace_writes_its_spans(tmp_path):
    """``Trace`` turns the program's spans on while it runs and writes one
    trace file into the directory, holding the spans opened meanwhile;
    ``stop()`` turns them off again and keeps none in memory."""
    trace = profiling.Trace(str(tmp_path / "prof"))
    with profiling.span("outer_span"):
        torch.ones(8).sum()
    path = trace.stop()
    assert profiling.enable(False) is False and profiling.take() == []
    assert os.listdir(tmp_path / "prof") == [os.path.basename(path)]
    assert '"dp.outer_span"' in open(path).read()


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, "-m", "dposer_tpu_torch.train", "--dataset-folder",
                        str(tmp_path)], cwd=REPO, env=ENV, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and "no CUDA device" in p.stderr
