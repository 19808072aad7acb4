"""The port's microbenchmarks (``dposer_tpu_torch/benchmarks``) and their
kernel K14 ``chain_link`` against the TPU package's microbenchmark kernels.

The TPU kernels (``benchmarks/mxu_micro.py``, ``benchmarks/ilp_probe.py``)
run in interpret mode on the CPU: the test hands each module a
``pallas_call`` with ``interpret=True`` and cuts its sizes to B = 64, H = 128
and one or two steps; nothing in ``benchmarks/`` changes. K14's plain chain
(what its wrapper runs on CPU tensors) gets the same inputs. The state update
``x = 0.5*x + 1e-3*h`` hides the chain after a few steps, so the tests compare
``(x_N - 0.5^N x_0) * 1e3``, the chain's own contribution.
"""
import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dposer_tpu_torch.benchmarks import ilp_probe, mxu_micro
from dposer_tpu_torch.ops.cuda import chain_link as cl
from dposer_tpu_torch.ops.cuda.fused_em import launch_counts, reset_launch_counts
from dposer_tpu_torch.utils.benchtime import steady_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H = 64, 128


def _tpu_bench(name, monkeypatch, n_steps):
    """The TPU package's benchmark module ``name``, cut to B x H and
    ``n_steps``, its kernel run in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        f"tpu_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "B", B)
    monkeypatch.setattr(mod, "H", H)
    monkeypatch.setattr(mod, "N_STEPS", n_steps)
    pl = mod.pl
    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        BlockSpec=pl.BlockSpec, pallas_call=functools.partial(pl.pallas_call, interpret=True)))
    return mod


def _inputs(seed=0):
    """x0 [B, H], six bf16 weights whose chain keeps O(1) values at width H,
    and six int8 weights ([in, out]) that do the same under the 21 / 1/(21*127)
    requantization."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, H)).astype(np.float32)
    ws = [torch.from_numpy(rng.normal(size=(H, H)).astype(np.float32) / np.sqrt(H))
          .to(torch.bfloat16) for _ in range(6)]
    ws_i8 = [np.clip(np.rint(rng.normal(size=(H, H)) * 127 / np.sqrt(H)), -127, 127)
             .astype(np.int8) for _ in range(6)]
    return x0, ws, ws_i8


def _chain_part(x, x0, n_steps):
    return (np.asarray(x, np.float64) - 0.5 ** n_steps * x0) * 1e3


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("mode", ["bf16", "bf16-out", "int8"])
def test_mxu_chain_matches_tpu_kernel_interpret(monkeypatch, mode, n_steps):
    """The three rows of the matmul-chain benchmark, to the fp32 rounding of
    the update (1e-4 of the scale; measured 3-4e-6): int8 has the same integer
    sums and requantization, bf16 the same products summed in another order.
    Rounding each output to bf16 flips some roundings under that order: 1e-2
    (measured 2.0e-3)."""
    mod = _tpu_bench("mxu_micro", monkeypatch, n_steps)
    x0, ws, ws_i8 = _inputs()
    if mode == "int8":
        run = mod.build(jnp.int32, "int8")
        ref = run(jnp.asarray(x0), [jnp.asarray(w) for w in ws_i8])
        rows = cl.int8_rows(H, H, "cpu")
        out = cl.run_chain(torch.from_numpy(x0.copy()),
                           [torch.from_numpy(w).t().contiguous() for w in ws_i8], mode,
                           n_steps, **rows)
    else:
        run = mod.build(jnp.float32 if mode == "bf16" else jnp.bfloat16, "bf16")
        ref = run(jnp.asarray(x0), [jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
                                    for w in ws])
        out = cl.run_chain(torch.from_numpy(x0.copy()), ws, mode, n_steps)
    got, want = _chain_part(out.numpy(), x0, n_steps), _chain_part(ref, x0, n_steps)
    scale = float(np.abs(want).max())
    assert 0.1 < scale < 100  # the chain carries O(1) values
    # the update's fp32 rounding of 0.5*x (~1) leaves ~6e-8 / 1e-3 of h
    np.testing.assert_allclose(got, want, atol=(1e-2 if mode == "bf16-out" else 1e-4) * scale)


def _perm():
    """JAX feature p of the lane-strided GroupNorm (group p % 32) at the
    port's position GS*(p % 32) + p // 32 (groups of consecutive features)."""
    p = np.arange(H)
    return (H // 32) * (p % 32) + p // 32


@pytest.mark.parametrize("n_split", [1, 2, 4])
def test_ilp_chain_matches_tpu_kernel_interpret(monkeypatch, n_split):
    """The GN+SiLU chain on 1, 2 or 4 row chains. The TPU probe groups
    features lane-strided and takes a one-pass variance; the port groups
    consecutive features and takes two passes: the port's inputs are the TPU
    inputs permuted into its order, and bf16 roundings of the next link's
    input flip under either difference: 2e-2 of the scale (measured
    8.4e-3)."""
    mod = _tpu_bench("ilp_probe", monkeypatch, 1)
    x0, ws, _ = _inputs(seed=1)
    ref = np.asarray(mod.build(n_split)(
        jnp.asarray(x0), [jnp.asarray(w.float().numpy()).astype(jnp.bfloat16) for w in ws]))
    inv = np.argsort(_perm())  # port position -> JAX feature
    xp = torch.from_numpy(x0[:, inv].copy())
    wp = [w[inv][:, inv].contiguous() for w in ws]
    out = ilp_probe.run_split(xp, wp, n_split, 1).numpy()[:, _perm()]
    got, want = _chain_part(out, x0, 1), _chain_part(ref, x0, 1)
    scale = float(np.abs(want).max())
    assert 0.1 < scale < 100
    np.testing.assert_allclose(got, want, atol=2e-2 * scale)


def test_ilp_splits_are_bit_identical_on_the_plain_path():
    x0, ws, _ = _inputs(seed=2)
    outs = [ilp_probe.run_split(torch.from_numpy(x0.copy()), ws, n, 2) for n in (1, 2, 4)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError):
        ilp_probe.run_split(torch.from_numpy(x0.copy()), ws, 3, 1)


def test_benchmark_mains_on_the_cpu(monkeypatch, capsys):
    """Both entry points end to end at a cut size: every row and split, a
    positive time and a finite checksum, bit-identical splits."""
    for mod in (mxu_micro, ilp_probe):
        monkeypatch.setattr(mod, "B", B)
        monkeypatch.setattr(mod, "H", H)
    args = ["--device", "cpu", "--steps", "2", "--m-pipe", "2", "--rounds", "1"]
    rows = mxu_micro.main(args)
    assert [r["mode"] for r in rows] == ["bf16", "bf16-out", "int8"]
    assert all(r["ms"] > 0 and np.isfinite(r["checksum"]) and r["bound_ms"] > 0 for r in rows)
    splits = ilp_probe.main(args)
    assert [s["n_split"] for s in splits] == [1, 2, 4]
    assert [s["bitwise_equal_whole"] for s in splits] == [None, True, True]
    text = capsys.readouterr().out
    assert "us/matmul" in text and "us/step" in text and "bitwise == whole: True" in text


def test_steady_state_on_the_cpu():
    calls = []

    def launch(i):
        calls.append(i)
        return torch.ones(4) * i

    t = steady_state(launch, m_pipe=3, rounds=2)
    assert t > 0 and calls == list(range(6))


def test_chain_link_wrapper_on_cpu():
    """K14's wrapper on CPU tensors: the plain version, no launch; the update
    writes the state in place; malformed operands raise."""
    x0, ws, ws_i8 = _inputs(seed=3)
    a = torch.from_numpy(x0)
    reset_launch_counts()
    h = cl.chain_link(a, ws[0], "gn-silu")
    torch.testing.assert_close(h, cl.chain_link_plain(a, ws[0], "gn-silu"), rtol=0, atol=0)
    state = torch.ones(B, H)
    out = cl.chain_link(a, ws[0], "bf16", out=state, update=True)
    assert out is state
    torch.testing.assert_close(state, 0.5 + cl.chain_link_plain(a, ws[0], "bf16") * 1e-3,
                               rtol=0, atol=0)
    # bf16-out: fp32 sums rounded once to bf16
    ho = cl.chain_link(a, ws[0], "bf16-out")
    assert torch.equal(ho, ho.to(torch.bfloat16).float())
    wq = torch.from_numpy(ws_i8[0]).t().contiguous()
    hq = cl.chain_link(a, wq, "int8", **cl.int8_rows(H, H, "cpu"))
    aq = np.clip(np.rint(x0 * np.float32(21.0)), -127, 127).astype(np.int64)
    acc = (aq @ ws_i8[0].astype(np.int64)).astype(np.float32)
    np.testing.assert_array_equal(hq.numpy(), acc * np.float32(cl.INT8_SCALE))
    assert launch_counts()["chain_link"] == 0
    with pytest.raises(TypeError):
        cl.chain_link(a, ws[0].float(), "bf16")
    with pytest.raises(ValueError):
        cl.chain_link(a, ws[0], "bf16", update=True)
    with pytest.raises(ValueError):
        cl.chain_link(a, ws[0], "bf16", out=a, update=True)
    with pytest.raises(ValueError):
        cl.chain_link(a, ws[0], "fp8")
