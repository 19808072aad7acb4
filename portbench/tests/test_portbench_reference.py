"""The plain reference agrees with the port's plain path at a tiny size. This
test imports both; the reference itself imports nothing of the port."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import inputs, program
from portbench.reference import dropout, philox, scorefc, tasks
from portbench.reference import train as ref_train

MODEL = dict(name="ScoreModelFC", n_poses=21, pose_dim=3, hidden_dim=256, embed_dim=64,
             n_blocks=2, dropout=0.1, nonlinearity="swish", embedding_type="positional",
             scale_by_sigma=True, sigma_min=0.01, sigma_max=50.0, num_scales=1000)
SDE = dict(type="subvpsde", beta_min=0.1, beta_max=20.0, num_scales=16)
CONFIG = dict(model=MODEL, sde=SDE)


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    w = inputs.make_weights(MODEL, 3, "cpu")
    return w, program.build_model(CONFIG, w, "cpu").eval(), scorefc.ScoreFC(w, MODEL)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, portbench.reference.scorefc, portbench.reference.tasks, "
            "portbench.reference.train, portbench.reference.philox, portbench.reference.dropout;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'dposer_tpu', 'dposer_tpu_torch', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.strip()
    assert out == "[]"


def test_forward(pair):
    _, model, ref = pair
    x = torch.randn(5, 63)
    labels = torch.tensor([999.0, 500.0, 3.0, 0.999, 250.5])
    with torch.no_grad():
        want = model(x, labels)
    got = ref.forward(x, labels)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4 * float(want.abs().max()))


def test_philox_and_dropout_copies():
    from dposer_tpu_torch.ops.cuda import fused_train
    from dposer_tpu_torch.ops.cuda import philox as port_philox

    for seed in (0, 7, 2 ** 61 + 3):
        assert torch.equal(philox.normals_grid(seed, 17, 0, 9, 63),
                           port_philox.normals_grid(seed, 17, 0, 9, 63))
    for layer in range(5):
        assert torch.equal(dropout.mask(12345, layer, 33, 256, 0.9),
                           fused_train.dropout_mask(12345, layer, 33, 256, 0.9))


def test_em_step_and_tables():
    from dposer_tpu_torch.diffusion.fast_sampler import _em_tables

    sde = scorefc.SubVP(SDE)
    grid = sde.grid(1e-3)
    port = program.build_sde(CONFIG)
    assert torch.equal(grid, port.timesteps(1e-3))
    cx, cout, cnoise = _em_tables(port, grid)
    x, out, z = torch.randn(4, 63), torch.randn(4, 63), torch.randn(4, 63)
    for i in (0, 7, 15):
        x_new, x_mean, _ = sde.em_step(out, x, float(grid[i]), z)
        assert torch.allclose(x_mean, cx[i] * x + cout[i] * out, rtol=1e-5, atol=1e-5)
        assert torch.allclose(x_new, x_mean + cnoise[i] * z, rtol=1e-5, atol=1e-5)


def test_int8_emulation_and_calibration(pair):
    from dposer_tpu_torch.diffusion.fast_sampler import precompute_time_tables
    from dposer_tpu_torch.ops.cuda import quant

    w, model, ref = pair
    sde = scorefc.SubVP(SDE)
    g = torch.Generator().manual_seed(1)
    z, noise = torch.randn(8, 63, generator=g), torch.randn(16, 1, 8, 63, generator=g)
    amax = tasks.calibrate_per_channel(ref, sde, 1e-3, z, noise[:, 0])
    port_amax = quant.calibrate_act_amax_per_channel(program.build_sde(CONFIG), model, (8, 63),
                                                     z=z, noise=noise, device="cpu")
    for a, b in zip(amax, port_amax):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    grid = sde.grid(1e-3)
    labels = grid * 999
    tprojs, out_scale = precompute_time_tables(model, labels)
    fwd = quant.make_fast_forward_int8(model, tprojs, out_scale, port_amax)
    q = scorefc.ScoreFC(w, MODEL, scorefc.Quant.per_channel(w, amax, 2))
    x = 0.5 * torch.randn(6, 63)
    for i in (0, 8):
        want = fwd(x, i)
        got = q.forward(x, labels[i:i + 1])
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_completion_solve(pair):
    from dposer_tpu_torch.tasks.completion import DPoserComp

    w, model, ref = pair
    traffic = dict(lr=0.1, iterations=2, steps_per_iter=4, sample_trun=5.0)
    comp = DPoserComp(program.build_sde(dict(CONFIG, sde=dict(SDE, num_scales=1000))),
                      model=model, iterations=2, steps_per_iter=4, device="cpu")
    obs = torch.randn(3, 63)
    mask = torch.ones(3, 63)
    mask[:, :12] = 0.0
    noise = torch.randn(8, 3, 63)
    want = comp.optimize(obs, mask, noise=noise)
    sde = scorefc.SubVP(dict(SDE, num_scales=1000))
    got = tasks.complete(ref, sde, sde.grid(1e-3), obs, mask, 3 * 63, lambda i: noise[i],
                         traffic)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_train_step_loss_and_gradient(pair):
    from dposer_tpu_torch.ops.cuda.fused_train import get_cuda_train_loss_and_grad

    w, _, _ = pair
    model = program.build_model(CONFIG, w, "cpu", train=True)
    fn = get_cuda_train_loss_and_grad(program.build_sde(CONFIG), model, reduce_mean=True,
                                      eps=1e-5, compute_dtype=torch.float32)
    x0 = 0.5 * torch.randn(16, 63)
    t = torch.rand(16) * (1 - 1e-5) + 1e-5
    z = torch.randn(16, 63)
    loss, grads = fn(x0, t=t, z=z, dropout_seed=99)
    ref = ref_train.Trainer(w, MODEL, SDE, dict(grad_clip=1e9, lr=0.0, warmup=1, beta1=0.9,
                                                beta2=0.999, eps=1e-8, ema_rate=0.9999))
    got_loss = ref.step(x0, t, z, 99)
    assert abs(got_loss - float(loss)) <= 1e-5 * float(loss)
    for k, g in grads.items():
        assert torch.allclose(ref.clipped[0][k], g, rtol=1e-3, atol=1e-5 * float(g.abs().max())
                              + 1e-12), k
