"""The plain Philox stream of the port's kernels (``ops/cuda/philox.py``).

K2, K3 and K4 draw their normals in-kernel from Philox-4x32-10
(``csrc/common.cuh``); the plain versions here are what the card tests and
``chip_smoke.py`` hold those draws to, element by element. On the CPU:

    python -m pytest tests/test_torch_philox.py -q
"""
import math

import numpy as np
import pytest
import torch

from dposer_tpu_torch.ops.cuda import philox

MASK = 0xFFFFFFFF


def _philox_ints(ctr, key):
    """Philox-4x32-10 on Python integers: full products, no splitting."""
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & MASK, (p0 >> 32) ^ c[3] ^ k[1], p0 & MASK]
        k = [(k[0] + 0x9E3779B9) & MASK, (k[1] + 0xBB67AE85) & MASK]
    return c


# Random123's known-answer vectors for philox4x32_10: counter, key, output
@pytest.mark.parametrize("ctr, key, want", [
    ([0, 0, 0, 0], [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([MASK] * 4, [MASK] * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344], [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
])
def test_philox_known_answers(ctr, key, want):
    out = philox.philox4x32_10([torch.tensor([c]) for c in ctr], key)
    assert [int(o) for o in out] == want
    assert _philox_ints(ctr, key) == want


@pytest.mark.parametrize("seed", [0, 20240917, 2 ** 40 + 12345])
def test_philox_on_tensors_matches_integers(seed):
    """The int64 tensor version (products split into 16-bit halves) against
    full-width integer products, on random counters across the 32-bit range."""
    rng = np.random.default_rng(seed % 2 ** 32)
    ctr = rng.integers(0, 2 ** 32, size=(4, 64), dtype=np.int64)
    key = (seed & MASK, (seed >> 32) & MASK)
    out = philox.philox4x32_10([torch.from_numpy(c) for c in ctr], key)
    got = torch.stack(out, 1).tolist()
    assert got == [_philox_ints(ctr[:, j].tolist(), key) for j in range(ctr.shape[1])]


@pytest.mark.parametrize("per_group", [False, True])
def test_normals_from_words(per_group):
    """Box-Muller on the words as ``common.cuh`` takes them: u1 = (w >> 8)
    + 1 over 2**24 for the radius, (w >> 8) over 2**24 for the angle, the
    counter (column or column / 4, row, step, slab) and the key (seed's low,
    high words)."""
    seed, step, slab = 2 ** 33 + 99, 7, 3
    key = (seed & MASK, seed >> 32)
    for row, col in ((0, 0), (5, 8), (499, 60)):
        ctr = [col // 4 if per_group else col, row, step, slab]
        w = _philox_ints(ctr, key)
        rad = [math.sqrt(-2 * math.log(((w[i] >> 8) + 1) / 2 ** 24)) for i in (0, 2)]
        ang = [2 * math.pi * (w[i] >> 8) / 2 ** 24 for i in (1, 3)]
        if per_group:
            want = [rad[0] * math.cos(ang[0]), rad[0] * math.sin(ang[0]),
                    rad[1] * math.cos(ang[1]), rad[1] * math.sin(ang[1])]
            got = philox.philox_normal4_plain(seed, step, slab, row, col).tolist()
        else:
            want = [rad[0] * math.cos(ang[0])]
            got = [float(philox.philox_normal_plain(seed, step, slab, row, col))]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("per_group", [False, True])
def test_normals_are_standard(per_group):
    """10^5 draws of one (step, slab) have mean 0 and std 1 within 0.01."""
    z = philox.normals_grid(1234, 5, 1, 2000, 63, per_group=per_group)
    assert z.shape == (2000, 63) and z.dtype == torch.float32
    assert z.numel() >= 1e5
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01


def test_streams_differ_by_step_slab_and_seed():
    base = philox.normals_grid(1, 0, 0, 16, 63)
    for other in (philox.normals_grid(1, 1, 0, 16, 63), philox.normals_grid(1, 0, 1, 16, 63),
                  philox.normals_grid(2, 0, 0, 16, 63)):
        assert float((other - base).abs().min()) > 0
    # the grouped draw: column groups of four share one call, groups differ
    z4 = philox.normals_grid(1, 0, 0, 4, 64, per_group=True).reshape(4, 16, 4)
    assert float((z4[:, 1:] - z4[:, :-1]).abs().min()) > 0
