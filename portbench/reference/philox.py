"""Philox-4x32-10 normals, a frozen copy of the stream the program's kernels
draw in-kernel (``philox_normal(seed, step, slab, row, col)``: one Philox
call an element, Box-Muller's cos branch).

The reference draws the same normals as the program from the same seed, so a
step can be compared element by element. Every 32-bit word is carried in an
int64 holding a value in [0, 2**32). Box-Muller runs in float64 and rounds
once to float32. A seed is an int or a one-element int64 tensor holding its
64 bits.
"""
from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox-4x32 round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit halves of ``m * c`` for 32-bit ``m`` and words ``c``,
    without leaving int64: ``c`` is split into 16-bit halves."""
    p_lo = m * (c & 0xFFFF)  # < 2**48
    p_hi = m * (c >> 16)
    t = ((p_hi & 0xFFFF) << 16) + p_lo  # < 2**49
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox4x32_10(ctr, key):
    """Philox-4x32-10 on counters ``ctr`` (four int64 tensors of 32-bit
    words, broadcastable) and ``key`` (two words: ints or tensors); returns
    the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def seed_bits(seed) -> int:
    """The 64 bits of ``seed`` (an int, or a one-element int64 tensor, whose
    negative values are the seeds at and above 2**63) as an int."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError(f"a seed tensor holds one int64; got {seed.dtype} "
                             f"{tuple(seed.shape)}")
        seed = int(seed.reshape(()).item())
    return int(seed) & (2 ** 64 - 1)


def _counter(seed, step: int, slab: int, row, col):
    seed = seed_bits(seed)
    row = torch.as_tensor(row, dtype=torch.int64)
    col = torch.as_tensor(col, dtype=torch.int64)
    row, col = torch.broadcast_tensors(row, col)
    ctr = (col & _MASK, row & _MASK, torch.full_like(row, step & _MASK),
           torch.full_like(row, slab & _MASK))
    return ctr, (seed & _MASK, (seed >> 32) & _MASK)


def _radius(word):
    u = ((word >> 8) + 1).double() * 2.0 ** -24  # (0, 1]
    return torch.sqrt(-2.0 * torch.log(u))


def _angle(word):
    return 2.0 * math.pi * ((word >> 8).double() * 2.0 ** -24)  # 2*pi*[0, 1)


def philox_normal_plain(seed, step: int, slab: int, row, col) -> torch.Tensor:
    """``philox_normal``: the standard normal of element (row, col) of noise
    slab ``slab`` at sampler step ``step`` (one Philox call an element,
    Box-Muller's cos branch); ``row`` and ``col`` broadcast. float32."""
    ctr, key = _counter(seed, step, slab, row, col)
    r = philox4x32_10(ctr, key)
    return (_radius(r[0]) * torch.cos(_angle(r[1]))).float()


def philox_normal4_plain(seed, step: int, slab: int, row, col0) -> torch.Tensor:
    """``philox_normal4``: the four normals of elements (row, col0 ..
    col0 + 3) (``col0`` a multiple of 4) from one Philox call keyed by
    column group ``col0 // 4``; float32 with a trailing axis of 4."""
    col0 = torch.as_tensor(col0, dtype=torch.int64)
    ctr, key = _counter(seed, step, slab, row, col0 // 4)
    r = philox4x32_10(ctr, key)
    ra, rb = _radius(r[0]), _radius(r[2])
    a, b = _angle(r[1]), _angle(r[3])
    return torch.stack([ra * torch.cos(a), ra * torch.sin(a), rb * torch.cos(b),
                        rb * torch.sin(b)], dim=-1).float()


def normals_grid(seed, step: int, slab: int, rows: int, cols: int,
                 per_group: bool = False, device=None) -> torch.Tensor:
    """The [rows, cols] normals a kernel draws for one (step, slab):
    ``philox_normal`` per element (K2, K4), or with ``per_group`` the
    ``philox_normal4`` groups of four columns (K3)."""
    r = torch.arange(rows, device=device).unsqueeze(1)
    if not per_group:
        return philox_normal_plain(seed, step, slab, r, torch.arange(cols, device=device))
    groups = (cols + 3) // 4
    z4 = philox_normal4_plain(seed, step, slab, r, 4 * torch.arange(groups, device=device))
    return z4.reshape(rows, 4 * groups)[:, :cols]
