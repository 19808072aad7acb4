"""The training kernels' dropout hash, a frozen copy: element (row, col) of
layer ``layer`` is kept when the top 24 bits of a murmur-style hash of
(seed, layer, global row, col) fall below ``round(keep * 2^24)``; kept
elements are scaled by float32(1 / keep). Exact in int64 arithmetic."""
from __future__ import annotations

import torch

KEEP_BITS = 24
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_COL_MUL = 0x85EBCA6B


def _mul32(a, c: int):
    """``a * c mod 2^32`` for 32-bit ``a``: ``c`` in 16-bit halves."""
    return ((a * (c & 0xFFFF)) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def mask(seed: int, layer: int, rows: int, cols: int, keep: float, device=None,
         row_offset: int = 0) -> torch.Tensor:
    """float32 [rows, cols] of 0 and 1/keep."""
    threshold = min(1 << KEEP_BITS, int(round(keep * (1 << KEEP_BITS))))
    lkey = _fmix32((seed & _M32) ^ _fmix32((layer + _GOLDEN) & _M32))
    r = torch.arange(row_offset, row_offset + rows, dtype=torch.int64, device=device)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    u = _fmix32(_fmix32(lkey ^ _mul32(r, _GOLDEN))[:, None] ^ _mul32(c, _COL_MUL)[None, :])
    return ((u >> 8) < threshold).float() * torch.tensor(1.0 / keep, dtype=torch.float32)
