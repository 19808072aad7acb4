"""K1 ``dense_gn_silu``: a hidden layer of the bf16 forward, ``bf16(A) @ W +
proj``, GroupNorm, SiLU and the block's residual; five a forward."""
from ..peaks import bound_s as _bound

PATTERN = r"\bdense_gn_silu(_wgmma)?_kernel\b"


def layer_s(rows: int, k: int, hidden: int, residual: bool) -> float:
    """One layer: fp32 A, bf16 W, the projection, GroupNorm's rows and the
    fp32 output (and the residual's) once."""
    n_bytes = (4 * rows * k + 2 * k * hidden + 3 * 4 * hidden
               + 4 * rows * hidden * (2 if residual else 1))
    return _bound(n_bytes, 2 * rows * k * hidden, 14 * rows * hidden)


def forward_s(rows: int, hidden: int, dim: int, n_blocks: int) -> float:
    return layer_s(rows, dim, hidden, False) + n_blocks * (
        layer_s(rows, hidden, hidden, False) + layer_s(rows, hidden, hidden, True))


def bound_s(work: dict) -> float:
    return work["forwards"] * forward_s(work["rows"], work["hidden"], work["dim"],
                                        work["n_blocks"])
