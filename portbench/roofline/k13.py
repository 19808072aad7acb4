"""K13 ``dense_gn_silu_int8``: a hidden layer of the W8A8 forward; the layers
after the first read the int8 copy of their input that the layer before
wrote, and every layer but the last writes the next one's."""
from ..peaks import INT8_TC_OPS
from ..peaks import bound_s as _bound

PATTERN = r"\bdense_gn_silu_int8(_wgmma8)?_kernel\b"


def layer_s(rows: int, k: int, hidden: int, residual: bool, first: bool,
            writes_copy: bool) -> float:
    """The first layer reads fp32 A and its quantizer row; the others the
    int8 copy. int8 W, four fp32 rows (rescale, projection, GroupNorm), the
    fp32 output (and the residual's), and the int8 copy with its row."""
    a_bytes = 4 * rows * k + 4 * k if first else rows * k
    n_bytes = (a_bytes + k * hidden + 4 * 4 * hidden
               + 4 * rows * hidden * (2 if residual else 1)
               + (4 * hidden + rows * hidden if writes_copy else 0))
    return _bound(n_bytes, 2 * rows * k * hidden, 14 * rows * hidden, INT8_TC_OPS)


def forward_s(rows: int, hidden: int, dim: int, n_blocks: int) -> float:
    total = layer_s(rows, dim, hidden, False, True, True)
    for b in range(n_blocks):
        last = b == n_blocks - 1
        total += layer_s(rows, hidden, hidden, False, False, True)
        total += layer_s(rows, hidden, hidden, True, False, not last)
    return total


def bound_s(work: dict) -> float:
    return work["forwards"] * forward_s(work["rows"], work["hidden"], work["dim"],
                                        work["n_blocks"])
