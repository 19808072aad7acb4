"""K1's pre route alone (``pre::dense_gn_silu_kernel``): the first hidden
layer of the bf16 forward on the fp32 state, ``bf16(x) @ W0 + proj``,
GroupNorm and SiLU, writing the fp32 output and its bf16 copy; one a
forward. At a pose of 65-128 dims (rot6d's 126) it runs over two 64-deep
K-tiles."""
from ..peaks import bound_s as _bound

PATTERN = r"\bdense_gn_silu_kernel\b"


def layer_s(rows: int, k: int, hidden: int) -> float:
    """fp32 A read once, bf16 W0, the projection and GroupNorm's rows; the
    fp32 output and its bf16 copy written once."""
    n_bytes = 4 * rows * k + 2 * k * hidden + 3 * 4 * hidden + (4 + 2) * rows * hidden
    return _bound(n_bytes, 2 * rows * k * hidden, 14 * rows * hidden)


def bound_s(work: dict) -> float:
    return work["forwards"] * layer_s(work["rows"], work["dim"], work["hidden"])
