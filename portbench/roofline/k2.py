"""K2 ``head_em``: the bf16 output head fused with the Euler-Maruyama
update and its in-kernel normals; one a reverse step."""
from ..peaks import bound_s as _bound

PATTERN = r"\bhead_em(_impute)?_kernel\b"
HEAD_COLS = 64  # the head's width as the kernels pad it


def head_s(rows: int, hidden: int, dim: int) -> float:
    """h in fp32, the padded bf16 head and its bias, x in and out once."""
    n_bytes = 4 * rows * hidden + 2 * hidden * HEAD_COLS + 4 * HEAD_COLS + 2 * 4 * rows * dim + 32
    return _bound(n_bytes, 2 * rows * hidden * dim, 110 * rows * dim)


def bound_s(work: dict) -> float:
    return work["em_heads"] * head_s(work["rows"], work["hidden"], work["dim"])
