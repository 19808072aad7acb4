"""K6 ``head_adam``: the bf16 output head fused with the one-step denoise,
the DPoser gradient and the Adam update (and the paste at a solve's last
step); before every later step it also writes that step's perturbation."""
from ..peaks import bound_s as _bound

PATTERN = r"\bhead_adam(_perturb)?_kernel\b"
HEAD_COLS = 64


def head_s(rows: int, hidden: int, dim: int, perturb: bool) -> float:
    """h in fp32, the padded bf16 head, and nine fp32 [rows, dim] arrays in or
    out (x, pert, obs, mask, m1, v, and x, m1, v written); with the next
    step's perturbation its output too."""
    n_bytes = (4 * rows * hidden + 2 * hidden * HEAD_COLS + 4 * HEAD_COLS + 9 * 4 * rows * dim
               + 32 + (4 * rows * dim if perturb else 0))
    return _bound(n_bytes, 2 * rows * hidden * dim, (133 if perturb else 20) * rows * dim)


def bound_s(work: dict) -> float:
    r, h, d = work["rows"], work["hidden"], work["dim"]
    return (work["adam_heads"] - work["perturbs"]) * head_s(r, h, d, False) \
        + work["perturbs"] * head_s(r, h, d, True)
