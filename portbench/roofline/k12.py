"""K12 ``dense_gn_silu_bwd``: a layer's backward hop ``dh_next @ W^T`` (plus
the residual stream's carried gradient), then dropout, SiLU and GroupNorm
backward, with dgamma and dbeta."""
from ..peaks import bound_s as _bound

PATTERN = r"\bdense_gn_silu_bwd_kernel\b"
HEAD_COLS = 64


def hop_s(rows: int, k: int, hidden: int, carried_in: bool, carried_out: bool) -> float:
    """bf16 dh_next and W^T, bf16 xhat, rstd, GroupNorm's rows; bf16 dh out,
    dgamma and dbeta; the fp32 carried gradient in and (or) out."""
    n_bytes = (2 * rows * k + 2 * k * hidden + 2 * rows * hidden + 4 * rows * 32
               + 2 * 4 * hidden + 2 * rows * hidden + 2 * 4 * hidden
               + (4 * rows * hidden if carried_in else 0)
               + (4 * rows * hidden if carried_out else 0))
    return _bound(n_bytes, 2 * rows * k * hidden, 40 * rows * hidden)


def step_s(rows: int, hidden: int, dim: int, n_blocks: int) -> float:
    """From the head's padded gradient back to the pre layer: the layers of
    even index carry the residual stream's gradient (in, out or both)."""
    n = 1 + 2 * n_blocks
    total = 0.0
    for j in reversed(range(n)):
        last = j == n - 1
        total += hop_s(rows, HEAD_COLS if last else hidden, hidden,
                       j % 2 == 0 and not last, j % 2 == 0 and j > 0)
    return total


def bound_s(work: dict) -> float:
    return work["train_steps"] * step_s(work["rows"], work["hidden"], work["dim"],
                                        work["n_blocks"])
