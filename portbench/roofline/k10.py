"""K10 ``dense_gn_silu_train``: a hidden layer of the training forward with
dropout, writing its bf16 stash, bf16 xhat and rstd for the backward."""
from ..peaks import bound_s as _bound

PATTERN = r"\bdense_gn_silu_train(_wgmma)?_kernel\b"


def layer_s(rows: int, k: int, hidden: int, residual: bool, stash_in: bool,
            write_out: bool) -> float:
    """A (the fp32 pose, or the bf16 stash of the layer before), bf16 W, the
    bf16 per-row projection, GroupNorm's rows; out: the fp32 output where it is
    read, the stash, xhat, rstd; the residual."""
    rest = (2 * k * hidden + 2 * rows * hidden + 2 * 4 * hidden
            + (4 * rows * hidden if write_out else 0) + 2 * 2 * rows * hidden
            + 4 * rows * 32 + (4 * rows * hidden if residual else 0))
    a_bytes = (2 if stash_in else 4) * rows * k
    return _bound(a_bytes + rest, 2 * rows * k * hidden, 40 * rows * hidden)


def step_s(rows: int, hidden: int, dim: int, n_blocks: int) -> float:
    """A step's forward: the pre layer writes its output (the residual
    stream); a block's first layer and the last layer write only the stash."""
    total = layer_s(rows, dim, hidden, False, False, True)
    for b in range(n_blocks):
        total += layer_s(rows, hidden, hidden, False, True, False)
        total += layer_s(rows, hidden, hidden, True, True, b < n_blocks - 1)
    return total


def bound_s(work: dict) -> float:
    return work["train_steps"] * step_s(work["rows"], work["hidden"], work["dim"],
                                        work["n_blocks"])
