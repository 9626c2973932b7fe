"""The reference runs in one process: a world of one rank, so the port's
cross-rank paths (global batch statistics, the gradient all-reduce) never
run in it."""
from __future__ import annotations


def is_initialized() -> bool:
    return False


def world() -> int:
    return 1


def local_rows(n: int) -> slice:
    return slice(0, n)


def all_reduce_sum(x):
    raise RuntimeError("the reference runs in one process")


def all_reduce_mean(x):
    raise RuntimeError("the reference runs in one process")


def all_reduce_grads(params) -> None:
    """One rank: the gradients are already the batch's."""
