"""Wire accounting of the compressed all-reduce, and the collectives to come.

Counterpart of ``repro.dist.collectives``.  The paper's system pitch: at
data-parallel scale a dense gradient all-reduce moves ``m*n`` floats per
layer per step, while the rank-r compressed path moves only the two factors,
``r*(m+n)`` floats (``factor_wire_bytes``).  ``dist.merge`` records these
numbers in its ``merge_level`` spans and counters.

The collectives themselves (``pmean_factor``, ``psum_factor``,
``all_gather_tsvd``) need a process group across cards and are refused by
name until the mesh tier is ported (ROADMAP A7).
"""

from __future__ import annotations

__all__ = [
    "all_gather_tsvd",
    "factor_wire_bytes",
    "pmean_factor",
    "psum_factor",
]


def _not_ported(name: str):
    raise NotImplementedError(f"{name} needs the mesh tier, which is not ported yet (ROADMAP A7)")


def pmean_factor(x, axis_name):
    """Mean-reduce one compression factor across the data-parallel axis
    (not ported: ROADMAP A7)."""
    _not_ported("pmean_factor")


def psum_factor(x, axis_name):
    """Sum-reduce one factor across the data-parallel axis (not ported:
    ROADMAP A7)."""
    _not_ported("psum_factor")


def all_gather_tsvd(tsvd, axis_name):
    """Gather per-worker truncated-SVD factors (not ported: ROADMAP A7)."""
    _not_ported("all_gather_tsvd")


def factor_wire_bytes(m: int, n: int, rank: int, *, n_workers: int = 1,
                      itemsize: int = 4) -> dict:
    """Per-layer wire accounting: dense all-reduce vs the compressed factor
    exchange (two pmean rounds) vs a full factor all-gather.

    >>> factor_wire_bytes(8, 8, 2, n_workers=2)["factor_allgather"]
    272
    """
    dense = m * n * itemsize
    compressed = rank * (m + n) * itemsize
    gather = n_workers * rank * (m + n + 1) * itemsize
    return {
        "dense_allreduce": dense,
        "compressed_allreduce": compressed,
        "factor_allgather": gather,
        "ratio": dense / compressed,
    }
