"""Kernel B's work at a shape: one Brand-truncated rank-1 update of a rank-r
SVD of an (m, n) matrix.

Operations (multiply and add counted apart):
* the Brand projections p = U^T a, q = V^T b: 2 (m + n) r;
* the residuals a - U p, b - V q and their norms: 2 (m + n) r + 2 (m + n);
* the core, the (r + 1) x (r + 1) problem: an SVD of it, counted as a dense
  one, 22 k^3 for k = r + 1 (the kernel solves it by the secular equation,
  which needs fewer);
* the rotations [U P] G_u[:, :r] and [V Q] G_v[:, :r]: 2 (m + n) (r + 1) r.

Bytes: every byte of the state (U, s, V) read once and written once, and the
pair (a, b) read once, whatever the kernel reads again.
"""


def ops(m: int, n: int, r: int) -> float:
    k = r + 1
    return (2.0 * (m + n) * r + 2.0 * (m + n) * r + 2.0 * (m + n) + 22.0 * k ** 3
            + 2.0 * (m + n) * k * r)


def bytes_moved(m: int, n: int, r: int, itemsize: int) -> float:
    state = m * r + r + n * r
    return float((2 * state + m + n) * itemsize)


def least_seconds(m: int, n: int, r: int, itemsize: int, peak_flops: float,
                  peak_bytes_per_s: float) -> tuple[float, str]:
    """The least time one update could take on the card, and which bound
    sets it ("bytes" or "ops")."""
    t_ops = ops(m, n, r) / peak_flops
    t_bytes = bytes_moved(m, n, r, itemsize) / peak_bytes_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
