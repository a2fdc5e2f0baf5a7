"""The least work of the report's three nearest-neighbour passes (scan to
GT, GT to scan, GT to GT for the sampling floor: ``algo/evaluation.py``'s
``batched_accuracy``), counted from the point counts the benchmark's own
reference works out (``reference/accuracy.py``: each env's deduplicated
scan points and its GT points), so that it reads the same work whatever
implements the passes: the program's chunked elementwise passes or a
kernel that tiles them."""
from __future__ import annotations

# one pair: three subtractions, a multiply, two fused multiply-adds at two
# each, and the min
OPS_PER_PAIR = 8
POINT_BYTES, MIN_BYTES = 12, 4     # float32 xyz read, float32 min written


def pairs(counts) -> int:
    """The point pairs of the three passes over envs of (n_scan, n_gt)
    points: 2 n_scan n_gt + n_gt^2 an env."""
    return sum(2 * s * g + g * g for s, g in counts)


def work(counts) -> tuple[int, int]:
    """(bytes, operations) of the three passes: every point read once,
    every minimum written once (n_scan + 2 n_gt an env), and
    OPS_PER_PAIR operations a pair."""
    nbytes = sum(POINT_BYTES * (s + g) + MIN_BYTES * (s + 2 * g)
                 for s, g in counts)
    return nbytes, OPS_PER_PAIR * pairs(counts)


def least_seconds(counts, peak_flops: float, peak_bytes: float) -> float:
    """The larger of the bytes over the peak bandwidth and the operations
    over the peak rate."""
    nbytes, ops = work(counts)
    return max(nbytes / peak_bytes, ops / peak_flops)
