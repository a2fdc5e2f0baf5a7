"""The least work of one call of the splat z-buffer kernel: a frozen copy
of the port's ``ops/fused_splat.work`` (the formula ``chip_smoke.py``
phase 3 reads its bound from), taking the valid-point count the
benchmark works out itself rather than the call's tensors."""
from __future__ import annotations


def work(n: int, q: int, nvalid: int, height: int,
         width: int) -> tuple[int, int]:
    """(bytes, operations) of a call over n envs of q points, nvalid of
    them valid, into height x width images: the validity of every point,
    the pixel and depth of the valid ones, the slack, the z-buffer and
    the visibility written once; 19 operations per valid point (z range,
    digits, key, visibility compare) and 16 per pixel (9-key min,
    decode)."""
    return (n * q + 12 * nvalid + 4 * n + 4 * n * height * width + n * q,
            19 * nvalid + 16 * n * height * width)


def least_seconds(n: int, q: int, nvalid: int, height: int, width: int,
                  peak_flops: float, peak_bytes: float) -> float:
    """The larger of the bytes over the peak bandwidth and the operations
    over the peak rate."""
    nbytes, ops = work(n, q, nvalid, height, width)
    return max(nbytes / peak_bytes, ops / peak_flops)
