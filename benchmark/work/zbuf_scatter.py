"""The least work of one call of the exact scatter-min z-buffer kernel
(``ops/zbuf_scatter.py`` -> ``csrc/zbuf_scatter_min.cu``): a frozen copy of
the port's ``ops/zbuf_scatter.work``, taking the call's shapes rather than
its tensors.  The kernel reads every point and writes every pixel, so the
count does not depend on the poses."""
from __future__ import annotations


def work(n: int, q: int, height: int, width: int) -> tuple[int, int]:
    """(bytes, operations) of a call over n envs of q points into height
    x width images: each point's pixel index and depth read (8 B), the
    image written once (4 B a pixel); a band test and a min a point and
    the fill of each pixel."""
    return 8 * n * q + 4 * n * height * width, 2 * n * q + n * height * width


def least_seconds(n: int, q: int, height: int, width: int,
                  peak_flops: float, peak_bytes: float) -> float:
    """The larger of the bytes over the peak bandwidth and the operations
    over the peak rate."""
    nbytes, ops = work(n, q, height, width)
    return max(nbytes / peak_bytes, ops / peak_flops)
