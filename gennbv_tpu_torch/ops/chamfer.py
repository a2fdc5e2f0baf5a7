"""Chamfer distance (port of ``gennbv_tpu/ops/chamfer.py``; the reference
uses PyTorch3D's).

The reference computes reconstruction accuracy as
``chamfer_distance(unique(round(pts, 2)), pc_gt) * 100`` at episode end
(env_eval_gennbv.py:252-264); PyTorch3D's chamfer_distance returns the
*sum* of the two mean squared nearest-neighbour distances.

Brute force.  The squared distance is written out term by term and
rounded as XLA's CPU compiler rounds ``sum((a - b) ** 2)`` in the jitted
JAX function (a chain of fused multiply-adds, ``ops/fp32.py``), so the
per-point minima equal the reference's on the CPU and are the same on the
card.  Every function takes optional leading batch axes (envs).  On CUDA
tensors ``_row_mins`` launches the hand-written kernel of
``ops/nn_min.py`` (one launch a call, bit-equal to the loop; it raises on
what the kernel does not take, with no fallback); on the CPU it runs the
plain loop, chunked over the query rows only, so each query's min runs
over the whole target set and is exact whatever the chunk.

The counter ``accuracy/nn_pairs`` (``utils/profiling.py``, a host
integer) sums the point pairs whose squared distance is computed: on the
CPU, query rows times target columns of every chunk, batch and padding
included; on the card ``algo/evaluation.py``'s ``batched_accuracy``
counts the kernel's from its host masks (``nn_min.pairs``).
"""
from __future__ import annotations

import numpy as np
import torch

from gennbv_tpu_torch.ops import fp32, nn_min
from gennbv_tpu_torch.utils import profiling

_BIG = 1e10


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., C, 3], b [..., Q, 3] -> [..., C, Q] squared distances:
    d0*d0, then d1*d1 and d2*d2 added by fused multiply-adds."""
    acc = None
    for k in range(3):
        d = a[..., :, None, k] - b[..., None, :, k]
        acc = d * d if acc is None else fp32.fma(d, d, acc)
    return acc


def _extent(mask: torch.Tensor) -> int:
    """The length of the point axis's prefix that holds every valid point
    of mask [..., P] (the rest is padding, which the masks skip anyway)."""
    valid = torch.nonzero(mask.reshape(-1, mask.shape[-1]).any(0))
    return int(valid[-1]) + 1 if len(valid) else 0


def _row_mins(a, a_mask, b, b_mask, chunk: int, exclude_self: bool = False):
    """[..., P]: min over the valid b of each valid a row's squared
    distance (1e10 where a is masked out or no b is valid); with
    exclude_self, row i skips b's row i.  Rows and targets past the last
    valid point are never computed.  CUDA tensors go to the kernel
    (``nn_min.nn_min``, which takes one leading shape for a and b and no
    chunk); others to the plain loop ``_row_mins_ref``."""
    if a.is_cuda:
        return nn_min.nn_min(a, a_mask, b, b_mask, exclude_self)
    return _row_mins_ref(a, a_mask, b, b_mask, chunk, exclude_self)


def _row_mins_ref(a, a_mask, b, b_mask, chunk: int,
                  exclude_self: bool = False):
    """``_row_mins`` as the plain loop, on any device: `chunk` query rows a
    step, each a [..., chunk, Q] tile of ``_sq_dists``, masked and reduced
    by PyTorch's elementwise ops (the CPU's path, and the card tests'
    yardstick for the kernel)."""
    out = torch.full(a.shape[:-1], _BIG, dtype=a.dtype, device=a.device)
    kb = _extent(b_mask)
    if kb == 0:
        return out
    b, b_mask = b[..., :kb, :], b_mask[..., :kb]
    for i0 in range(0, _extent(a_mask), chunk):
        d = _sq_dists(a[..., i0:i0 + chunk, :], b)
        profiling.count("accuracy/nn_pairs", d.numel())
        d = torch.where(b_mask[..., None, :], d, _BIG)
        if exclude_self:
            rows = torch.arange(i0, i0 + d.shape[-2], device=a.device)
            self_oh = rows[:, None] == torch.arange(kb, device=a.device)[None]
            d = torch.where(self_oh, _BIG, d)
        out[..., i0:i0 + d.shape[-2]] = d.amin(-1)
    return torch.where(a_mask, out, _BIG)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    w = mask.to(x.dtype)
    return (x * w).sum(-1) / torch.clamp_min(w.sum(-1), 1.0)


def nn_sq_dists(pts_a, mask_a, pts_b, mask_b, chunk: int = 1024):
    """Per-point min_b d^2 for every a (1e10 where a is masked out):
    pts_a [..., P, 3], mask_a [..., P], pts_b [..., Q, 3], mask_b [..., Q]
    -> [..., P]."""
    return _row_mins(pts_a, mask_a, pts_b, mask_b, chunk)


def chamfer_directed(pts_a, mask_a, pts_b, mask_b, chunk: int = 1024):
    """The two directed terms of chamfer_distance, separately:
    (mean_a min_b d^2, mean_b min_a d^2).  a->b is bounded below by b's
    sampling density; b->a also pays for the parts of b that a never
    observed."""
    return (_masked_mean(_row_mins(pts_a, mask_a, pts_b, mask_b, chunk),
                         mask_a),
            _masked_mean(_row_mins(pts_b, mask_b, pts_a, mask_a, chunk),
                         mask_b))


def chamfer_distance(pts_a, mask_a, pts_b, mask_b, chunk: int = 1024):
    """Symmetric chamfer: mean_a min_b d^2 + mean_b min_a d^2 (PyTorch3D's
    convention with point_reduction='mean', batch sum)."""
    a2b, b2a = chamfer_directed(pts_a, mask_a, pts_b, mask_b, chunk)
    return a2b + b2a


def self_nn_sq_dists(pts, mask, chunk: int = 1024):
    """Per-point squared distance to the nearest OTHER valid point
    (1e10 where the point is masked out): pts [..., P, 3], mask [..., P]
    -> [..., P]."""
    return _row_mins(pts, mask, pts, mask, chunk, exclude_self=True)


def sampling_floor(pts, mask, chunk: int = 1024):
    """Resolution floor of a point sampling: the mean squared distance of
    each point to its nearest OTHER point.  A query point exactly on the
    sampled surface still measures ~ this/4 to its nearest sample, so a
    directed chamfer term toward this set cannot fall below ~floor/4."""
    return _masked_mean(self_nn_sq_dists(pts, mask, chunk), mask)


def dedupe_round_cm(points: np.ndarray) -> np.ndarray:
    """Host-side unique(round(pts, 2 decimals)): the reference's 1 cm
    dedup before the chamfer (env_eval_gennbv.py:256-259)."""
    return np.unique(np.round(points, 2), axis=0)
