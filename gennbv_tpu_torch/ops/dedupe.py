"""The report's 1 cm dedupe on the card: each env's episode scan rounded to
1 cm and deduplicated where the scan lies, as ``algo/evaluation.py``'s
``episode_accuracy`` takes it on a CUDA env.

``dedupe_cm(pts, valid, first_done)`` takes an episode's scans, pts
[T + 1, N, S, 3] float32 and valid [T + 1, N, S] bool (the init view
first), and each env's first done step first_done [N] int64.  A point
counts where it is valid and its view is the init view or a step up to
and including first_done (``evaluation.before_done_mask``'s rule).  It
returns ``Deduped``: each env's rows ``np.unique(np.round(points, 2),
axis=0)`` in np.unique's order, padded with zeros, and each env's count
and valid points on the host.  The rows equal np.unique's in value and in
order; only a row np.round leaves at -0.0 comes out +0.0.

On CUDA tensors a call is the key kernel of the hand-written
``csrc/dedupe_cm.cu`` (one int64 key a point: env, then x, y and z in
integer centimetres), PyTorch's sort of the keys, the emit kernel (each
run's first key decoded to its row, at its rank in its env), and one copy
of the counts to the host, the call's one wait.  A valid point that is not
finite or beyond the key's range raises, with no fallback.  Elsewhere the
plain version ``dedupe_cm_ref`` runs the same keys in PyTorch.  No TPU
kernel is ported here: the JAX package dedupes with np.unique on the host
(``gennbv_tpu/ops/chamfer.py``), as ``chamfer.dedupe_round_cm`` does.  The
call counts one in ``kernel/dedupe_cm/launches`` where it launches (N and
S above 0).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from gennbv_tpu_torch.ops import _cuda
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.work import count_kernel

# the key of a point that does not count: above every env's keys, since
# the env field never holds all ones (key_bits)
MASKED = torch.iinfo(torch.int64).max
# a valid point's rounding (a product and a rint an axis) and a row's
# decoding (a division an axis)
OPS_PER_POINT, OPS_PER_ROW = 6, 3


class Deduped(NamedTuple):
    """Each env's deduped scan rows, on the scans' device."""
    rows: torch.Tensor         # [N, P, 3] float32, zero past each count
    counts: np.ndarray         # [N] int64: each env's rows, on the host
    points_in: np.ndarray      # [N] int64: the valid points that counted


def key_bits(n: int) -> int:
    """The key's bits an axis for n envs: the env index takes n's bit
    length in the top bits (so its field never holds all ones and no key
    reaches MASKED), the three axes share the rest of 63 bits.  An axis
    holds integer centimetres in [-2^(b-1), 2^(b-1))."""
    return (63 - n.bit_length()) // 3


def work(points: int, points_in: int, rows: int) -> tuple[int, int]:
    """The least a call must do, for ``utils/work.WorkCounter``: bytes --
    every point's mask (1 B), each valid point that counts (12 B) read once,
    each row written once (12 B) -- and operations, OPS_PER_POINT a valid
    point and OPS_PER_ROW a row."""
    return (points + 12 * points_in + 12 * rows,
            OPS_PER_POINT * points_in + OPS_PER_ROW * rows)


def _checked(pts, valid, first_done, multiple):
    if pts.dtype is not torch.float32:
        raise TypeError(f"dedupe_cm: pts must be float32, got {pts.dtype}")
    if valid.dtype is not torch.bool:
        raise TypeError(f"dedupe_cm: valid must be bool, got {valid.dtype}")
    if first_done.dtype is not torch.int64:
        raise TypeError("dedupe_cm: first_done must be int64, got "
                        f"{first_done.dtype}")
    if (pts.dim() != 4 or pts.shape[-1] != 3 or pts.shape[0] < 1
            or valid.shape != pts.shape[:-1]
            or first_done.shape != pts.shape[1:2]):
        raise ValueError(f"dedupe_cm: pts {list(pts.shape)}, valid "
                         f"{list(valid.shape)} and first_done "
                         f"{list(first_done.shape)} do not fit [T + 1, N, S, "
                         "3], [T + 1, N, S] and [N] with T + 1 >= 1")
    if multiple < 1:
        raise ValueError(f"dedupe_cm: multiple must be at least 1, got "
                         f"{multiple}")
    tensors = (pts, valid, first_done)
    if any(t.device != pts.device for t in tensors):
        raise ValueError("dedupe_cm: the tensors lie on different devices: "
                         f"{[str(t.device) for t in tensors]}")


def _raise_bad(bad: np.ndarray, bits: int) -> None:
    if bad.any():
        raise ValueError(
            f"dedupe_cm: {int(bad.sum())} valid points are not finite or lie "
            f"beyond the key's +-{2 ** (bits - 1)} cm (envs "
            f"{np.flatnonzero(bad).tolist()[:8]} of {len(bad)})")


def _width(counts: np.ndarray, multiple: int) -> int:
    top = int(counts.max()) if len(counts) else 0
    return -(-top // multiple) * multiple


def dedupe_cm(pts: torch.Tensor, valid: torch.Tensor,
              first_done: torch.Tensor, multiple: int = 1) -> Deduped:
    """pts [T + 1, N, S, 3] float32, valid [T + 1, N, S] bool and
    first_done [N] int64 on one device -> ``Deduped``, its rows [N, P, 3]
    with P each env's largest count rounded up to `multiple`.  CUDA
    tensors go to the kernels, others to ``dedupe_cm_ref``."""
    _checked(pts, valid, first_done, multiple)
    if not pts.is_cuda:
        return dedupe_cm_ref(pts, valid, first_done, multiple)
    t1, n, s, _ = pts.shape
    device = pts.device
    if n * s == 0:
        zeros = np.zeros(n, np.int64)
        return Deduped(torch.zeros(n, 0, 3, device=device), zeros, zeros)
    bits = key_bits(n)
    cap = -(-t1 * s // multiple) * multiple
    keys = torch.empty(t1 * n * s, dtype=torch.int64, device=device)
    row_counts = torch.empty(2, t1 * n, dtype=torch.int32, device=device)
    info = torch.empty(3, n, dtype=torch.int32, device=device)
    index = pts.get_device()
    pts, first_done = pts.contiguous(), first_done.contiguous()
    valid = valid.contiguous().view(torch.uint8)
    err = _cuda.launch(index, _library().dedupe_cm_keys, pts.data_ptr(),
                       valid.data_ptr(), first_done.data_ptr(),
                       keys.data_ptr(), row_counts.data_ptr(), t1, n, s, bits)
    if err == 0:
        # keys alone: each row is decoded from its key
        ordered = torch.sort(keys).values
        # the rows' buffer is made once the sort's keys, indices and scratch
        # are freed, so that it does not add to the sort's memory peak
        del keys
        out = torch.empty(n, cap, 3, dtype=torch.float32, device=device)
        err = _cuda.launch(index, _library().dedupe_cm_emit,
                           ordered.data_ptr(), row_counts.data_ptr(),
                           out.data_ptr(), info.data_ptr(), t1, n, cap, bits)
    if err != 0:
        raise RuntimeError(f"dedupe_cm kernel launch failed: CUDA error {err}")
    profiling.count("kernel/dedupe_cm/launches")
    counts, points_in, bad = info.cpu().numpy().astype(np.int64)
    _raise_bad(bad, bits)
    count_kernel(work, t1 * n * s, int(points_in.sum()), int(counts.sum()))
    # the emit kernel leaves each env's slots past its count unwritten
    width = _width(counts, multiple)
    written = (torch.arange(width, device=device)[None, :, None]
               < info[0][:, None, None])
    rows = torch.where(written, out[:, :width], 0.0)
    return Deduped(rows, counts, points_in)


def dedupe_cm_ref(pts: torch.Tensor, valid: torch.Tensor,
                  first_done: torch.Tensor, multiple: int = 1) -> Deduped:
    """``dedupe_cm`` as plain PyTorch on any device, with the kernels'
    keys: the CPU's path through the wrapper, and the card tests'
    yardstick."""
    _checked(pts, valid, first_done, multiple)
    t1, n, s, _ = pts.shape
    device = pts.device
    bits = key_bits(n)
    half = 1 << (bits - 1)
    view = torch.arange(t1, device=device)[:, None]
    counts_view = (view == 0) | (view - 1 <= first_done[None, :])
    keep = valid & counts_view[:, :, None]
    # np.round(x, 2)'s product and rint, in float32
    r = torch.round(pts * 100.0)
    in_range = ((r >= -half) & (r < half)).all(-1)
    _raise_bad((keep & ~in_range).sum((0, 2)).cpu().numpy(), bits)
    keyed = keep & in_range
    axes = torch.where(keyed[..., None], r, 0.0).long() + half
    env = torch.arange(n, device=device)[None, :, None]
    key = ((env << 3 * bits) | (axes[..., 0] << 2 * bits)
           | (axes[..., 1] << bits) | axes[..., 2])
    ordered = torch.sort(torch.where(keyed, key, MASKED).flatten()).values
    before = torch.cat([ordered.new_full((1,), -1), ordered])[:-1]
    firsts = ordered[(ordered != before) & (ordered != MASKED)]
    env_of = firsts >> 3 * bits
    counts = torch.bincount(env_of, minlength=n)
    rank = (torch.arange(len(firsts), device=device)
            - (torch.cumsum(counts, 0) - counts)[env_of])
    field = (1 << bits) - 1
    cm = torch.stack([(firsts >> 2 * bits) & field, (firsts >> bits) & field,
                      firsts & field], -1) - half
    # np.round's division: by a tensor, rounded to nearest (PyTorch divides
    # a CUDA tensor by a Python float as a product with its reciprocal)
    cm = cm.float()
    values = torch.div(cm, torch.full_like(cm, 100.0))
    counts_host = counts.cpu().numpy().astype(np.int64)
    rows = torch.zeros(n, _width(counts_host, multiple), 3, device=device)
    rows[env_of, rank] = values
    return Deduped(rows, counts_host,
                   keep.sum((0, 2)).cpu().numpy().astype(np.int64))


@functools.cache
def _library():
    lib = _cuda.load_library("dedupe_cm")
    lib.dedupe_cm_keys.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.dedupe_cm_keys.restype = ctypes.c_int
    lib.dedupe_cm_emit.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.dedupe_cm_emit.restype = ctypes.c_int
    return lib
