"""The work a stretch of PyTorch code does, counted as it runs: the
counterpart of XLA's cost analysis, which the JAX bench reads off a
compiled program (``bench.py``'s ``_cost``).

``WorkCounter`` is a ``TorchDispatchMode``.  It sees every aten op the
code dispatches, backward ops too, and counts

- the floating-point operations of matmuls and convolutions, by the
  formulas of ``torch.utils.flop_counter``'s registry (a dot of m x k by
  k x n is 2mnk, as XLA counts it).  The port computes them in float32
  with TF32 off (``ops/fp32.py``), so they are read against the float32
  peak; an op in any other type (a half type, or float32 on a card with
  TF32 on) raises rather than be read against the wrong peak;
- bytes as each op's input and output tensors, each read or written once
  (XLA's "bytes accessed" with no cache reuse); ops that move no data
  (views, ``empty``) count none.  A gather reads only the rows it
  gathers and a scatter touches only the rows it writes, so they count
  what XLA's cost analysis counts for a lone gather and scatter: twice
  the output and three times the updates, and the indices (fused into a
  loop, XLA counts a gather's whole table, the fusion's operand: the
  update's minibatch rows would then read the whole rollout, 1.13 GB at
  the flagship size, for every minibatch).

The port's hand-written CUDA kernels are launched through ``ctypes`` and
are invisible to dispatch, so each wrapper calls ``count_kernel`` with its
module's ``work(...) -> (bytes, ops)`` where it launches: the bytes the
kernel must move and its operations, which are counted with the
float32 operations (as ``chip_smoke.py`` phase 3 charges them in a
kernel's bound).  A CUDA graph's replays are invisible too: a caller
counts one step eagerly and scales it.

The bytes are a model, not a measurement of DRAM traffic: an op whose
inputs a previous op left in the 50 MB L2 reads them from there, so over
a program of many small ops the count can exceed what reached HBM.

Counting costs host time on every op, so a measurement counts in a pass
of its own, never inside a timed window.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# ops that allocate or alias without reading or writing data
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.detach,
               aten.lift_fresh, aten.alias}

# gathers (XLA: 2 x output + indices), by the argument holding the
# indices, and scatters (3 x updates + indices), by the arguments holding
# the indices and the updates (a scalar scatters one value an index)
_GATHERS = {aten.index: 1, aten.index_select: 2, aten.gather: 2,
            aten.take: 1, aten.embedding: 1}
_SCATTERS = {**dict.fromkeys((aten.index_put, aten.index_put_,
                              aten._index_put_impl_), (1, 2)),
             **dict.fromkeys((aten.scatter, aten.scatter_, aten.scatter_add,
                              aten.scatter_add_, aten.scatter_reduce,
                              aten.scatter_reduce_, aten.index_add,
                              aten.index_add_, aten.index_copy,
                              aten.index_copy_), (2, 3))}

def _tensor_bytes(tree) -> int:
    return sum(t.nbytes for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _moved(func, args, kwargs, out) -> int:
    """The bytes an op moves: its inputs and outputs, but for a gather or
    a scatter what XLA's cost analysis counts."""
    packet = func._overloadpacket
    if packet in _GATHERS:
        return 2 * _tensor_bytes(out) + _tensor_bytes(args[_GATHERS[packet]])
    if packet in _SCATTERS:
        at_index, at_updates = _SCATTERS[packet]
        index = args[at_index]
        updates = args[at_updates]
        if not isinstance(updates, torch.Tensor):
            updates = sum(t.numel() for t in tree_leaves(index)
                          if isinstance(t, torch.Tensor)) \
                * args[0].element_size()
        else:
            updates = updates.nbytes
        return 3 * updates + _tensor_bytes(index)
    return _tensor_bytes((args, kwargs)) + _tensor_bytes(out)


def _is_view(func) -> bool:
    """An op whose outputs alias its inputs without writing them."""
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None
                                 and not r.alias_info.is_write
                                 for r in returns)


def _check_float32(func, args) -> None:
    """Raises unless a matmul or convolution computes in float32 without
    TF32, the type whose peak its FLOPs are read against."""
    x = next(t for t in tree_leaves(args) if isinstance(t, torch.Tensor))
    tf32 = x.is_cuda and (
        torch.backends.cudnn.allow_tf32
        if "conv" in func._overloadpacket.__name__
        else torch.backends.cuda.matmul.allow_tf32)
    if x.dtype is not torch.float32 or tf32:
        raise ValueError(f"WorkCounter: {func} computes in "
                        f"{'tf32' if tf32 else x.dtype}; the count is read "
                        "against the float32 peak only")


class WorkCounter(TorchDispatchMode):
    """``with WorkCounter() as w: ...`` counts the enclosed code's work:
    ``w.flops`` (float32 operations) and ``w.bytes``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        formula = self._registry.get(packet)
        if formula is not None:
            _check_float32(func, args)
            self.flops += float(formula(*args, **kwargs, out_val=out))
        if packet not in _NO_TRAFFIC and not _is_view(func):
            self.bytes += _moved(func, args, kwargs, out)
        return out

    def add_kernel(self, work, args) -> None:
        """Adds a hand-written kernel's ``work(*args) -> (bytes, ops)``,
        computed outside the count."""
        with _disable_current_modes():
            nbytes, ops = work(*args)
        self.bytes += nbytes
        self.flops += ops


def count_kernel(work, *args) -> None:
    """Called by a kernel's wrapper where it launches: adds ``work(*args)``
    to every active ``WorkCounter``.  Costs one C call when none is."""
    if not torch._C._len_torch_dispatch_stack():
        return
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, WorkCounter):
            mode.add_kernel(work, args)


def counting() -> bool:
    """Whether a ``WorkCounter`` is active: a wrapper whose work it learns
    only from its kernel (a count kept on the device) asks for it then.
    Costs one C call when no mode is active."""
    return bool(torch._C._len_torch_dispatch_stack()) and any(
        isinstance(mode, WorkCounter)
        for mode in _get_current_dispatch_mode_stack())
