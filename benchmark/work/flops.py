"""Float32 FLOPs of a stretch of PyTorch code, counted as it runs: a frozen
copy of the FLOP half of the port's ``utils/work.py`` ``WorkCounter``.

Every aten op is seen by a ``TorchDispatchMode``; the matmuls and
convolutions are counted by the formulas of ``torch.utils.flop_counter``'s
registry (a dot of m x k by k x n is 2mnk), the backward ops too.  The
benchmark counts its own plain reference policy with it, never the
program, so the count is the algorithm's work whatever runs it.
"""
from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode


class FlopCounter(TorchDispatchMode):
    """``with FlopCounter() as c: ...`` leaves the enclosed code's matmul
    and convolution FLOPs in ``c.flops``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self._registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        return out
