"""Random state an env carries in its state tuple.

The JAX envs carry PRNG keys in their state, so a step is a pure function
of (state, actions).  Here the state carries a ``torch.Generator``'s state
tensor (``Generator.get_state()``, a host uint8 tensor), and the step
rebuilds the generator from it: the same (state, actions) draws the same
numbers, and a step never advances a generator its caller holds.
"""
from __future__ import annotations

import torch


def fork(generator: torch.Generator) -> torch.Tensor:
    """The state of a new generator on `generator`'s device, seeded from
    one draw of `generator` (a host sync on a CUDA generator)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    child = torch.Generator(device=generator.device)
    child.manual_seed(seed)
    return child.get_state()


def restore(state: torch.Tensor, device: torch.device | str) -> torch.Generator:
    """A generator on `device` in the state `state` (``fork`` or a
    generator's ``get_state()``)."""
    g = torch.Generator(device=device)
    g.set_state(state)
    return g
