"""MultiCategorical action distribution over the 6-component pose action
(port of ``gennbv_tpu/models/distributions.py``).

SB3's MultiCategoricalDistribution (distributions.py:299): logits [N, 240]
split by NVEC = (81, 81, 51, 1, 13, 13); per-component log-probs and
entropies sum.  Pure functions over a logits tensor.
"""
from __future__ import annotations

import torch

from gennbv_tpu_torch import spec


def _components(logits: torch.Tensor):
    return torch.split(logits, spec.NVEC, dim=-1)


def sample(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """[N, 240] -> [N, 6] int32 action indices, drawn with `generator`
    (which must live on the logits' device)."""
    parts = [torch.multinomial(torch.softmax(comp, dim=-1), 1,
                               generator=generator)[:, 0]
             for comp in _components(logits)]
    return torch.stack(parts, dim=-1).to(torch.int32)


def mode(logits: torch.Tensor) -> torch.Tensor:
    parts = [comp.argmax(dim=-1) for comp in _components(logits)]
    return torch.stack(parts, dim=-1).to(torch.int32)


def log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """actions [..., 6] int -> summed log-prob [...]."""
    total = 0.0
    for i, comp in enumerate(_components(logits)):
        logp = torch.log_softmax(comp, dim=-1)
        total = total + logp.gather(-1, actions[..., i:i + 1].long())[..., 0]
    return total


def entropy(logits: torch.Tensor) -> torch.Tensor:
    total = 0.0
    for comp in _components(logits):
        logp = torch.log_softmax(comp, dim=-1)
        total = total - (logp.exp() * logp).sum(dim=-1)
    return total
