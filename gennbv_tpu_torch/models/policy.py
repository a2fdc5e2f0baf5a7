"""Actor-critic policy: HybridEncoder trunk + MultiCategorical and value
heads (port of ``gennbv_tpu/models/policy.py``).

Mirrors ActorCriticPolicy_Train_Eval (stable_baselines3/common/policies.py:
797-1100) with net_arch=[]: the 256-d encoder feature feeds a 240-logit
action head and a scalar value head directly.  Head weights are orthogonal
with SB3's gains (0.01 action, 1.0 value, policies.py:987-994) and zero
bias; the encoder keeps PyTorch's default init, as the reference's
features extractor does.  Every draw comes from the generator passed in,
so a seed fixes the whole initialisation.  The parameters live on the
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.config import ModelConfig
from gennbv_tpu_torch.models import distributions
from gennbv_tpu_torch.models.encoder import BatchNorm, HybridEncoder
from gennbv_tpu_torch.ops import fp32
from gennbv_tpu_torch.utils import profiling


class PolicyOutput(NamedTuple):
    logits: torch.Tensor   # [N, 240]
    value: torch.Tensor    # [N]


class ActorCriticPolicy(nn.Module):
    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        fp32.deterministic_fp32()
        self.encoder = HybridEncoder(cfg, device=device)
        self.action_net = nn.Linear(cfg.fused_dim, spec.NUM_LOGITS, device=device)
        self.value_net = nn.Linear(cfg.fused_dim, 1, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """PyTorch-default init of the encoder (kaiming-uniform weights,
        fan-in uniform biases) and orthogonal heads, drawn from
        `generator` (on the parameters' device)."""
        for m in self.encoder.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                         generator=generator)
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
        for head, gain in ((self.action_net, 0.01), (self.value_net, 1.0)):
            nn.init.orthogonal_(head.weight, gain, generator=generator)
            nn.init.zeros_(head.bias)

    def forward(self, obs: torch.Tensor) -> PolicyOutput:
        """The span ``policy/forward``, counted in ``policy/forwards``."""
        profiling.count("policy/forwards")
        with profiling.span("policy/forward"):
            feat = self.encoder(obs)
            return PolicyOutput(logits=self.action_net(feat),
                                value=self.value_net(feat)[..., 0])

    @torch.no_grad()
    def act(self, obs: torch.Tensor, generator: Optional[torch.Generator] = None,
            deterministic: bool = False, rows: Optional[slice] = None,
            width: Optional[int] = None):
        """Rollout-time forward (call in eval mode: BN running stats, like
        SB3's collect).  Returns (actions [N, 6] int32, values [N],
        log_probs [N]).  `rows` of `width`: the envs of `obs` are those
        rows of a batch of `width`, whose draws are made in full
        (``distributions.sample``)."""
        out = self(obs)
        if deterministic:
            actions = distributions.mode(out.logits)
        else:
            actions = distributions.sample(out.logits, generator, rows, width)
        return actions, out.value, distributions.log_prob(out.logits, actions)
