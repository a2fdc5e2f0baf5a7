"""Generic feature extractors (port of ``gennbv_tpu/models/torso.py``) --
SB3 torch_layers parity (stable_baselines3/common/torch_layers.py):

- :class:`NatureCNN` -- the Atari DQN conv stack (conv 32x8s4, 64x4s2,
  64x3s1 -> dense features_dim), for image observations [N, H, W, C].
- :class:`MlpTorso` -- configurable net_arch MLP (the MlpExtractor
  equivalent; net_arch=[] is the identity passthrough the GenNBV policy
  uses, policies.py:947).
- :class:`CnnPolicy` -- NatureCNN torso + MultiCategorical/value heads, so
  an image-observation task gets a ready actor-critic (SB3's CnnPolicy).

Images come in the JAX package's NHWC layout; the convolutions run on
NCHW and the features are flattened in NHWC order before ``fc``, as Flax
flattens them, so ``models/convert.py`` carries Flax weights over.  Layers
take Flax's initializers (lecun_normal kernels, zero biases, orthogonal
heads), drawn from the caller's generator.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gennbv_tpu_torch.models.actor_critic import _TRUNC_STD, _dense
from gennbv_tpu_torch.ops import fp32

# the NatureCNN's (kernel, stride) of each convolution
_CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


def _conv(in_ch: int, out_ch: int, k: int, stride: int, device,
          generator) -> nn.Conv2d:
    """flax.linen.Conv's init: lecun_normal over fan_in = in * k * k."""
    conv = nn.Conv2d(in_ch, out_ch, k, stride, device=device)
    std = math.sqrt(1.0 / (in_ch * k * k)) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        conv.bias.zero_()
    return conv


def _check_size(h: int, w: int) -> None:
    if h < 36 or w < 36:
        raise ValueError(f"NatureCNN needs images >= 36x36, got {h}x{w}"
                         " (same constraint as SB3's NatureCNN)")


class NatureCNN(nn.Module):
    """[N, H, W, C] images in [0, 1] -> [N, features_dim]."""

    def __init__(self, height: int, width: int, channels: int,
                 features_dim: int = 512,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        fp32.deterministic_fp32()
        _check_size(height, width)
        in_ch, h, w = channels, height, width
        for name, (out_ch, k, s) in zip(("c1", "c2", "c3"), _CONVS):
            setattr(self, name, _conv(in_ch, out_ch, k, s, device, generator))
            in_ch, h, w = out_ch, (h - k) // s + 1, (w - k) // s + 1
        self.fc = _dense(in_ch * h * w, features_dim, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_size(x.shape[1], x.shape[2])
        x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
        for conv in (self.c1, self.c2, self.c3):
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # Flax's order
        return F.relu(self.fc(x))


class MlpTorso(nn.Module):
    """net_arch MLP; empty net_arch = identity (MlpExtractor semantics)."""

    def __init__(self, in_dim: int, net_arch: Sequence[int] = (),
                 activation: Callable = torch.tanh,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.activation = activation
        self.names = [f"fc{i}" for i in range(len(net_arch))]
        for name, h in zip(self.names, net_arch):
            setattr(self, name, _dense(in_dim, h, device, generator))
            in_dim = h
        self.out_dim = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = self.activation(getattr(self, name)(x))
        return x


class CnnPolicyOutput(NamedTuple):
    logits: torch.Tensor
    value: torch.Tensor


class CnnPolicy(nn.Module):
    """NatureCNN torso + action/value heads for discrete image tasks."""

    def __init__(self, height: int, width: int, channels: int,
                 num_logits: int, features_dim: int = 512,
                 net_arch: Sequence[int] = (),
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.cnn = NatureCNN(height, width, channels, features_dim,
                             generator, device)
        self.torso = MlpTorso(features_dim, tuple(net_arch),
                              generator=generator, device=device)
        self.action_net = self._head(self.torso.out_dim, num_logits, 0.01,
                                     device, generator)
        self.value_net = self._head(self.torso.out_dim, 1, 1.0, device,
                                    generator)

    @staticmethod
    def _head(in_dim, out_dim, gain, device, generator) -> nn.Linear:
        layer = nn.Linear(in_dim, out_dim, device=device)
        with torch.no_grad():
            nn.init.orthogonal_(layer.weight, gain, generator=generator)
            layer.bias.zero_()
        return layer

    def forward(self, images: torch.Tensor) -> CnnPolicyOutput:
        feat = self.torso(self.cnn(images))
        return CnnPolicyOutput(logits=self.action_net(feat),
                               value=self.value_net(feat)[..., 0])
