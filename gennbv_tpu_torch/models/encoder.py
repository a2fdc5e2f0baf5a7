"""Hybrid multi-source state encoder (port of ``gennbv_tpu/models/encoder.py``).

gennbv/network/hybrid_encoder.py:11-91:
- pose branch: obs[:, :600] -> (N, 100, 6) -> sinusoidal positional
  encoding (bands [1, 2], sin ++ cos) -> (N, 2400) -> MLP 2400 -> 256 -> 256;
- grid branch: obs[:, 600:8600] -> (N, 1, 20, 20, 20) -> [Conv3d(16, k3, s2)
  + BatchNorm3d + ReLU] x2 -> flatten 1024 -> Linear 256 + ReLU;
- fusion: concat(512) -> Linear 256 + ReLU.
The state_rgb slice (obs[:, 8600:]) is never read (hybrid_encoder.py:83).

The JAX module runs channels-last and flattens the conv output in
(D, H, W, C) order; this one runs PyTorch's channels-first convolutions and
permutes to channels-last before ``grid_fc``, so converted weights line up.
"""
from __future__ import annotations

import torch
from torch import nn

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.config import ModelConfig


def positional_encoding(positions: torch.Tensor, freqs: int = 2) -> torch.Tensor:
    """[..., D] -> [..., 2 * freqs * D]: sin/cos of positions * 2^k
    (hybrid_encoder.py:56-67; band-major per element, then sin ++ cos)."""
    bands = 2.0 ** torch.arange(freqs, dtype=positions.dtype,
                                device=positions.device)
    scaled = (positions[..., None] * bands).reshape(
        *positions.shape[:-1], freqs * positions.shape[-1])
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


class HybridEncoder(nn.Module):
    """obs [N, >= 8600] -> feature [N, fused_dim].  BatchNorm momentum 0.1
    (Flax's 0.9) and eps 1e-5; the rollout runs it in eval mode."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c, hid = cfg.grid_channels, cfg.pose_mlp_hidden
        pose_in = spec.POSE_BUF_LEN * spec.ACTION_DIM * 2 * cfg.posenc_freqs
        self.pose_fc1 = nn.Linear(pose_in, hid, device=device)
        self.pose_fc2 = nn.Linear(hid, hid, device=device)
        self.grid_conv1 = nn.Conv3d(1, c, 3, stride=2, device=device)
        self.grid_bn1 = nn.BatchNorm3d(c, eps=1e-5, momentum=0.1, device=device)
        self.grid_conv2 = nn.Conv3d(c, c, 3, stride=2, device=device)
        self.grid_bn2 = nn.BatchNorm3d(c, eps=1e-5, momentum=0.1, device=device)
        g = spec.GRID_SIZE
        for _ in range(2):
            g = (g - 3) // 2 + 1                           # 20 -> 9 -> 4
        self.grid_fc = nn.Linear(c * g ** 3, cfg.fused_dim, device=device)
        self.fuse_fc = nn.Linear(hid + cfg.fused_dim, cfg.fused_dim,
                                 device=device)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        n = obs.shape[0]
        pose = obs[:, : spec.STATE_DIM].reshape(n, -1, spec.ACTION_DIM)
        pose = positional_encoding(pose, self.cfg.posenc_freqs).reshape(n, -1)
        h_pose = torch.relu(self.pose_fc1(pose))
        h_pose = torch.relu(self.pose_fc2(h_pose))

        g = spec.GRID_SIZE
        grid = obs[:, spec.STATE_DIM: spec.STATE_DIM + spec.GRID_DIM]
        grid = grid.reshape(n, 1, g, g, g)
        grid = torch.relu(self.grid_bn1(self.grid_conv1(grid)))
        grid = torch.relu(self.grid_bn2(self.grid_conv2(grid)))
        # channels-last flatten, as the JAX encoder (encoder.py:78)
        h_grid = grid.permute(0, 2, 3, 4, 1).reshape(n, -1)
        h_grid = torch.relu(self.grid_fc(h_grid))

        fused = torch.cat([h_pose, h_grid], dim=-1)
        return torch.relu(self.fuse_fc(fused))
