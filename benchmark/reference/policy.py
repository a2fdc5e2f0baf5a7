"""The GenNBV actor-critic as plain PyTorch: the HybridEncoder of the
reference repo (``gennbv/network/hybrid_encoder.py``) with SB3's
MultiCategorical action head and value head (``net_arch=[]``).

- pose branch: obs[:, :600] -> (N, 100, 6) -> sin ++ cos of pose * [1, 2]
  -> MLP 2400 -> 256 -> 256;
- grid branch: obs[:, 600:8600] -> (N, 1, 20, 20, 20) -> [Conv3d(16, k3,
  s2) + BatchNorm + ReLU] x 2 -> channels-last flatten 1024 -> 256;
- fusion: concat 512 -> 256, then 240 logits (split 81, 81, 51, 1, 13,
  13) and one value.

BatchNorm follows Flax's train mode, as the JAX package's encoder does:
the biased batch variance normalises the batch and enters the running
variance, momentum 0.1.  The module names are the program's, so one
state_dict loads into both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

NVEC = (81, 81, 51, 1, 13, 13)
POSE_DIM, GRID, GRID_DIM = 600, 20, 8000


class BatchNorm(nn.Module):
    def __init__(self, c: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x):
        dims = [0, 2, 3, 4]
        if not self.training:
            shape = (1, -1, 1, 1, 1)
            return ((x - self.running_mean.view(shape))
                    / torch.sqrt(self.running_var.view(shape) + 1e-5)
                    * self.weight.view(shape) + self.bias.view(shape))
        var, mean = torch.var_mean(x, dims, correction=0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        shape = (1, -1, 1, 1, 1)
        return ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + 1e-5)
                * self.weight.view(shape) + self.bias.view(shape))


class Encoder(nn.Module):
    def __init__(self, model: dict, device):
        super().__init__()
        hid, c, fused = (model["pose_mlp_hidden"], model["grid_channels"],
                         model["fused_dim"])
        self.freqs = model["posenc_freqs"]
        self.pose_fc1 = nn.Linear(POSE_DIM * 2 * self.freqs, hid, device=device)
        self.pose_fc2 = nn.Linear(hid, hid, device=device)
        self.grid_conv1 = nn.Conv3d(1, c, 3, stride=2, device=device)
        self.grid_bn1 = BatchNorm(c, device)
        self.grid_conv2 = nn.Conv3d(c, c, 3, stride=2, device=device)
        self.grid_bn2 = BatchNorm(c, device)
        self.grid_fc = nn.Linear(c * 4 ** 3, fused, device=device)
        self.fuse_fc = nn.Linear(hid + fused, fused, device=device)

    def forward(self, obs):
        n = obs.shape[0]
        pose = obs[:, :POSE_DIM].reshape(n, -1, 6)
        bands = 2.0 ** torch.arange(self.freqs, dtype=obs.dtype,
                                    device=obs.device)
        scaled = (pose[..., None] * bands).reshape(n, -1, self.freqs * 6)
        pose = torch.cat([torch.sin(scaled), torch.cos(scaled)], -1).reshape(n, -1)
        h_pose = F.relu(self.pose_fc2(F.relu(self.pose_fc1(pose))))
        grid = obs[:, POSE_DIM:POSE_DIM + GRID_DIM].reshape(n, 1, GRID, GRID, GRID)
        grid = F.relu(self.grid_bn1(self.grid_conv1(grid)))
        grid = F.relu(self.grid_bn2(self.grid_conv2(grid)))
        h_grid = F.relu(self.grid_fc(grid.permute(0, 2, 3, 4, 1).reshape(n, -1)))
        return F.relu(self.fuse_fc(torch.cat([h_pose, h_grid], -1)))


class Policy(nn.Module):
    def __init__(self, model: dict, device):
        super().__init__()
        self.encoder = Encoder(model, device)
        self.action_net = nn.Linear(model["fused_dim"], sum(NVEC), device=device)
        self.value_net = nn.Linear(model["fused_dim"], 1, device=device)

    def forward(self, obs):
        feat = self.encoder(obs)
        return self.action_net(feat), self.value_net(feat)[..., 0]


def log_softmax_parts(logits):
    return [torch.log_softmax(c, -1) for c in torch.split(logits, NVEC, -1)]


def log_prob(logits, actions):
    return sum(lp.gather(-1, actions[..., i:i + 1].long())[..., 0]
               for i, lp in enumerate(log_softmax_parts(logits)))


def entropy(logits):
    return sum(-(lp.exp() * lp).sum(-1) for lp in log_softmax_parts(logits))


def mode(logits):
    return torch.stack([c.argmax(-1) for c in torch.split(logits, NVEC, -1)],
                       -1).to(torch.int32)
