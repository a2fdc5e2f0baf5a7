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
import torch.nn.functional as F
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


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Batch normalisation over channel axis 1 of an [N, C, ...] input, with
    the train-mode semantics of Flax's ``nn.BatchNorm`` (the JAX encoder's):
    the batch variance is the biased one (Flax computes it as ``E[x^2] -
    E[x]^2`` clipped at 0, equal up to rounding), and it both normalises
    the batch and enters the running variance.
    ``torch.nn.BatchNorm3d`` would put the unbiased variance, n/(n-1)
    times larger, into the running stats, which the eval-mode policy then
    reads; the drift would grow with every PPO minibatch.  The running
    stats move as ``(1 - momentum) * old + momentum * batch`` (momentum 0.1
    is Flax's 0.9).  ``num_batches_tracked`` stays 0, as Flax has no such
    counter.  Eval mode normalises with the running stats, as PyTorch's
    does; the state_dict keys are PyTorch's.

    Under a mesh (``mesh``, set by ``parallel.mesh.shard_policy``) each
    rank holds a share of the minibatch, and the statistics are those of
    the whole minibatch, as GSPMD computes them: the per-channel sum and
    then the sum of squared deviations are summed over the env axis with
    the differentiable all-reduce, so the backward pass is the whole
    batch's too.  Without one, the local path below runs."""

    mesh = None

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"expected an [N, C, ...] input, got {x.dim()}-D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.mesh is not None:
            return self._forward_mesh(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, [0, *range(2, x.dim())], correction=0)
            stats = [self.running_mean, self.running_var]
            torch._foreach_mul_(stats, 1 - self.momentum)
            torch._foreach_add_(stats, [mean, var], alpha=self.momentum)
        # without running stats, PyTorch normalises with the biased batch
        # variance too (it is only its running-stat update that is unbiased)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _forward_mesh(self, x: torch.Tensor) -> torch.Tensor:
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        n = x.numel() // x.shape[1] * self.mesh.env_width
        mean = self.mesh.all_reduce_grad(x.sum(dims)) / n
        dev = x - mean.view(shape)
        var = self.mesh.all_reduce_grad((dev * dev).sum(dims)) / n
        with torch.no_grad():
            stats = [self.running_mean, self.running_var]
            torch._foreach_mul_(stats, 1 - self.momentum)
            torch._foreach_add_(stats, [mean.detach(), var.detach()],
                                alpha=self.momentum)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return dev * scale.view(shape) + self.bias.view(shape)


class HybridEncoder(nn.Module):
    """obs [N, >= 8600] -> feature [N, fused_dim].  Its two BatchNorms take
    Flax's train-mode statistics (``BatchNorm``: the biased batch variance
    in the running stats, momentum 0.1 = Flax's 0.9, eps 1e-5); the rollout
    and the eval run it in eval mode, the PPO update in train mode."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str = "cuda"):
        super().__init__()
        self.cfg = cfg
        c, hid = cfg.grid_channels, cfg.pose_mlp_hidden
        pose_in = spec.POSE_BUF_LEN * spec.ACTION_DIM * 2 * cfg.posenc_freqs
        self.pose_fc1 = nn.Linear(pose_in, hid, device=device)
        self.pose_fc2 = nn.Linear(hid, hid, device=device)
        self.grid_conv1 = nn.Conv3d(1, c, 3, stride=2, device=device)
        self.grid_bn1 = BatchNorm(c, eps=1e-5, momentum=0.1, device=device)
        self.grid_conv2 = nn.Conv3d(c, c, 3, stride=2, device=device)
        self.grid_bn2 = BatchNorm(c, eps=1e-5, momentum=0.1, device=device)
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
