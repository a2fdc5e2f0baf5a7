"""Collision test against the scenes' render grids (port of
``gennbv_tpu/ops/render.py::check_collision_batch``).

Voxel-grid replacement of the PhysX contact-force termination test
(env_train_gennbv.py:446): a pose collides iff any occupied render voxel
lies under one of 27 probes on the cube of half-width `radius` around it.
The DDA ray-marcher of the JAX module is not ported yet (ROADMAP Queue 1
item 9).
"""
from __future__ import annotations

import torch

from gennbv_tpu_torch.ops import fp32


def check_collision_batch(occ_all, box_lo, box_hi, scene_id, pos,
                          radius: float, grid_res: int) -> torch.Tensor:
    """occ_all [S, R^3] (all scenes, never copied), box_lo/box_hi [S, 3],
    scene_id [N], pos [N, 3] -> [N] bool, with one flat gather into the
    scene stack."""
    r = grid_res
    n = pos.shape[0]
    lo = box_lo[scene_id]                                    # [N, 3]
    vsize = fp32.div_const(box_hi[scene_id] - lo, r)         # [N, 3]
    offs = torch.tensor([-radius, 0.0, radius], dtype=torch.float32,
                        device=pos.device)
    cube = torch.cartesian_prod(offs, offs, offs)            # [27, 3]
    probes = pos[:, None, :] + cube[None, :, :]              # [N, 27, 3]
    idx = torch.floor((probes - lo[:, None, :]) / vsize[:, None, :])
    idx = idx.clamp_(-1, r).long()
    in_grid = ((idx >= 0) & (idx < r)).all(-1)               # [N, 27]
    idx = idx.clamp_(0, r - 1)
    flat = (idx[..., 0] * r + idx[..., 1]) * r + idx[..., 2]
    gflat = scene_id[:, None].long() * (r ** 3) + flat
    occ = occ_all.reshape(-1)[gflat.reshape(-1)].reshape(n, -1)
    return ((occ > 0) & in_grid).any(-1)
