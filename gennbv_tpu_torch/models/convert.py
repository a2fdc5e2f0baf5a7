"""JAX (Flax) policy variables -> the port's ``ActorCriticPolicy`` state_dict.

Takes the ``variables`` of ``gennbv_tpu.models.policy.init_policy`` (or a
checkpoint of them) as nested mappings of arrays -- numpy arrays, or
anything ``numpy.asarray`` reads -- with ``params`` and ``batch_stats``
collections.  Imports no JAX.

- Dense kernel [in, out] -> Linear weight [out, in];
- Conv kernel [kD, kH, kW, in, out] -> Conv3d weight [out, in, kD, kH, kW]
  (both are cross-correlations over the same (x, y, z) grid axes);
- BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def jax_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    enc, enc_stats = params["encoder"], stats["encoder"]
    sd: dict[str, torch.Tensor] = {}

    def dense(prefix: str, p: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = _t(p["kernel"]).T.contiguous()
        sd[f"{prefix}.bias"] = _t(p["bias"])

    for name in ("pose_fc1", "pose_fc2", "grid_fc", "fuse_fc"):
        dense(f"encoder.{name}", enc[name])
    for i in (1, 2):
        conv = enc[f"grid_conv{i}"]
        sd[f"encoder.grid_conv{i}.weight"] = _t(conv["kernel"]).permute(
            4, 3, 0, 1, 2).contiguous()
        sd[f"encoder.grid_conv{i}.bias"] = _t(conv["bias"])
        bn, bn_stats = enc[f"grid_bn{i}"], enc_stats[f"grid_bn{i}"]
        sd[f"encoder.grid_bn{i}.weight"] = _t(bn["scale"])
        sd[f"encoder.grid_bn{i}.bias"] = _t(bn["bias"])
        sd[f"encoder.grid_bn{i}.running_mean"] = _t(bn_stats["mean"])
        sd[f"encoder.grid_bn{i}.running_var"] = _t(bn_stats["var"])
        sd[f"encoder.grid_bn{i}.num_batches_tracked"] = torch.tensor(0)
    dense("action_net", params["action_net"])
    dense("value_net", params["value_net"])
    return sd
