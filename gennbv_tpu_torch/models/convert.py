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

``jax_opt_state_to_port`` carries optax's Adam state over the same way.
``gaussian_ac_to_state_dict`` and ``jax_continuous_opt_state_to_port`` do
the same for ``GaussianActorCritic`` and ``RecurrentActorCritic`` (its
LSTM and GRU cells' kernels concatenated gate by gate) and the continuous
learner's optimizer (``algo/ppo_continuous.py``, ``ppo_recurrent.py``).
``cnn_policy_to_state_dict`` takes ``models/torso.py``'s ``CnnPolicy``
(Conv kernel [kH, kW, in, out] -> Conv2d weight [out, in, kH, kW]).
``off_policy_net_to_state_dict`` takes the off-policy family's networks
(``models/off_policy_nets.py``); their optimizers' states (a plain
``optax.adam``, DQN's ``chain(clip_by_global_norm, adam)``) go through
``jax_opt_state_to_port`` with it.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from gennbv_tpu_torch.algo.ppo import AdamState
from gennbv_tpu_torch.algo.ppo_continuous import ContinuousOptState


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A tree shaped like the policy's ``params`` -> the parameters of the
    state_dict."""
    enc = params["encoder"]
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
        bn = enc[f"grid_bn{i}"]
        sd[f"encoder.grid_bn{i}.weight"] = _t(bn["scale"])
        sd[f"encoder.grid_bn{i}.bias"] = _t(bn["bias"])
    dense("action_net", params["action_net"])
    dense("value_net", params["value_net"])
    return sd


def jax_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    sd = _params(variables["params"])
    enc_stats = variables["batch_stats"]["encoder"]
    for i in (1, 2):
        bn_stats = enc_stats[f"grid_bn{i}"]
        sd[f"encoder.grid_bn{i}.running_mean"] = _t(bn_stats["mean"])
        sd[f"encoder.grid_bn{i}.running_var"] = _t(bn_stats["var"])
        sd[f"encoder.grid_bn{i}.num_batches_tracked"] = torch.tensor(0)
    return sd


def jax_opt_state_to_port(opt_state: Any, params_to_port=None) -> AdamState:
    """optax's state of ``ppo.make_optimizer``'s chain (or of any chain
    holding one Adam: a plain ``optax.adam``, ``chain(clip_by_global_norm,
    adam)``) -> the port's ``AdamState``: Adam's mu and nu trees take the
    parameters' key mapping and transposes (``params_to_port``, by default
    the policy's), and the count is Adam's, which the schedule's count
    (when the chain has one) must equal."""
    params_to_port = params_to_port or _params
    adam, counts = None, []

    def walk(node: Any) -> None:
        nonlocal adam
        fields = getattr(node, "_fields", ())     # optax states are NamedTuples
        if "mu" in fields and "nu" in fields:
            adam = node
        elif "count" in fields:
            counts.append(int(np.asarray(node.count)))
        elif isinstance(node, tuple):
            for child in node:
                walk(child)

    walk(opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in the optax state")
    count = int(np.asarray(adam.count))
    if any(c != count for c in counts):
        raise ValueError(f"schedule counts {counts} differ from Adam's {count}")
    return AdamState(params_to_port(adam.mu), params_to_port(adam.nu), count)


def off_policy_net_to_state_dict(params: Mapping[str, Any]
                                 ) -> dict[str, torch.Tensor]:
    """The ``params`` of one of ``gennbv_tpu.models.off_policy_nets``'
    networks (``QCritic``, ``DeterministicActor``,
    ``SquashedGaussianActor``, ``DiscreteQNet``), or a tree shaped like
    them (Adam's moments) -> the port's state_dict: every layer is a Dense
    that keeps its name (``q{k}_{i}``, ``pi_out``, ``mean``, ``log_std``,
    ...), its kernel [in, out] transposed to a weight [out, in]."""
    sd: dict[str, torch.Tensor] = {}
    for name, p in params.items():
        sd[f"{name}.weight"] = _t(p["kernel"]).T.contiguous()
        sd[f"{name}.bias"] = _t(p["bias"])
    return sd


def gaussian_ac_to_state_dict(params: Mapping[str, Any]
                              ) -> dict[str, torch.Tensor]:
    """The ``params`` of ``gennbv_tpu.models.actor_critic.
    GaussianActorCritic`` or ``RecurrentActorCritic`` (or a tree shaped
    like them: Adam's moments) -> the port's state_dict: each Dense layer
    keeps its name, its kernel transposed; ``log_std`` as it is; the
    ``memory_a``/``memory_c`` cells by ``_cell``."""
    sd: dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if name == "log_std":
            sd[name] = _t(p)
        elif name in ("memory_a", "memory_c"):
            sd.update({f"{name}.{k}": v for k, v in _cell(p).items()})
        else:
            sd[f"{name}.weight"] = _t(p["kernel"]).T.contiguous()
            sd[f"{name}.bias"] = _t(p["bias"])
    return sd


def _cell(p: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A Flax OptimizedLSTMCell's (ii/if/ig/io without bias, hi/hf/hg/ho
    with) or GRUCell's (ir/iz/in with bias, hr/hz without, hn with)
    params -> the port's cell: each gate's kernel transposed, stacked
    along the rows in gate order."""
    def rows(names, part="kernel"):
        return torch.cat([_t(p[n][part]).T if part == "kernel" else _t(p[n][part])
                          for n in names]).contiguous()

    if "ii" in p:
        return {"weight_i": rows(("ii", "if", "ig", "io")),
                "weight_h": rows(("hi", "hf", "hg", "ho")),
                "bias_h": rows(("hi", "hf", "hg", "ho"), "bias")}
    return {"weight_i": rows(("ir", "iz", "in")),
            "bias_i": rows(("ir", "iz", "in"), "bias"),
            "weight_h": rows(("hr", "hz", "hn")),
            "bias_hn": _t(p["hn"]["bias"])}


def cnn_policy_to_state_dict(params: Mapping[str, Any]
                             ) -> dict[str, torch.Tensor]:
    """The ``params`` of ``gennbv_tpu.models.torso.CnnPolicy`` -> the
    port's ``CnnPolicy`` state_dict: the NatureCNN's convolutions
    HWIO -> OIHW, its ``fc`` and the heads' Dense kernels transposed (the
    port flattens the conv features in Flax's NHWC order before ``fc``)."""
    sd: dict[str, torch.Tensor] = {}

    def dense(prefix, q):
        sd[f"{prefix}.weight"] = _t(q["kernel"]).T.contiguous()
        sd[f"{prefix}.bias"] = _t(q["bias"])

    for name in ("c1", "c2", "c3"):
        conv = params["cnn"][name]
        sd[f"cnn.{name}.weight"] = _t(conv["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"cnn.{name}.bias"] = _t(conv["bias"])
    dense("cnn.fc", params["cnn"]["fc"])
    for name, q in params.get("torso", {}).items():
        dense(f"torso.{name}", q)
    dense("action_net", params["action_net"])
    dense("value_net", params["value_net"])
    return sd


def jax_continuous_opt_state_to_port(opt_state: Any,
                                     device: torch.device | str = "cpu"
                                     ) -> ContinuousOptState:
    """optax's state of ``ppo_continuous.make_optimizer``'s chain
    (``clip_by_global_norm``, then ``inject_hyperparams(adam | rmsprop)``)
    -> the port's ``ContinuousOptState`` on `device`: the moments take the
    parameters' mapping, the injected learning rate stays float32, and the
    count is the injected one, which Adam's own count must equal."""
    inject = next((s for s in opt_state
                   if "hyperparams" in getattr(s, "_fields", ())), None)
    if inject is None:
        raise ValueError("no inject_hyperparams state in the optax state")
    count = int(np.asarray(inject.count))
    lr = torch.tensor(np.asarray(inject.hyperparams["learning_rate"],
                                 np.float32), device=device)
    inner = inject.inner_state[0]
    if "mu" in inner._fields:
        if int(np.asarray(inner.count)) != count:
            raise ValueError(f"Adam's count {int(np.asarray(inner.count))} "
                             f"differs from the injected count {count}")
        mu = gaussian_ac_to_state_dict(inner.mu)
    else:
        mu = {}
    nu = gaussian_ac_to_state_dict(inner.nu)

    def dev(d):
        return {k: v.to(device) for k, v in d.items()}

    return ContinuousOptState(dev(mu), dev(nu), count, lr)
