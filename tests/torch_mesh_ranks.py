"""The cases of tests/test_torch_mesh.py, as functions a rank runs.

``parallel.mesh.launch`` starts each rank in a fresh process that imports
this module by name, so it imports torch and the port only (a test module
imports jax).  Each case builds its mesh from its config's runner fields;
called outside a process group it runs the one-process reference.  The
values returned are numpy arrays and floats (pickled back to the test).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from gennbv_tpu_torch import config, spec
from gennbv_tpu_torch.algo import ppo
from gennbv_tpu_torch.algo.repro import read_logged
from gennbv_tpu_torch.algo.runner import Runner
from gennbv_tpu_torch.env import make_scenes
from gennbv_tpu_torch.models import distributions
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.parallel import mesh as mesh_lib
from gennbv_tpu_torch.utils.checkpoint import CheckpointManager

NARROW = config.ModelConfig(pose_mlp_hidden=32, grid_channels=4, fused_dim=32)
# One update, W ranks against one process.  The summed gradients, the
# BatchNorm statistics and the metrics are float32 sums in another order:
# held to 1e-6 of each tensor's largest entry.  Two exceptions, from the
# arithmetic: a Conv3d weight's gradient sums ~1e4 products (the
# minibatch x 9^3 or 4^3 output positions, through the BatchNorm's
# backward), held to 1e-5 of its scale; the conv biases ahead of a
# BatchNorm have a zero gradient in exact arithmetic (the BN subtracts
# their per-channel constant), so each side computes the cancellation
# noise of those same sums, held to 1e-5 of the layer's weight gradient.
GRAD_RTOL, CONV_GRAD_RTOL = 1e-6, 1e-5
# after the update's Adam steps: tests/test_torch_ppo.py's PARAM_ATOL; an
# entry whose first moment lies within MU_SHARE of its tensor's largest is
# at float32 noise, which Adam's first step turns into up to lr, and is
# held to lr per update taken (tests/test_torch_off_policy.py's rule)
PARAM_ATOL, MU_SHARE = 2e-6, 2e-5
METRIC_RTOL, METRIC_ATOL = 1e-6, 1e-6


def tiny(num_devices: int = 0, num_slices: int = 1, model_axis: int = 1,
         num_envs: int = 8, n_steps: int = 8, batch_size: int = 16,
         shards: int = 8, model: config.ModelConfig = NARROW,
         total_iters: int = 2, depth: int = 2) -> config.Config:
    """tests/test_runner.py's tiny config at a 16x16 camera and grid."""
    return config.Config(
        env=config.EnvConfig(
            num_envs=num_envs,
            camera=config.CameraConfig(height=16, width=16),
            renderer=config.RendererConfig(resolution=16, zbuf_impl="mxu"),
            scene=config.SceneConfig(num_scenes=num_envs, seed=0),
            max_episode_length=12),
        model=model,
        ppo=config.PPOConfig(n_steps=n_steps, batch_size=batch_size,
                             n_epochs=2, total_iters=total_iters,
                             minibatch_shards=shards),
        runner=config.RunnerConfig(seed=1, save_freq=0,
                                   num_devices=num_devices,
                                   num_slices=num_slices,
                                   model_axis=model_axis,
                                   pipeline_depth=depth))


def one_process(cfg: config.Config) -> config.Config:
    return dataclasses.replace(cfg, runner=dataclasses.replace(
        cfg.runner, num_devices=0, num_slices=1, model_axis=1))


def rollout_data(cfg: config.Config, seed: int = 5) -> tuple:
    """A fixed rollout [T, N, ...] from numpy: observations in [0, 1), valid
    actions, offsets of the old log-probs from the initial policy's (which
    ``update_case`` adds), values, advantages and returns."""
    rng = np.random.default_rng(seed)
    t, n = cfg.ppo.n_steps, cfg.env.num_envs
    obs = rng.random((t, n, spec.OBS_DIM), dtype=np.float32)
    actions = np.stack([rng.integers(0, k, (t, n)) for k in spec.NVEC],
                       -1).astype(np.int32)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    return (obs, actions, 0.02 * f32(t, n), f32(t, n), f32(t, n), f32(t, n))


def mesh_case(device, num_slices: int = 1, model_axis: int = 1) -> dict:
    """The mesh of this process group: its shape, this rank's env place,
    the ranks of its env group and of each group its sums run over, and
    its rows of 8 envs."""
    mesh = mesh_lib.mesh_for(config.RunnerConfig(
        num_slices=num_slices, model_axis=model_axis), torch.device(device))
    rows = mesh_lib.env_rows(8, mesh)
    return {"shape": dict(mesh.shape), "env_index": mesh.env_index,
            "env_width": mesh.env_width,
            "env_group": dist.get_process_group_ranks(mesh.env_group),
            "reduce_groups": [dist.get_process_group_ranks(g)
                              for g in mesh.reduce_groups],
            "rows": (rows.start, rows.stop)}


def _numpy(tensors: dict) -> dict:
    return {k: mesh_lib.full(v).detach().cpu().numpy().copy()
            for k, v in tensors.items()}


class _Collectives:
    """Records (name, elements) of every all_reduce, all_gather and
    broadcast while active."""

    NAMES = ("all_reduce", "all_gather", "broadcast")

    def __enter__(self):
        self.calls, self.saved = [], {n: getattr(dist, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            def wrapped(t, *a, _name=name, _fn=fn, **k):
                size = t.numel() if isinstance(t, torch.Tensor) else sum(
                    x.numel() for x in t)
                self.calls.append((_name, int(size)))
                return _fn(t, *a, **k)
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def _policy(cfg: config.Config, device, mesh) -> ActorCriticPolicy:
    policy = ActorCriticPolicy(
        cfg.model, torch.Generator(device).manual_seed(cfg.runner.seed), device)
    mesh_lib.shard_policy(policy, mesh)
    return policy


def update_case(device, cfg: config.Config, seed: int = 5) -> dict:
    """From one fixed rollout: the summed gradients, metrics and BatchNorm
    running stats of the first minibatch, then a whole update (the
    parameters, Adam state, metrics and the collectives it made)."""
    mesh = mesh_lib.mesh_for(cfg.runner, torch.device(device))
    n, m = cfg.env.num_envs, cfg.env.num_envs * cfg.ppo.n_steps
    rows = mesh_lib.env_rows(n, mesh)
    data = tuple(torch.from_numpy(np.ascontiguousarray(x[:, rows])).to(device)
                 .reshape(-1, *x.shape[2:]) for x in rollout_data(cfg, seed))
    indices = ppo.minibatch_indices(cfg.ppo, m, n, torch.Generator(
        device).manual_seed(seed))

    policy = _policy(cfg, device, mesh).eval()
    with torch.no_grad():
        logp = distributions.log_prob(policy(data[0]).logits, data[1])
    data = (data[0], data[1], data[2] + logp, *data[3:])
    policy.train()
    flat = ppo.flat_rows(indices, m, n)
    step_data, step_rows = (data, flat) if mesh is None else ppo._rank_share(
        data, flat, mesh, n, indices.shape[1])
    params = dict(policy.named_parameters())
    grads, out = ppo._minibatch_step(policy, cfg.ppo, list(params.values()),
                                     step_data, step_rows[0], mesh)
    if mesh is not None:
        grads, out = ppo.reduce_step(grads, out, mesh)
    first = {"grads": _numpy(dict(zip(params, grads))),
             "step_metrics": out.cpu().numpy(),
             "bn": _numpy({k: v for k, v in policy.state_dict().items()
                           if "running" in k})}

    policy = _policy(cfg, device, mesh)
    opt = ppo.make_optimizer(cfg.ppo, n)
    with _Collectives() as rec:
        state, metrics = ppo.update(policy, opt, cfg.ppo, opt.init(policy),
                                    *data, num_envs=n, indices=indices,
                                    mesh=mesh)
    return {**first, "state": _numpy(policy.state_dict()),
            "mu": _numpy(state.mu), "nu": _numpy(state.nu),
            "count": int(state.count),
            "metrics": {k: float(v) for k, v in metrics._asdict().items()},
            "collectives": rec.calls,
            "n_params": sum(p.numel() for p in params.values())}


def train_case(device, cfg: config.Config, iters: int) -> dict:
    """`iters` iterations of Runner.train: the last metrics and the whole
    policy."""
    runner = Runner(cfg, device=device)
    metrics = runner.train(iters, log=False)
    return {"metrics": metrics, "state": _numpy(runner.variables())}


def pipelined_case(device, cfg: config.Config, iters: int,
                   log_dir: str) -> dict:
    """`iters` iterations of Runner.train at the config's pipeline depth,
    with an eval (2 held-out scenes) and a checkpoint every iteration
    into `log_dir`: the whole policy, and on rank 0 the metrics it logged
    and the checkpoint files it wrote."""
    cfg = dataclasses.replace(cfg, runner=dataclasses.replace(
        cfg.runner, eval_freq=1, save_freq=1))
    eval_scenes = make_scenes(config.SceneConfig(num_scenes=2, seed=9), 16,
                              device)
    runner = Runner(cfg, eval_scenes=eval_scenes, log_dir=log_dir,
                    device=device)
    runner.train(iters)
    runner.close()
    if runner.rank != 0:       # rank 0 writes, perhaps still
        return {"state": _numpy(runner.variables())}
    return {"logged": read_logged(log_dir),
            "files": sorted(os.listdir(runner.ckpt.ckpt_dir)),
            "state": _numpy(runner.variables())}


def probe_obs(seed: int = 9) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).random(
        (4, spec.OBS_DIM), dtype=np.float32))


@torch.no_grad()
def outputs(policy) -> tuple:
    policy.eval()
    out = policy(probe_obs().to(next(policy.parameters()).device))
    return (mesh_lib.full(out.logits).cpu().numpy(),
            mesh_lib.full(out.value).cpu().numpy())


def save_case(device, cfg: config.Config, models_dir: str) -> tuple:
    """Trains 1 iteration and saves its checkpoint into `models_dir` (every
    rank saves, rank 0 writes); returns the policy's outputs on
    ``probe_obs``."""
    runner = Runner(cfg, device=device)
    runner.train(1, log=False)
    CheckpointManager(models_dir).save_step(runner.global_step, runner.policy,
                                            runner.opt_state)
    return outputs(runner.policy)


def restore_case(device, cfg: config.Config, models_dir: str) -> dict:
    """A fresh Runner restores the latest checkpoint of `models_dir` and
    gives its policy's outputs, then trains on to 2 iterations in all."""
    runner = Runner(cfg, device=device)
    step = runner.restore(models_dir)
    restored = outputs(runner.policy)
    first = runner.iteration
    runner.train(2, log=False)
    return {"outputs": restored, "step": step, "first": first,
            "iteration": runner.iteration, "global_step": runner.global_step}


def cases(device, tasks: list) -> list:
    """Runs each (case name, args) of `tasks` in turn (every rank the same
    list); returns their results."""
    return [globals()[name](device, *args) for name, args in tasks]


def held_step(got: dict, want: dict) -> None:
    """Raises unless the first minibatch of `got` (``update_case`` on a
    mesh) agrees with `want`'s (one process) within the tolerances above:
    the summed gradients, the BatchNorm running stats and the metrics."""
    for k, w in want["grads"].items():
        layer = k.rsplit(".", 1)[0]
        if "conv" in k:
            tol = CONV_GRAD_RTOL * np.abs(want["grads"][f"{layer}.weight"]).max()
        else:
            tol = GRAD_RTOL * np.abs(w).max()
        err = np.abs(got["grads"][k] - w).max()
        assert err <= tol, (k, float(err), float(tol))
    for k, w in want["bn"].items():
        np.testing.assert_allclose(got["bn"][k], w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(), err_msg=k)
    np.testing.assert_allclose(got["step_metrics"], want["step_metrics"],
                               rtol=METRIC_RTOL, atol=METRIC_ATOL)


def held_update(got: dict, want: dict) -> None:
    """``held_step``, then the whole update: the parameters and the
    metrics."""
    held_step(got, want)
    assert got["count"] == want["count"] > 0
    lr = config.PPOConfig().learning_rate * want["count"]
    for k, w in want["state"].items():
        mu = want["mu"].get(k)
        tol = PARAM_ATOL if mu is None else np.where(
            np.abs(mu) <= MU_SHARE * np.abs(mu).max(), lr, PARAM_ATOL)
        assert (np.abs(got["state"][k] - w) <= tol).all(), k
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)
