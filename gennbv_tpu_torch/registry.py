"""Task registry: name -> (env, its config) (port of
``gennbv_tpu/registry.py``).

Keeps the reference's task-name semantics (legged_gym/utils/task_registry.py;
`train_gennbv` / `eval_gennbv` registered at gennbv/__init__.py:6-7)
without the class-registry machinery: a task is a function from a Config
and a device to a ready env.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.config import Config, eval_env_config

_REGISTRY: Dict[str, Callable] = {}


def register(name: str, factory: Callable) -> None:
    _REGISTRY[name] = factory


def make_env(name: str, cfg: Config, device="cuda"):
    """(env, env_cfg) like task_registry.make_env (task_registry.py:66), the
    env on `device`."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg, device)


def task_names():
    return sorted(_REGISTRY)


def _make_train(cfg: Config, device):
    from gennbv_tpu_torch.env import ReconEnv, make_scenes
    scenes = make_scenes(cfg.env.scene, cfg.env.renderer.resolution,
                         device=device)
    return ReconEnv(cfg.env, scenes), cfg.env


def _make_eval(cfg: Config, device):
    from gennbv_tpu_torch.env import ReconEnv, make_scenes
    env_cfg = eval_env_config(cfg.env)
    scene_cfg = dataclasses.replace(
        cfg.env.scene, num_scenes=spec.EVAL_NUM_ENVS, seed=cfg.env.scene.seed + 100)
    scenes = make_scenes(scene_cfg, cfg.env.renderer.resolution, device=device)
    return ReconEnv(env_cfg, scenes), env_cfg


def _make_drone(cfg: Config, device):
    """Physics quadrotor velocity-tracking task (legged_gym/env/base/
    drone_robot.py:49 re-created).  Driven by the continuous rsl_rl-family
    stack (OnPolicyRunner + Gaussian PPO); takes its own DroneRobotConfig
    rather than the ReconEnv Config tree, as the reference registry binds
    each task to its own cfg class."""
    from gennbv_tpu_torch.env.drone_robot import DroneRobot, DroneRobotConfig
    dcfg = DroneRobotConfig()
    return DroneRobot(dcfg, device=device), dcfg


def _make_legged(robot: str):
    def factory(cfg: Config, device):
        """Physics legged robot velocity task (legged_gym/env/base/
        legged_robot.py:49; robot parameter sets from
        legged_gym/env/{a1,anymal_b,anymal_c,cassie}/)."""
        from gennbv_tpu_torch.env import legged_robot as lr
        lcfg = lr.ZOO[robot]()
        return lr.LeggedRobot(lcfg, device=device), lcfg
    return factory


register("train_gennbv", _make_train)
register("eval_gennbv", _make_eval)
register("drone_velocity", _make_drone)
for _robot in ("a1", "anymal_b", "anymal_c", "cassie"):
    register(f"{_robot}_velocity", _make_legged(_robot))
