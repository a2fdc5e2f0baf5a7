"""Single dataclass config tree (PyTorch port).

A copy of ``gennbv_tpu/config.py`` with the same dataclasses, defaults and
dotted-path overrides (``--set env.camera.height=128``), importing the
port's own ``spec``.  The JAX package's config cannot be imported here:
``import gennbv_tpu.config`` runs ``gennbv_tpu/__init__.py``'s package
imports, which pull in jax.

Renderer settings the port does not implement yet raise
``NotImplementedError`` naming the ROADMAP item that brings them, at
construction (so also from ``apply_overrides``); they are never silently
ignored.  ``gather_impl`` and ``scatter_impl`` are accepted for config
compatibility but select nothing: in the port, the device of the tensors
picks the hand-written CUDA kernel (CUDA tensors) or its plain PyTorch
version (CPU tensors).
"""
from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from gennbv_tpu_torch import spec


def _unsupported(setting: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{setting} is not implemented in gennbv_tpu_torch yet "
        f"(ROADMAP.md {item})")


@dataclass
class CameraConfig:
    height: int = spec.CAMERA_HEIGHT
    width: int = spec.CAMERA_WIDTH
    horizontal_fov_deg: float = spec.HORIZONTAL_FOV_DEG
    z_offset: float = spec.CAMERA_Z_OFFSET
    depth_max: float = spec.DEPTH_MAX


@dataclass
class RendererConfig:
    """Depth renderer.  The port implements mode "splat" with the
    integer-key-min z-buffer (the semantics of the JAX package's
    ``zbuf_impl="mxu"`` radix min) and the 3x3 footprint."""
    mode: str = "splat"
    resolution: int = 64          # render-grid voxels per axis (R)
    footprint: int = 1            # splat radius in pixels (1 -> 3x3)
    zbuf_impl: str = "mxu"
    compact_cap_frac: Optional[float] = None
    band_split: Optional[int] = None
    merge_vis_carve: bool = False
    # accepted for compatibility; the tensor's device picks kernel or plain
    gather_impl: str = "auto"
    band_cap_frac: float = 0.5
    scatter_impl: str = "mxu"

    def __post_init__(self):
        if self.mode != "splat":
            raise _unsupported(f"renderer.mode={self.mode!r}",
                               "Queue 1 item 10")
        if self.zbuf_impl != "mxu":
            item = ("Queue 2 item 3" if self.zbuf_impl == "pallas"
                    else "Queue 1 item 10")
            raise _unsupported(f"renderer.zbuf_impl={self.zbuf_impl!r}", item)
        if self.merge_vis_carve:
            raise _unsupported("renderer.merge_vis_carve=True",
                               "Queue 1 item 10")
        if self.compact_cap_frac is not None:
            raise _unsupported("renderer.compact_cap_frac", "Queue 1 item 10")
        if self.band_split:
            raise _unsupported("renderer.band_split", "Queue 1 item 10")
        for name in ("gather_impl", "scatter_impl"):
            if getattr(self, name) not in ("auto", "mxu", "pallas"):
                raise ValueError(f"renderer.{name}={getattr(self, name)!r}: "
                                 "expected 'auto', 'mxu' or 'pallas'")


@dataclass
class SceneConfig:
    num_scenes: int = 256
    grid_size: int = spec.GRID_SIZE
    # world box of the mapped region; x,y in [-extent/2, extent/2], z in [0, extent_z]
    extent_xy: float = 10.0
    extent_z: float = 6.0
    # the port generates "procedural" houses only (env/scene.py)
    dataset: str = "procedural"
    # procedural generator difficulty: "standard" | "hard"
    difficulty: str = "standard"
    seed: int = 0


@dataclass
class RewardConfig:
    """Pre-dt reward scales (config_gennbv_train.py:13-20); effective
    per-step scale = scale * dt (drone_robot.py:874-884)."""
    surface_coverage: float = 1000.0
    short_path: float = 5.0
    termination: float = 50.0
    only_positive: bool = True
    dt: float = spec.DT


@dataclass
class EnvConfig:
    num_envs: int = spec.PPO_NUM_ENVS
    max_episode_length: int = spec.MAX_EPISODE_LENGTH_TRAIN
    coverage_done_threshold: Optional[float] = spec.COVERAGE_DONE_THRESHOLD_TRAIN
    reward: RewardConfig = field(default_factory=RewardConfig)
    pose_buf_len: int = spec.POSE_BUF_LEN
    rgb_k: int = spec.RGB_K
    rgb_h: int = spec.RGB_H
    rgb_w: int = spec.RGB_W
    # "ztest" = projective z-test carving; "bresenham" is not ported yet
    carve_mode: str = "ztest"
    # collision test: occupied render voxel within this world radius of the pose
    collision_radius: float = 0.25
    camera: CameraConfig = field(default_factory=CameraConfig)
    renderer: RendererConfig = field(default_factory=RendererConfig)
    scene: SceneConfig = field(default_factory=SceneConfig)

    def __post_init__(self):
        if self.carve_mode != "ztest":
            raise _unsupported(f"carve_mode={self.carve_mode!r}",
                               "Queue 1 item 10")


def with_camera(env_cfg: EnvConfig, resolution: int) -> EnvConfig:
    """env_cfg with a square camera of the given resolution."""
    return dataclasses.replace(
        env_cfg, camera=dataclasses.replace(
            env_cfg.camera, height=resolution, width=resolution))


def eval_env_config(train_cfg: EnvConfig) -> EnvConfig:
    """The eval-env variant (config_gennbv_eval.py:6-14 +
    env_eval_gennbv check_termination): 30-step episodes, only the
    surface-coverage reward at scale 50, no positive clipping, no
    coverage-threshold termination."""
    return dataclasses.replace(
        train_cfg,
        num_envs=spec.EVAL_NUM_ENVS,
        max_episode_length=spec.MAX_EPISODE_LENGTH_EVAL,
        coverage_done_threshold=None,
        reward=RewardConfig(
            surface_coverage=50.0, short_path=0.0, termination=0.0,
            only_positive=False,
        ),
    )


@dataclass
class ModelConfig:
    pose_mlp_hidden: int = 256
    posenc_freqs: int = 2
    grid_channels: int = 16
    fused_dim: int = 256
    # keep the dead state_rgb input dead, as in the reference (hybrid_encoder.py:83)
    use_state_rgb: bool = False


@dataclass
class PPOConfig:
    n_steps: int = spec.PPO_N_STEPS
    batch_size: int = spec.PPO_BATCH_SIZE
    n_epochs: int = spec.PPO_N_EPOCHS
    learning_rate: float = spec.PPO_LR
    gamma: float = spec.PPO_GAMMA
    gae_lambda: float = spec.PPO_GAE_LAMBDA
    clip_range: float = spec.PPO_CLIP_RANGE
    clip_range_vf: Optional[float] = spec.PPO_CLIP_RANGE_VF
    vf_coef: float = spec.PPO_VF_COEF
    ent_coef: float = spec.PPO_ENT_COEF
    target_kl: Optional[float] = spec.PPO_TARGET_KL
    max_grad_norm: float = spec.PPO_MAX_GRAD_NORM
    adam_eps: float = spec.PPO_ADAM_EPS
    normalize_advantage: bool = True
    # reference multiplies the pg term by 10 (ppo_grid_obs.py:253); parity default on
    policy_loss_mult: float = spec.PPO_POLICY_LOSS_MULT
    # "constant" (reference default) | "linear" anneal to 0 (SB3 schedules)
    lr_schedule: str = "constant"
    total_iters: int = spec.PPO_TOTAL_ITERS
    # entropy floor (None = off, reference parity)
    ent_floor: Optional[float] = None
    ent_floor_coef: float = 0.1
    apply_mode: str = "select"
    # logical env groups for minibatch sampling (algo/ppo.py _minibatch_shards)
    minibatch_shards: int = 8


@dataclass
class RunnerConfig:
    seed: int = 1
    log_dir: str = "runs"
    experiment_name: str = "gennbv_tpu"
    save_freq: int = 100            # iterations between checkpoints
    log_interval: int = 1
    eval_freq: int = 0              # iterations between evals; 0 = no in-train eval
    # evaluate under this camera resolution regardless of the training
    # camera (0 = same as training)
    eval_camera: int = 0
    eval_accuracy: bool = False
    eval_n_episodes: int = spec.EVAL_N_EPISODES
    best_metric: str = "episode_reward"   # gennbv/callback.py:25-70
    wandb: bool = False
    num_devices: int = 0
    num_slices: int = 1
    model_axis: int = 1
    profile_dir: str = ""
    pipeline_depth: int = 2
    obs_dtype: str = "float32"      # rollout obs storage dtype


@dataclass
class Config:
    env: EnvConfig = field(default_factory=EnvConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    ppo: PPOConfig = field(default_factory=PPOConfig)
    runner: RunnerConfig = field(default_factory=RunnerConfig)


def _is_optional_field(node: Any, name: str) -> bool:
    """True when the dataclass field is Optional-typed (Union[..., None]).
    Annotations are strings under `from __future__ import annotations`, so
    resolve them through typing.get_type_hints."""
    try:
        hints = typing.get_type_hints(type(node))
    except Exception:
        return False
    t = hints.get(name)
    return (typing.get_origin(t) is typing.Union
            and type(None) in typing.get_args(t))


def _coerce(value: str, old: Any, optional: bool = False) -> Any:
    if value.lower() in ("none", "null"):
        # only Optional-typed fields accept None
        if not optional:
            raise ValueError(
                f"cannot set a non-Optional config field to {value!r}")
        return None
    if old is None:
        try:
            return int(value)
        except ValueError:
            try:
                return float(value)
            except ValueError:
                return value
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes", "on")
    return type(old)(value)


def apply_overrides(cfg: Config, overrides: Tuple[str, ...]) -> Config:
    """Apply `a.b.c=value` overrides, returning a new Config."""
    for item in overrides:
        path, _, value = item.partition("=")
        keys = path.strip().split(".")
        # walk down, rebuilding dataclasses immutably from the leaf up
        def set_in(node, keys):
            if len(keys) == 1:
                old = getattr(node, keys[0])
                new = _coerce(value, old, _is_optional_field(node, keys[0]))
                return dataclasses.replace(node, **{keys[0]: new})
            child = getattr(node, keys[0])
            return dataclasses.replace(node, **{keys[0]: set_in(child, keys[1:])})
        cfg = set_in(cfg, keys)
    return cfg


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    return cfg
