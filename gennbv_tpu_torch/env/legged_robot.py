"""Physics legged robot: the LeggedRobot half of the legged_gym robot layer
(port of ``gennbv_tpu/env/legged_robot.py``).

The reference's `LeggedRobot` (legged_gym/env/base/legged_robot.py:49) is a
PD-position-controlled articulated robot on Isaac Gym PhysX: 12-DoF torque
step under decimation (`step`/`_compute_torques`, legged_robot.py:91-117,
414-438), a velocity-command task with heading mode (:361-399), the
canonical legged reward set (~20 `_reward_*` primitives, :950-1094),
terrain + command curricula (:486-520), friction/mass domain rand and
impulse pushes (:299-383,483), and contact-driven termination (:160-167).

The articulated dynamics are the JAX package's reduced model:
  * the TRUNK is a 6-DoF rigid body (quaternion exp-map integration,
    semi-implicit Euler), as the quadrotor in drone_robot.py;
  * each LEG is a 3-joint chain (hip abduction about x, hip flexion and
    knee about y) with second-order joint dynamics under PD torque and
    reflected inertia;
  * FEET are point contacts against an analytic terrain height field:
    spring-damper normal force + Coulomb-capped anchor-spring friction.
    Each contact force is applied to the trunk as a wrench at the foot AND
    reflected into the leg joints through the foot Jacobian (tau += J^T F).

The foot Jacobian is the closed form of the 3-joint chain's (the JAX
package differentiates the forward kinematics with ``jax.jacfwd``;
tests/test_torch_legged.py holds the two together).  Every op carries the
env axis, on the env's device; the step is a function of (state, actions),
its random draws coming from the generator state the LeggedState carries
(``utils/rng.py``).  It satisfies the env contract of
``utils/env_checker.py``, so ``algo/on_policy_runner.py`` and
``algo/ppo_recurrent.py`` drive it.

The rough terrain's hash, ``frac(sin(ix * 127.1 + iy * 311.7) *
43758.5453)``, takes its sine argument as two rounded products and a
rounded sum, as XLA compiles it inside the JAX env (each product feeds two
corners, so XLA fuses no multiply-add there); ``torch.sin`` still differs
from XLA's sine by an ulp at some arguments, which the gain of 43,758
turns into up to two ulps of the product: the hash is held to the JAX one
by circular distance (ROADMAP, Queue 3, kept divergences).

Robot zoo: `a1_config()` / `anymal_b_config()` / `anymal_c_config()` /
`cassie_config()` (legged_gym/env/{a1,anymal_b,anymal_c,cassie}/
*_config.py); cassie is the two-leg instantiation of the same chain.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gennbv_tpu_torch.ops import fp32
from gennbv_tpu_torch.utils import math as um
from gennbv_tpu_torch.utils import rng as rng_lib


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LeggedAsset:
    """Physical constants (A1 defaults; a1.urdf via
    legged_gym/env/a1/a1_config.py:65-70)."""
    mass: float = 12.0                  # kg (A1 total ~12.45)
    # whole-body inertia (trunk + folded legs)
    inertia: Tuple[float, float, float] = (0.07, 0.15, 0.17)  # kg m^2
    num_legs: int = 4
    # hip positions in the trunk frame, legs ordered FL/FR/RL/RR
    hip_x: float = 0.183
    hip_y: float = 0.047
    l_hip: float = 0.08                 # abduction link, along +-y
    l_thigh: float = 0.2
    l_calf: float = 0.2
    joint_inertia: float = 0.035        # reflected inertia per joint, kg m^2
    joint_damping: float = 1.2          # N m s/rad actuator friction
    torque_limit: float = 33.5          # N m (A1)
    dof_vel_limit: float = 21.0         # rad/s
    # joint angle limits (abd, hip, knee), left-side convention (a1.urdf)
    q_low: Tuple[float, float, float] = (-0.80, -1.05, -2.70)
    q_high: Tuple[float, float, float] = (0.80, 4.19, -0.92)
    # default joint targets at action=0 (a1_config.py:38-55); abduction
    # sign flips with leg side
    default_abd: float = 0.1
    default_hip_front: float = 0.8
    default_hip_rear: float = 1.0
    default_knee: float = -1.5
    # spawn trunk height over terrain; None = computed from the FK stance
    init_height: Optional[float] = None
    base_clearance: float = 0.09        # trunk-bottom contact radius
    gravity: float = -9.81


@dataclasses.dataclass(frozen=True)
class LeggedControl:
    """PD drive (a1_config.py:57-63; _compute_torques,
    legged_robot.py:414-438).  8 x 0.0025 s = the reference's 0.02 s
    control dt."""
    control_type: str = "P"            # P position | V velocity | T torque
    stiffness: float = 20.0            # N m / rad
    damping: float = 0.5               # N m s / rad
    action_scale: float = 0.25         # target = scale * action + default
    decimation: int = 8


@dataclasses.dataclass(frozen=True)
class LeggedContact:
    """Penalty-contact model constants (in place of the PhysX solver
    params of legged_robot_config.py's sim section)."""
    k_normal: float = 2500.0           # N/m foot spring
    d_normal: float = 250.0            # N s/m foot damper
    # stiction-capable tangential friction: a spring to a per-foot anchor
    # + damper, Coulomb-capped; the anchor slides when the cap binds
    k_tangent: float = 2500.0          # N/m anchor spring
    d_tangent: float = 100.0           # N s/m tangential damper
    foot_radius: float = 0.02
    max_force_mg: float = 4.0          # per-foot |F_n| cap, in robot weights


@dataclasses.dataclass(frozen=True)
class LeggedDomainRand:
    """legged_robot.py:299-383,483; config at legged_robot_config.py:126."""
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.5, 1.25)
    randomize_base_mass: bool = False
    added_mass_range: Tuple[float, float] = (-1.0, 1.0)
    push_robots: bool = True
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 1.0


@dataclasses.dataclass(frozen=True)
class LeggedCommands:
    """4 commands: vx, vy, yaw_rate, heading (legged_robot_config.py:71-82).
    In heading mode the yaw-rate command is servo-derived from the heading
    error each step (legged_robot.py:367-370)."""
    resampling_time_s: float = 10.0
    heading_command: bool = True
    lin_vel_x: Tuple[float, float] = (-1.0, 1.0)
    lin_vel_y: Tuple[float, float] = (-1.0, 1.0)
    ang_vel_yaw: Tuple[float, float] = (-1.0, 1.0)
    heading: Tuple[float, float] = (-3.14, 3.14)
    curriculum: bool = False
    max_curriculum: float = 1.0         # |vx| cap under curriculum


@dataclasses.dataclass(frozen=True)
class LeggedTerrain:
    """Procedural height field (legged_gym/utils/terrain.py; config at
    legged_robot_config.py:44-69).  `rough` is hash-based value noise whose
    amplitude scales with the per-env curriculum level (terrain rows)."""
    mesh_type: str = "plane"           # "plane" | "rough"
    horizontal_scale: float = 0.25     # noise cell size, m
    max_amplitude: float = 0.08        # m at the top curriculum level
    num_levels: int = 10               # terrain rows (curriculum levels)
    terrain_length: float = 8.0        # m, the curriculum promotion yardstick
    curriculum: bool = False
    max_init_level: int = 5
    measure_heights: bool = False      # adds the 17x11 height grid to obs
    static_friction: float = 1.0


@dataclasses.dataclass(frozen=True)
class LeggedObsScales:
    """normalization.obs_scales (legged_robot_config.py:192-201)."""
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    height_measurements: float = 5.0


@dataclasses.dataclass(frozen=True)
class LeggedNoise:
    """noise.noise_scales x noise_level (legged_robot_config.py:203-211;
    vector layout from _get_noise_scale_vec, legged_robot.py:532-556)."""
    add_noise: bool = False
    noise_level: float = 1.0
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    gravity: float = 0.05
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    height_measurements: float = 0.1


@dataclasses.dataclass(frozen=True)
class LeggedRobotConfig:
    sim_dt: float = 0.0025
    max_episode_length_s: float = 20.0
    clip_actions: float = 100.0
    clip_observations: float = 100.0
    # Reward section (legged_robot_config.py:135-190 + a1_config.py:72-79):
    # upstream legged_gym's tracking set with the fork's penalty values
    reward_scales: Optional[Dict[str, float]] = None
    only_positive_rewards: bool = True  # legged_robot_config.py:184
    tracking_sigma: float = 0.25
    soft_dof_pos_limit: float = 0.9     # a1_config.py:73
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    base_height_target: float = 0.25    # a1_config.py:74
    max_contact_force: float = 100.0
    termination_tilt: float = 1.2       # rad (stand-in for base contact)
    obs_noise: LeggedNoise = dataclasses.field(default_factory=LeggedNoise)
    obs_scales: LeggedObsScales = dataclasses.field(
        default_factory=LeggedObsScales)
    asset: LeggedAsset = dataclasses.field(default_factory=LeggedAsset)
    control: LeggedControl = dataclasses.field(default_factory=LeggedControl)
    contact: LeggedContact = dataclasses.field(default_factory=LeggedContact)
    domain_rand: LeggedDomainRand = dataclasses.field(
        default_factory=LeggedDomainRand)
    commands: LeggedCommands = dataclasses.field(
        default_factory=LeggedCommands)
    terrain: LeggedTerrain = dataclasses.field(default_factory=LeggedTerrain)

    def resolved_reward_scales(self) -> Dict[str, float]:
        if self.reward_scales is not None:
            return dict(self.reward_scales)
        return {
            "tracking_lin_vel": 1.0,
            "tracking_ang_vel": 0.5,
            "lin_vel_z": -2.0,           # legged_robot_config.py:139
            "ang_vel_xy": -0.05,
            "orientation": -0.5,
            "base_height": -1.0,
            "torques": -0.0002,          # a1_config.py:78
            "dof_acc": -2.5e-7,
            "action_rate": -0.01,
            "collision": -0.5,
            "dof_pos_limits": -10.0,     # a1_config.py:79
            "feet_air_time": 1.0,        # legged_robot_config.py:174
            "termination": 0.0,
        }


class LeggedState(NamedTuple):
    pos: torch.Tensor            # [N, 3] trunk COM, world
    quat: torch.Tensor           # [N, 4] (x, y, z, w)
    lin_vel: torch.Tensor        # [N, 3] world
    ang_vel: torch.Tensor        # [N, 3] body
    q: torch.Tensor              # [N, nj] joint angles
    qd: torch.Tensor             # [N, nj] joint velocities
    commands: torch.Tensor       # [N, 4] vx, vy, yaw_rate, heading
    last_action: torch.Tensor    # [N, nj]
    last_qd: torch.Tensor        # [N, nj] (for dof_acc)
    torques: torch.Tensor        # [N, nj] applied PD torques
    contact_forces: torch.Tensor  # [N, L, 3] world, at the feet
    foot_anchor: torch.Tensor    # [N, L, 2] stiction anchor points, world xy
    feet_air_time: torch.Tensor  # [N, L] seconds
    last_contacts: torch.Tensor  # [N, L] bool
    knee_contact: torch.Tensor   # [N, L] bool (penalised body contact)
    friction: torch.Tensor       # [N] ground friction coefficient
    added_mass: torch.Tensor     # [N]
    terrain_level: torch.Tensor  # [N] int32 curriculum row
    cmd_max_x: torch.Tensor      # [N] command-curriculum |vx| range
    ep_track: torch.Tensor       # [N] episode sum of the tracking reward
    episode_len: torch.Tensor    # [N] int32
    ep_reward: torch.Tensor      # [N]
    walked: torch.Tensor         # [N, 2] xy displacement since spawn
    rng: torch.Tensor            # the step's generator state (utils/rng.py)


class LeggedStepOut(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    time_out: torch.Tensor
    episode_reward: torch.Tensor
    episode_length: torch.Tensor


class RewardCtx(NamedTuple):
    """Per-step quantities the reward primitives read alongside the state."""
    body_vel: torch.Tensor       # [N, 3] base-frame linear velocity
    body_ang: torch.Tensor       # [N, 3] base-frame angular velocity
    base_h: torch.Tensor         # [N] trunk height over local terrain
    actions: torch.Tensor        # [N, nj] this step's actions
    air_reward: torch.Tensor     # [N] precomputed feet_air_time term


class ContactOut(NamedTuple):
    """One substep's contact model: forces, the new anchors, and what its
    two branches decide on: the feet's penetration (in contact where > 0)
    and the Coulomb cap over the tangential force's norm (the cap binds
    where < 1)."""
    force: torch.Tensor          # [N, L, 3] world
    anchor: torch.Tensor         # [N, L, 2]
    pen: torch.Tensor            # [N, L]
    cap_ratio: torch.Tensor      # [N, L]

    @property
    def in_contact(self) -> torch.Tensor:
        return self.pen > 0.0

    @property
    def capped(self) -> torch.Tensor:
        return self.cap_ratio < 1.0


class LeggedRobot:
    """Velocity-tracking legged robot, registered as task 'a1_velocity'.

    obs [N, 9 + 3 + 3*nj (+187 if measure_heights)]: base lin vel (3),
    base ang vel (3), projected gravity (3), commands (3, scaled),
    dof_pos - default (nj), dof_vel (nj), last action (nj).
    actions [N, nj]: joint-target offsets (control.action_scale)."""

    def __init__(self, cfg: LeggedRobotConfig = LeggedRobotConfig(),
                 device: torch.device | str = "cuda"):
        fp32.deterministic_fp32()
        self.cfg = cfg
        self.device = dev = torch.device(device)
        a = cfg.asset
        self.dt = cfg.sim_dt * cfg.control.decimation
        self.max_episode_length = int(round(cfg.max_episode_length_s / self.dt))
        self.num_legs = L = a.num_legs
        self.nj = 3 * L
        self.num_actions = self.nj
        self.obs_dim = 12 + 3 * self.nj + (
            17 * 11 if cfg.terrain.measure_heights else 0)
        self.push_interval = max(
            1, int(round(cfg.domain_rand.push_interval_s / self.dt)))
        self.resample_interval = max(
            1, int(round(cfg.commands.resampling_time_s / self.dt)))

        # leg layout: FL, FR, RL, RR (x forward, y left); bipeds use one
        # left/right pair at the trunk center
        if L == 4:
            sx, sy = [1.0, 1.0, -1.0, -1.0], [1.0, -1.0, 1.0, -1.0]
            hip_def = [a.default_hip_front, a.default_hip_front,
                       a.default_hip_rear, a.default_hip_rear]
        elif L == 2:
            sx, sy = [0.0, 0.0], [1.0, -1.0]
            hip_def = [a.default_hip_front] * 2
        else:
            raise ValueError(f"num_legs must be 2 or 4, got {L}")
        f32 = np.float32
        sx, sy = np.array(sx, f32), np.array(sy, f32)
        self.side = torch.from_numpy(sy).to(dev)                         # [L]
        self.hip_pos = torch.from_numpy(np.stack(
            [sx * f32(a.hip_x), sy * f32(a.hip_y), np.zeros_like(sx)],
            -1)).to(dev)                                                 # [L, 3]
        default_q = np.stack([sy * f32(a.default_abd), np.array(hip_def, f32),
                              np.full(L, a.default_knee, f32)], -1)      # [L, 3]
        self.default_q = torch.from_numpy(default_q).to(dev)
        self.default_q_flat = self.default_q.reshape(-1)
        # abduction limits mirror with leg side (as the URDF mirrors the
        # joint); hip/knee limits are side-symmetric
        q_low = np.tile(np.array(a.q_low, f32), (L, 1))
        q_high = np.tile(np.array(a.q_high, f32), (L, 1))
        q_low[:, 0] = np.where(sy > 0, f32(a.q_low[0]), -f32(a.q_high[0]))
        q_high[:, 0] = np.where(sy > 0, f32(a.q_high[0]), -f32(a.q_low[0]))
        self.q_low_flat = torch.from_numpy(q_low.reshape(-1)).to(dev)
        self.q_high_flat = torch.from_numpy(q_high.reshape(-1)).to(dev)

        # reward registry: nonzero scales -> _reward_<name>, scale x dt
        # (_prepare_reward_function, legged_robot.py:660-691); termination
        # is applied on crash only
        scales = cfg.resolved_reward_scales()
        self.reward_fns = []
        for name, scale in scales.items():
            if scale == 0.0 or name == "termination":
                continue
            self.reward_fns.append(
                (name, scale * self.dt, getattr(self, f"_reward_{name}")))
        self.termination_scale = scales.get("termination", 0.0) * self.dt
        self.tracking_scale = scales.get("tracking_lin_vel", 0.0) * self.dt

        self._inertia = torch.tensor(a.inertia, device=dev)
        self._gravity = torch.tensor([0.0, 0.0, a.gravity], device=dev)
        self._down = torch.tensor([0.0, 0.0, -1.0], device=dev)
        self._forward = torch.tensor([1.0, 0.0, 0.0], device=dev)
        self._cmd_scale = torch.tensor(
            [cfg.obs_scales.lin_vel, cfg.obs_scales.lin_vel,
             cfg.obs_scales.ang_vel], device=dev)

        # spawn height: feet of the default stance at equilibrium contact
        # penetration (unless the asset pins it explicitly), in float32 as
        # the JAX package computes it
        if a.init_height is not None:
            self.stand_height = float(a.init_height)
        else:
            foot, _ = self._feet_and_jac(self.default_q_flat[None])
            pen_eq = a.mass * 9.81 / (L * cfg.contact.k_normal)
            self.stand_height = float(
                -foot[0, :, 2].min() + cfg.contact.foot_radius - pen_eq)

        if cfg.terrain.measure_heights:
            # 1m x 1.6m measurement rectangle (legged_robot_config.py:55-58)
            mx = torch.linspace(-0.8, 0.8, 17)
            my = torch.linspace(-0.5, 0.5, 11)
            gx, gy = torch.meshgrid(mx, my, indexing="ij")
            self.measure_xy = torch.stack(
                [gx.reshape(-1), gy.reshape(-1), torch.zeros(17 * 11)],
                -1).to(dev)                                              # [187, 3]

    # -- terrain ---------------------------------------------------------
    def terrain_hash(self, ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
        """The rough terrain's value at integer cell corners: frac(sin(ix *
        127.1 + iy * 311.7) * 43758.5453)."""
        arg = ix * 127.1 + iy * 311.7
        h = torch.sin(arg) * 43758.5453
        return h - torch.floor(h)

    def terrain_height(self, x: torch.Tensor, y: torch.Tensor,
                       level: torch.Tensor) -> torch.Tensor:
        """Analytic height field h(x, y) per env.  `rough` is bilinear
        value noise (deterministic hash) with amplitude linear in the
        curriculum level (terrain rows, legged_gym/utils/terrain.py:39)."""
        t = self.cfg.terrain
        if t.mesh_type == "plane":
            return torch.zeros_like(x)
        hs = t.horizontal_scale
        amp = fp32.div_const(t.max_amplitude * (level.float() + 1.0),
                             float(t.num_levels))
        gx, gy = fp32.div_const(x, hs), fp32.div_const(y, hs)
        ix, iy = torch.floor(gx), torch.floor(gy)
        fx, fy = gx - ix, gy - iy
        fx = fx * fx * (3.0 - 2.0 * fx)     # smoothstep
        fy = fy * fy * (3.0 - 2.0 * fy)
        h00, h10 = self.terrain_hash(ix, iy), self.terrain_hash(ix + 1.0, iy)
        h01 = self.terrain_hash(ix, iy + 1.0)
        h11 = self.terrain_hash(ix + 1.0, iy + 1.0)
        h = (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
             + h01 * (1 - fx) * fy + h11 * fx * fy)
        return amp * h

    def _ground(self, pts: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
        """Terrain height under world points [N, K, >=2] of env levels
        [N] -> [N, K]."""
        n, k = pts.shape[:2]
        return self.terrain_height(
            pts[..., 0].reshape(-1), pts[..., 1].reshape(-1),
            torch.repeat_interleave(level, k)).reshape(n, k)

    # -- kinematics ------------------------------------------------------
    def _feet_and_jac(self, q: torch.Tensor):
        """[N, nj] -> hip-relative foot positions [N, L, 3] (trunk frame)
        and the foot Jacobians d foot / d q [N, L, 3, 3], in closed form:
        foot = R_x(qa) (x, side l_hip, z) with x = l_t sin qh + l_c
        sin(qh + qk), z = -(l_t cos qh + l_c cos(qh + qk)).
        q_leg = (abduction about x, hip flexion about y, knee about y);
        flexion 0 = straight down, positive = forward swing."""
        a = self.cfg.asset
        qL = q.reshape(q.shape[0], self.num_legs, 3)
        qa, qh, qk = qL.unbind(-1)
        sh, ch = torch.sin(qh), torch.cos(qh)
        shk, chk = torch.sin(qh + qk), torch.cos(qh + qk)
        sa, ca = torch.sin(qa), torch.cos(qa)
        x = a.l_thigh * sh + a.l_calf * shk
        z = -(a.l_thigh * ch + a.l_calf * chk)
        y0 = self.side * a.l_hip
        foot = torch.stack([x, ca * y0 - sa * z, sa * y0 + ca * z], -1)
        zero = torch.zeros_like(x)
        dxk, dzk = a.l_calf * chk, a.l_calf * shk
        # columns: d/dqa, d/dqh (dx = -z, dz = x), d/dqk
        jac = torch.stack([
            torch.stack([zero, -z, dxk], -1),
            torch.stack([-sa * y0 - ca * z, -sa * x, -sa * dzk], -1),
            torch.stack([ca * y0 - sa * z, ca * x, ca * dzk], -1)], -2)
        return foot, jac

    def _knees(self, q: torch.Tensor) -> torch.Tensor:
        """[N, nj] -> hip-relative knee positions [N, L, 3] (trunk frame)."""
        a = self.cfg.asset
        qL = q.reshape(q.shape[0], self.num_legs, 3)
        qa, qh = qL[..., 0], qL[..., 1]
        kx = a.l_thigh * torch.sin(qh)
        kz = -a.l_thigh * torch.cos(qh)
        y0 = self.side * a.l_hip
        sa, ca = torch.sin(qa), torch.cos(qa)
        return torch.stack([kx, ca * y0 - sa * kz, sa * y0 + ca * kz], -1)

    # -- spawn / reset ---------------------------------------------------
    def _uniform(self, g, shape, lo, hi):
        return torch.rand(shape, generator=g, device=self.device) * (hi - lo) + lo

    def _sample_commands(self, g: torch.Generator, n: int,
                         cmd_max_x: torch.Tensor) -> torch.Tensor:
        c = self.cfg.commands
        vx = torch.rand(n, generator=g, device=self.device) * (2.0 * cmd_max_x) \
            - cmd_max_x
        vy = self._uniform(g, (n,), *c.lin_vel_y)
        yaw = self._uniform(g, (n,), *c.ang_vel_yaw)
        heading = self._uniform(g, (n,), *c.heading)
        xy = torch.stack([vx, vy], -1)
        # small commands snap to zero (legged_robot.py:398)
        keep = torch.linalg.vector_norm(xy, dim=1, keepdim=True) > 0.2
        return torch.cat([xy * keep, yaw[:, None], heading[:, None]], -1)

    def _spawn(self, g: torch.Generator, n: int, terrain_level: torch.Tensor,
               cmd_max_x: torch.Tensor) -> dict:
        cfg = self.cfg
        dev = self.device
        dr = cfg.domain_rand
        xy = self._uniform(g, (n, 2), -1.0, 1.0)
        z = self.terrain_height(xy[:, 0], xy[:, 1], terrain_level) \
            + self.stand_height
        pos = torch.cat([xy, z[:, None]], -1)
        yaw = self._uniform(g, (n,), -3.14, 3.14)
        zeros = torch.zeros(n, device=dev)
        quat = um.quat_from_euler_zyx(zeros, zeros, yaw)
        friction = (self._uniform(g, (n,), *dr.friction_range)
                    if dr.randomize_friction
                    else torch.full((n,), cfg.terrain.static_friction, device=dev))
        added = (self._uniform(g, (n,), *dr.added_mass_range)
                 if dr.randomize_base_mass else zeros)
        # dof jitter of 0.8-1.2x around the default stance (_reset_dofs,
        # legged_robot.py:439-449)
        q0 = self.default_q_flat.expand(n, self.nj)
        q0 = torch.clamp(q0 * self._uniform(g, (n, self.nj), 0.8, 1.2),
                         self.q_low_flat, self.q_high_flat)
        L = self.num_legs
        # plant the stiction anchors under the spawned feet
        foot_hip, _ = self._feet_and_jac(q0)
        feet_w = pos[:, None, :] + um.quat_apply(quat[:, None, :],
                                                 self.hip_pos[None] + foot_hip)
        return dict(
            pos=pos, quat=quat, lin_vel=torch.zeros(n, 3, device=dev),
            ang_vel=torch.zeros(n, 3, device=dev), q=q0,
            qd=torch.zeros(n, self.nj, device=dev),
            commands=self._sample_commands(g, n, cmd_max_x),
            last_action=torch.zeros(n, self.nj, device=dev),
            last_qd=torch.zeros(n, self.nj, device=dev),
            torques=torch.zeros(n, self.nj, device=dev),
            contact_forces=torch.zeros(n, L, 3, device=dev),
            foot_anchor=feet_w[..., :2],
            feet_air_time=torch.zeros(n, L, device=dev),
            last_contacts=torch.zeros(n, L, dtype=torch.bool, device=dev),
            knee_contact=torch.zeros(n, L, dtype=torch.bool, device=dev),
            friction=friction, added_mass=added,
            walked=torch.zeros(n, 2, device=dev))

    def reset(self, num_envs: int, rng: torch.Generator):
        """A fresh spawn of every env, drawn from `rng` (a generator on the
        env's device); the state carries a generator forked from it."""
        cfg = self.cfg
        dev = self.device
        if cfg.terrain.curriculum:
            level = torch.randint(0, cfg.terrain.max_init_level + 1,
                                  (num_envs,), generator=rng, device=dev,
                                  dtype=torch.int32)
        else:
            level = torch.zeros(num_envs, dtype=torch.int32, device=dev)
        cmd_max = torch.full((num_envs,), float(
            cfg.commands.lin_vel_x[1] if not cfg.commands.curriculum else 0.5),
            device=dev)
        f = self._spawn(rng, num_envs, level, cmd_max)
        zeros = torch.zeros(num_envs, device=dev)
        state = LeggedState(
            terrain_level=level, cmd_max_x=cmd_max, ep_track=zeros,
            episode_len=torch.zeros(num_envs, dtype=torch.int32, device=dev),
            ep_reward=zeros, rng=rng_lib.fork(rng), **f)
        no = torch.zeros(num_envs, dtype=torch.bool, device=dev)
        return state, self._out(state, zeros, no, no, rng)

    # -- physics ---------------------------------------------------------
    def _pd_torque(self, target, q, qd):
        """_compute_torques (legged_robot.py:414-438)."""
        c = self.cfg.control
        a = self.cfg.asset
        if c.control_type == "T":
            tau = target
        elif c.control_type == "V":
            tau = c.stiffness * (target - qd)
        else:
            tau = c.stiffness * (target - q) - c.damping * qd
        return torch.clamp(tau, -a.torque_limit, a.torque_limit)

    def _contact(self, foot_world, foot_vel, anchor, friction,
                 level) -> ContactOut:
        """Spring-damper normal force + Coulomb-capped anchor-spring
        friction at the feet [N, L, 3] world positions and velocities."""
        a, ct = self.cfg.asset, self.cfg.contact
        ground = self._ground(foot_world, level)
        pen = ground + ct.foot_radius - foot_world[..., 2]
        in_contact = pen > 0.0
        fn = torch.where(
            in_contact,
            torch.clamp(ct.k_normal * pen - ct.d_normal * foot_vel[..., 2],
                        min=0.0),
            0.0)
        fn = torch.clamp(fn, max=ct.max_force_mg * a.mass * 9.81)
        # anchor-spring friction with Coulomb cap (stiction + slide)
        slip = foot_world[..., :2] - anchor
        ft_raw = -ct.k_tangent * slip - ct.d_tangent * foot_vel[..., :2]
        ft_norm = torch.linalg.vector_norm(ft_raw, dim=-1, keepdim=True) + 1e-9
        ft_cap = friction[:, None, None] * fn[..., None]
        ratio = ft_cap / ft_norm
        scale = torch.clamp(ratio, max=1.0)
        ft = torch.where(in_contact[..., None], ft_raw * scale, 0.0)
        # sliding feet drag their anchor to the capped-force position;
        # airborne feet re-plant the anchor under themselves
        capped = scale < 1.0
        slid_anchor = foot_world[..., :2] + fp32.div_const(ft, ct.k_tangent)
        anchor = torch.where(in_contact[..., None],
                             torch.where(capped, slid_anchor, anchor),
                             foot_world[..., :2])
        force = torch.cat([ft, fn[..., None]], -1)
        return ContactOut(force, anchor, pen, ratio[..., 0])

    def _feet_world(self, pos, quat, lin_vel, ang_vel, q, qd):
        """(COM -> foot vectors [N, L, 3] world, foot positions, foot
        velocities v_com + w x r + R (J qd), Jacobians)."""
        n = pos.shape[0]
        q1 = quat[:, None, :]                       # broadcast over legs
        foot_hip, jac = self._feet_and_jac(q)       # [N,L,3], [N,L,3,3]
        r_world = um.quat_apply(q1, self.hip_pos[None] + foot_hip)
        foot_world = pos[:, None, :] + r_world
        v_joint = (jac * qd.reshape(n, self.num_legs, 1, 3)).sum(-1)
        w_world = um.quat_apply(quat, ang_vel)[:, None, :]
        foot_vel = (lin_vel[:, None, :] + um.cross(w_world, r_world)
                    + um.quat_apply(q1, v_joint))
        return r_world, foot_world, foot_vel, jac

    def _substep(self, carry):
        """One sim_dt: PD torques -> contacts -> trunk + joint integration
        (replaces gym.simulate inside the decimation loop,
        legged_robot.py:101-110).  Returns the new carry and (the PD
        torques, the contact forces, the ContactOut)."""
        (pos, quat, lin_vel, ang_vel, q, qd, anchor, target_q, friction,
         added, level) = carry
        a = self.cfg.asset
        dt = self.cfg.sim_dt
        n = pos.shape[0]

        tau_pd = self._pd_torque(target_q, q, qd)
        r_world, foot_world, foot_vel, jac = self._feet_world(
            pos, quat, lin_vel, ang_vel, q, qd)
        contact = self._contact(foot_world, foot_vel, anchor, friction, level)
        f_contact = contact.force

        # trunk wrench
        mass = a.mass + added[:, None]
        acc = f_contact.sum(1) / mass + self._gravity
        tau_world = um.cross(r_world, f_contact).sum(1)
        tau_body = um.quat_apply(um.quat_conjugate(quat), tau_world)
        inertia = self._inertia
        ang_acc = (tau_body - um.cross(ang_vel, ang_vel * inertia)) / inertia

        # joints: PD + reflected contact load J^T F (F in the trunk frame)
        f_local = um.quat_apply(um.quat_conjugate(quat[:, None, :]), f_contact)
        tau_c = (jac * f_local[..., :, None]).sum(-2).reshape(n, self.nj)
        qdd = (tau_pd + tau_c - a.joint_damping * qd) / a.joint_inertia

        # semi-implicit Euler + quaternion exp-map increment
        lin_vel = lin_vel + acc * dt
        ang_vel = ang_vel + ang_acc * dt
        qd = torch.clamp(qd + qdd * dt, -a.dof_vel_limit, a.dof_vel_limit)
        pos = pos + lin_vel * dt
        q = torch.clamp(q + qd * dt, self.q_low_flat, self.q_high_flat)
        half = 0.5 * ang_vel * dt
        dq = torch.cat([half, torch.ones_like(half[:, :1])], -1)
        quat = um.quat_mul(quat, dq)
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)

        carry = (pos, quat, lin_vel, ang_vel, q, qd, contact.anchor, target_q,
                 friction, added, level)
        return carry, (tau_pd, f_contact, contact)

    def _gravity_body(self, quat: torch.Tensor) -> torch.Tensor:
        return um.quat_apply(um.quat_conjugate(quat), self._down.expand(
            quat.shape[0], 3))

    # -- rewards (legged_robot.py:950-1094), each (state, ctx) -> [N] ----
    def _reward_tracking_lin_vel(self, s, ctx):
        err = torch.sum((s.commands[:, :2] - ctx.body_vel[:, :2]) ** 2, -1)
        return torch.exp(-err / self.cfg.tracking_sigma)

    def _reward_tracking_ang_vel(self, s, ctx):
        err = (s.commands[:, 2] - ctx.body_ang[:, 2]) ** 2
        return torch.exp(-err / self.cfg.tracking_sigma)

    def _reward_lin_vel_z(self, s, ctx):
        return ctx.body_vel[:, 2] ** 2

    def _reward_ang_vel_xy(self, s, ctx):
        return torch.sum(ctx.body_ang[:, :2] ** 2, -1)

    def _reward_orientation(self, s, ctx):
        g = self._gravity_body(s.quat)
        return torch.sum(g[:, :2] ** 2, -1)

    def _reward_base_height(self, s, ctx):
        return (ctx.base_h - self.cfg.base_height_target) ** 2

    def _reward_torques(self, s, ctx):
        return torch.sum(s.torques ** 2, -1)

    def _reward_dof_vel(self, s, ctx):
        return torch.sum(s.qd ** 2, -1)

    def _reward_dof_acc(self, s, ctx):
        return torch.sum(((s.last_qd - s.qd) / self.dt) ** 2, -1)

    def _reward_action_rate(self, s, ctx):
        return torch.sum((s.last_action - ctx.actions) ** 2, -1)

    def _reward_collision(self, s, ctx):
        return torch.sum(s.knee_contact.float(), -1)

    def _reward_dof_pos_limits(self, s, ctx):
        lo, hi = self.q_low_flat, self.q_high_flat
        mid, rng = 0.5 * (lo + hi), 0.5 * (hi - lo)
        soft = self.cfg.soft_dof_pos_limit
        out = (torch.clamp(mid - rng * soft - s.q, min=0.0)
               + torch.clamp(s.q - (mid + rng * soft), min=0.0))
        return torch.sum(out, -1)

    def _reward_dof_vel_limits(self, s, ctx):
        a = self.cfg.asset
        return torch.sum(torch.clamp(
            torch.abs(s.qd) - a.dof_vel_limit * self.cfg.soft_dof_vel_limit,
            0.0, 1.0), -1)

    def _reward_torque_limits(self, s, ctx):
        a = self.cfg.asset
        return torch.sum(torch.clamp(
            torch.abs(s.torques) - a.torque_limit * self.cfg.soft_torque_limit,
            min=0.0), -1)

    def _reward_feet_air_time(self, s, ctx):
        return ctx.air_reward

    def _reward_stumble(self, s, ctx):
        f = s.contact_forces
        return torch.any(
            torch.linalg.vector_norm(f[..., :2], dim=-1)
            > 5.0 * torch.abs(f[..., 2]), dim=-1).float()

    def _reward_stand_still(self, s, ctx):
        still = torch.linalg.vector_norm(s.commands[:, :2], dim=1) < 0.1
        return torch.sum(torch.abs(s.q - self.default_q_flat), -1) * still

    def _reward_feet_contact_forces(self, s, ctx):
        return torch.sum(torch.clamp(
            torch.linalg.vector_norm(s.contact_forces, dim=-1)
            - self.cfg.max_contact_force, min=0.0), -1)

    def _reward_energy(self, s, ctx):
        return -torch.abs(torch.sum(s.torques * s.qd, -1))

    def _reward_alive(self, s, ctx):
        return torch.ones(s.pos.shape[0], device=s.pos.device)

    # -- control step ----------------------------------------------------
    def step(self, state: LeggedState, actions: torch.Tensor):
        cfg = self.cfg
        a = cfg.asset
        n = state.pos.shape[0]
        L = self.num_legs
        actions = torch.clamp(actions, -cfg.clip_actions, cfg.clip_actions)
        # P control: target = action_scale * action + default
        # (legged_robot.py:414-432); V/T interpret the scaled action raw
        target = cfg.control.action_scale * actions
        if cfg.control.control_type == "P":
            target = target + self.default_q_flat

        carry = (state.pos, state.quat, state.lin_vel, state.ang_vel,
                 state.q, state.qd, state.foot_anchor, target,
                 state.friction, state.added_mass, state.terrain_level)
        for _ in range(cfg.control.decimation):
            carry, (torques, contact_forces, _) = self._substep(carry)
        # torques and contact_forces are the last substep's
        (pos, quat, lin_vel, ang_vel, q, qd, foot_anchor, _, friction,
         added, level) = carry

        episode_len = state.episode_len + 1
        g = rng_lib.restore(state.rng, self.device)

        # heading-mode yaw command servo (legged_robot.py:367-370)
        commands = state.commands
        if cfg.commands.heading_command:
            fwd = um.quat_apply(quat, self._forward.expand(n, 3))
            heading = torch.atan2(fwd[:, 1], fwd[:, 0])
            yaw_cmd = torch.clamp(
                0.5 * um.wrap_to_pi(commands[:, 3] - heading), -1.0, 1.0)
            commands = torch.cat([commands[:, :2], yaw_cmd[:, None],
                                  commands[:, 3:]], 1)

        # impulse pushes (_push_robots, legged_robot.py:483)
        if cfg.domain_rand.push_robots:
            do_push = (episode_len % self.push_interval == 0)
            push = self._uniform(g, (n, 2), -cfg.domain_rand.max_push_vel_xy,
                                 cfg.domain_rand.max_push_vel_xy)
            lin_vel = torch.cat([
                lin_vel[:, :2] + torch.where(do_push[:, None], push, 0.0),
                lin_vel[:, 2:]], 1)

        # command resampling
        new_cmd = self._sample_commands(g, n, state.cmd_max_x)
        do_res = (episode_len % self.resample_interval == 0)
        commands = torch.where(do_res[:, None], new_cmd, commands)

        # feet air time bookkeeping (legged_robot.py:1034-1047)
        contact = contact_forces[..., 2] > 1.0
        contact_filt = contact | state.last_contacts
        first_contact = (state.feet_air_time > 0.0) & contact_filt
        air = state.feet_air_time + self.dt
        moving = torch.linalg.vector_norm(commands[:, :2], dim=1) > 0.1
        air_reward = torch.sum((air - 0.5) * first_contact, -1) * moving
        feet_air_time = air * (~contact_filt)

        # penalised body contacts: knees below terrain (thigh/calf contact
        # stand-in; penalize_contacts_on=['thigh','calf'], a1_config.py:68)
        knee_world = pos[:, None, :] + um.quat_apply(
            quat[:, None, :], self.hip_pos[None] + self._knees(q))
        knee_contact = knee_world[..., 2] < self._ground(knee_world, level) + 0.01

        walked = state.walked + lin_vel[:, :2] * self.dt

        inter = LeggedState(
            pos=pos, quat=quat, lin_vel=lin_vel, ang_vel=ang_vel, q=q,
            qd=qd, commands=commands, last_action=state.last_action,
            last_qd=state.qd, torques=torques,
            contact_forces=contact_forces, foot_anchor=foot_anchor,
            feet_air_time=feet_air_time,
            last_contacts=contact, knee_contact=knee_contact,
            friction=friction, added_mass=added, terrain_level=level,
            cmd_max_x=state.cmd_max_x, ep_track=state.ep_track,
            episode_len=episode_len, ep_reward=state.ep_reward,
            walked=walked, rng=state.rng)

        body_vel = um.quat_apply(um.quat_conjugate(quat), lin_vel)
        base_h = pos[:, 2] - self.terrain_height(pos[:, 0], pos[:, 1], level)
        ctx = RewardCtx(body_vel=body_vel, body_ang=ang_vel, base_h=base_h,
                        actions=actions, air_reward=air_reward)

        reward = torch.zeros(n, device=self.device)
        track_term = torch.zeros(n, device=self.device)
        for name, scale, fn in self.reward_fns:
            term = scale * fn(inter, ctx)
            reward = reward + term
            if name == "tracking_lin_vel":
                track_term = term

        # termination: trunk contact (base too low over terrain) or extreme
        # tilt (terminate_after_contacts_on=['base'], check_termination,
        # legged_robot.py:160-167)
        grav = self._gravity_body(quat)
        tilt = torch.arccos(torch.clamp(-grav[:, 2], -1.0, 1.0))
        crash = (base_h < a.base_clearance) | (tilt > cfg.termination_tilt)
        time_out = episode_len >= self.max_episode_length
        done = crash | time_out
        reward = reward + crash.float() * self.termination_scale
        if cfg.only_positive_rewards:   # legged_robot_config.py:184
            reward = torch.clamp(reward, min=0.0)

        ep_reward = state.ep_reward + reward
        ep_track = state.ep_track + track_term
        out = self._out(inter._replace(last_action=actions, ep_reward=ep_reward),
                        reward, done, time_out, g)

        # curricula, applied to envs that finished this step
        new_level = level
        if cfg.terrain.curriculum:
            # walked past half a terrain row -> promote; covered less than
            # half the commanded distance -> demote
            # (_update_terrain_curriculum, legged_robot.py:486-509)
            dist = torch.linalg.vector_norm(walked, dim=1)
            cmd_dist = (torch.linalg.vector_norm(commands[:, :2], dim=1)
                        * cfg.max_episode_length_s)
            up = dist > cfg.terrain.terrain_length / 2.0
            down = dist < 0.5 * cmd_dist
            new_level = torch.clamp(
                level + up.int() - (down & ~up).int(),
                0, cfg.terrain.num_levels - 1).to(torch.int32)
        new_cmd_max = state.cmd_max_x
        if cfg.commands.curriculum and self.tracking_scale > 0.0:
            # widen |vx| by 0.5 when the episode's tracking return exceeds
            # 80% of its attainable maximum (update_command_curriculum,
            # legged_robot.py:511-520)
            attainable = self.tracking_scale * self.max_episode_length
            good = ep_track > 0.8 * attainable
            new_cmd_max = torch.clamp(state.cmd_max_x + 0.5 * good, 0.0,
                                      cfg.commands.max_curriculum)

        # auto-reset (masked where-select, the framework-wide pattern)
        reset_level = torch.where(done, new_level, level)
        reset_cmd_max = torch.where(done, new_cmd_max, state.cmd_max_x)
        fresh = self._spawn(g, n, reset_level, reset_cmd_max)

        def mask(new, reset_val):
            return torch.where(done.reshape((n,) + (1,) * (new.ndim - 1)),
                               reset_val, new)

        new_state = LeggedState(
            pos=mask(pos, fresh["pos"]), quat=mask(quat, fresh["quat"]),
            lin_vel=mask(lin_vel, fresh["lin_vel"]),
            ang_vel=mask(ang_vel, fresh["ang_vel"]),
            q=mask(q, fresh["q"]), qd=mask(qd, fresh["qd"]),
            commands=mask(commands, fresh["commands"]),
            last_action=mask(actions, fresh["last_action"]),
            last_qd=mask(qd, fresh["last_qd"]),
            torques=mask(torques, fresh["torques"]),
            contact_forces=mask(contact_forces, fresh["contact_forces"]),
            foot_anchor=mask(foot_anchor, fresh["foot_anchor"]),
            feet_air_time=mask(feet_air_time, fresh["feet_air_time"]),
            last_contacts=mask(contact, fresh["last_contacts"]),
            knee_contact=mask(knee_contact, fresh["knee_contact"]),
            friction=mask(friction, fresh["friction"]),
            added_mass=mask(added, fresh["added_mass"]),
            terrain_level=reset_level,
            cmd_max_x=reset_cmd_max,
            ep_track=torch.where(done, 0.0, ep_track),
            episode_len=torch.where(done, 0, episode_len),
            ep_reward=torch.where(done, 0.0, ep_reward),
            walked=mask(walked, fresh["walked"]),
            rng=g.get_state())
        return new_state, out

    def _out(self, s: LeggedState, reward, done, time_out,
             g: Optional[torch.Generator]) -> LeggedStepOut:
        cfg = self.cfg
        sc = cfg.obs_scales
        nz = cfg.obs_noise
        body_vel = um.quat_apply(um.quat_conjugate(s.quat), s.lin_vel)
        parts = [body_vel * sc.lin_vel,
                 s.ang_vel * sc.ang_vel,
                 self._gravity_body(s.quat),
                 s.commands[:, :3] * self._cmd_scale,
                 (s.q - self.default_q_flat) * sc.dof_pos,
                 s.qd * sc.dof_vel,
                 s.last_action]
        noise_scales = [nz.lin_vel * sc.lin_vel, nz.ang_vel * sc.ang_vel,
                        nz.gravity, 0.0, nz.dof_pos * sc.dof_pos,
                        nz.dof_vel * sc.dof_vel, 0.0]
        if cfg.terrain.measure_heights:
            # 187 heights around the base, yaw-aligned (legged_robot.py:
            # 546,601-612): clip(z - 0.5 - h, -1, 1) x scale
            n = s.pos.shape[0]
            pts = um.quat_apply_yaw(s.quat[:, None, :],
                                    self.measure_xy[None].expand(n, -1, 3))
            pts = pts + torch.cat([s.pos[:, None, :2],
                                   torch.zeros_like(s.pos[:, None, :1])], -1)
            h = self._ground(pts, s.terrain_level)
            parts.append(torch.clamp(s.pos[:, None, 2] - 0.5 - h, -1.0, 1.0)
                         * sc.height_measurements)
            noise_scales.append(nz.height_measurements * sc.height_measurements)
        obs = torch.cat(parts, -1)
        if nz.add_noise:
            vec = torch.cat([
                torch.full((p.shape[-1],), ns * nz.noise_level, device=self.device)
                for p, ns in zip(parts, noise_scales)])
            obs = obs + vec * self._uniform(g, obs.shape, -1.0, 1.0)
        obs = torch.clamp(obs, -cfg.clip_observations, cfg.clip_observations)
        return LeggedStepOut(obs=obs, reward=reward, done=done,
                             time_out=time_out, episode_reward=s.ep_reward,
                             episode_length=s.episode_len.float())


# ----------------------------------------------------------------------
# Robot zoo (legged_gym/env/{a1,anymal_b,anymal_c,cassie}/*_config.py)
def a1_config(**kw) -> LeggedRobotConfig:
    """Unitree A1 (a1_config.py) -- the GenNBV config chain's inheritance
    root (gennbv/env/config_legged.py:5)."""
    return LeggedRobotConfig(**kw)


def anymal_c_config(**kw) -> LeggedRobotConfig:
    """ANYmal C (anymal_c/*_config.py): 50 kg, longer legs, stronger
    actuators, stiffer PD."""
    asset = LeggedAsset(
        mass=50.0, inertia=(0.65, 1.5, 1.6),
        hip_x=0.3, hip_y=0.104, l_hip=0.11, l_thigh=0.285, l_calf=0.33,
        joint_inertia=0.12, torque_limit=80.0, dof_vel_limit=8.5,
        default_abd=0.0, default_hip_front=0.4, default_hip_rear=-0.4,
        default_knee=-0.8, base_clearance=0.25,
        q_low=(-0.6, -1.6, -2.6), q_high=(0.6, 1.6, -0.1))
    control = LeggedControl(stiffness=80.0, damping=2.0, action_scale=0.5)
    contact = LeggedContact(k_normal=10000.0, d_normal=900.0,
                            k_tangent=900.0)
    return LeggedRobotConfig(asset=asset, control=control, contact=contact,
                             base_height_target=0.5, **kw)


def anymal_b_config(**kw) -> LeggedRobotConfig:
    """ANYmal B (anymal_b_config.py): the C model at the B generation's
    mass."""
    cfg = anymal_c_config(**kw)
    return dataclasses.replace(
        cfg, asset=dataclasses.replace(cfg.asset, mass=40.0))


def cassie_config(**kw) -> LeggedRobotConfig:
    """Agility Cassie (cassie/cassie_config.py): the biped instantiation --
    2 legs, taller stance, heavier per-leg actuation."""
    asset = LeggedAsset(
        mass=33.0, inertia=(0.8, 0.9, 0.4), num_legs=2,
        hip_x=0.0, hip_y=0.13, l_hip=0.07, l_thigh=0.5, l_calf=0.45,
        joint_inertia=0.2, torque_limit=112.0, dof_vel_limit=12.0,
        default_abd=0.0, default_hip_front=0.4, default_hip_rear=0.4,
        default_knee=-0.8, base_clearance=0.3,
        q_low=(-0.4, -1.2, -2.2), q_high=(0.4, 1.4, -0.2))
    control = LeggedControl(stiffness=100.0, damping=3.0, action_scale=0.5)
    contact = LeggedContact(k_normal=8000.0, d_normal=700.0,
                            k_tangent=700.0)
    return LeggedRobotConfig(asset=asset, control=control, contact=contact,
                             base_height_target=0.85,
                             termination_tilt=0.8, **kw)


ZOO = {"a1": a1_config, "anymal_b": anymal_b_config,
       "anymal_c": anymal_c_config, "cassie": cassie_config}
