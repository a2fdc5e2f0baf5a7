"""Physics drone: the re-creation of the legged_gym robot layer (port of
``gennbv_tpu/env/drone_robot.py``).

The reference's `DroneRobot` (legged_gym/env/base/drone_robot.py:49) is a
torque-controlled robot env on Isaac Gym: PD control under decimation
(`step`/`_compute_torques`, drone_robot.py:91-117,414-438), a reward
registry that resolves `_reward_<name>` methods for every nonzero scale and
multiplies each scale by dt at prep time (`_prepare_reward_function`,
drone_robot.py:660-691, `_parse_cfg`:874-884), randomized resets
(`_reset_root_states`:456 -- base vel in +-0.5, xy jitter), impulse pushes
(`_push_robots`:483), command resampling (`_resample_commands`:388), obs
noise (`_get_noise_scale_vec`:532) and mass domain randomization
(`_process_rigid_body_props`:352).  Here it is a live, standalone
velocity-tracking task.

The drone is a real quadrotor: per-rotor first-order speed dynamics,
thrust/drag-torque X-mixing and quaternion rigid-body integration, stepped
`decimation` times per control step.  Every op carries the env axis, on
the env's device; the step is a function of (state, actions), its random
draws coming from the generator state the DroneState carries
(``utils/rng.py``).  It satisfies the env contract of
``utils/env_checker.py``, so ``algo/on_policy_runner.py`` drives it.

Constants computed in Python (``hover_rotor``, the arm ``L``) enter the
float32 arithmetic as float32 numbers, as JAX's weakly typed constants do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gennbv_tpu_torch.ops import fp32
from gennbv_tpu_torch.utils import math as um
from gennbv_tpu_torch.utils import rng as rng_lib


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DroneAsset:
    """Quadrotor physical constants (crazyflie-2-like scale; the reference
    loads resources/robots/drone/cf2x.urdf, config_gennbv_train.py:38)."""
    mass: float = 0.027                 # kg
    inertia: Tuple[float, float, float] = (1.4e-5, 1.4e-5, 2.17e-5)  # kg m^2
    arm_length: float = 0.0397          # m (rotor to center, X config)
    # thrust/drag coefficients in rad/s units, sized so max collective
    # thrust ~= 2.3x weight (hover at ~1734 rad/s, 67% of rotor_max)
    k_thrust: float = 2.2e-8            # N / (rad/s)^2 per rotor
    k_torque: float = 5.5e-10           # N m / (rad/s)^2 (yaw drag, ~2.5% kf)
    rotor_max: float = 2600.0           # rad/s
    rotor_tau: float = 0.017            # s, first-order rotor time constant
    drag: float = 9.2e-7                # N / (m/s) linear body drag
    gravity: float = -9.81

    @property
    def hover_rotor(self) -> float:
        """Rotor speed at hover: 4 k w^2 = m g."""
        return float((self.mass * -self.gravity / (4 * self.k_thrust)) ** 0.5)


@dataclasses.dataclass(frozen=True)
class DroneControl:
    """PD control config (legged_robot_config control section; control
    types at drone_robot.py:414-438)."""
    control_type: str = "V"        # "P" rotor-pos | "V" rotor-speed | "T" raw
    action_scale: float = 0.35     # fraction of rotor_max per unit action
    decimation: int = 4            # physics substeps per control step
    stiffness: float = 8.0         # p gain
    damping: float = 0.15          # d gain


@dataclasses.dataclass(frozen=True)
class DroneDomainRand:
    """drone_robot.py:299-383,483."""
    randomize_mass: bool = True
    added_mass_range: Tuple[float, float] = (-0.005, 0.005)   # kg
    push_robots: bool = True
    push_interval_s: float = 7.0
    max_push_vel_xy: float = 0.5


@dataclasses.dataclass(frozen=True)
class DroneCommands:
    """Velocity-command curriculum ranges (_resample_commands,
    drone_robot.py:388-413): [vx, vy, vz, yaw_rate]."""
    resampling_time_s: float = 5.0
    lin_vel_xy: Tuple[float, float] = (-1.0, 1.0)
    lin_vel_z: Tuple[float, float] = (-0.5, 0.5)
    ang_vel_yaw: Tuple[float, float] = (-1.0, 1.0)
    min_norm: float = 0.2          # small commands snap to zero (:412)


@dataclasses.dataclass(frozen=True)
class DroneRobotConfig:
    sim_dt: float = 0.005
    max_episode_length_s: float = 20.0
    clip_actions: float = 100.0    # normalization section defaults
    clip_observations: float = 100.0
    # reward scales: nonzero entries are resolved to _reward_<name> methods
    # and multiplied by the CONTROL dt at prep (drone_robot.py:874-884)
    reward_scales: Optional[Dict[str, float]] = None
    only_positive_rewards: bool = False
    tracking_sigma: float = 0.25
    termination_tilt: float = 1.2  # rad: crash when |tilt| exceeds
    ground_z: float = 0.0
    init_height: float = 1.0
    obs_noise: float = 0.0         # uniform noise amplitude on obs
    asset: DroneAsset = dataclasses.field(default_factory=DroneAsset)
    control: DroneControl = dataclasses.field(default_factory=DroneControl)
    domain_rand: DroneDomainRand = dataclasses.field(
        default_factory=DroneDomainRand)
    commands: DroneCommands = dataclasses.field(default_factory=DroneCommands)

    def resolved_reward_scales(self) -> Dict[str, float]:
        if self.reward_scales is not None:
            return dict(self.reward_scales)
        return {
            "tracking_lin_vel": 1.5,
            "tracking_ang_vel": 0.5,
            "orientation": -2.0,
            "ang_vel_xy": -0.05,
            "action_rate": -0.01,
            "torques": -1e-4,
            "termination": -5.0,
            "alive": 0.05,
        }


class DroneState(NamedTuple):
    pos: torch.Tensor          # [N, 3]
    quat: torch.Tensor         # [N, 4] (x, y, z, w) -- Isaac convention
    lin_vel: torch.Tensor      # [N, 3] world
    ang_vel: torch.Tensor      # [N, 3] body
    rotor_vel: torch.Tensor    # [N, 4]
    commands: torch.Tensor     # [N, 4] vx, vy, vz, yaw_rate
    last_action: torch.Tensor  # [N, 4]
    last_torque: torch.Tensor  # [N, 4] rotor drive torques (for _reward_torques)
    added_mass: torch.Tensor   # [N] domain-rand mass offset
    episode_len: torch.Tensor  # [N] int32
    ep_reward: torch.Tensor    # [N]
    rng: torch.Tensor          # the step's generator state (utils/rng.py)


class DroneStepOut(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    time_out: torch.Tensor
    episode_reward: torch.Tensor
    episode_length: torch.Tensor


class DroneRobot:
    """Velocity-tracking quadrotor, registered as task 'drone_velocity'.

    obs [N, 17]: body lin vel (3), body ang vel (3), projected gravity (3),
    commands (4), last action (4).  actions [N, 4] in [-clip, clip]."""

    def __init__(self, cfg: DroneRobotConfig = DroneRobotConfig(),
                 device: torch.device | str = "cuda"):
        fp32.deterministic_fp32()
        self.cfg = cfg
        self.device = torch.device(device)
        self.dt = cfg.sim_dt * cfg.control.decimation
        self.max_episode_length = int(round(cfg.max_episode_length_s / self.dt))
        self.num_actions = 4
        self.obs_dim = 17
        self.push_interval = max(
            1, int(round(cfg.domain_rand.push_interval_s / self.dt)))
        self.resample_interval = max(
            1, int(round(cfg.commands.resampling_time_s / self.dt)))
        # reward registry: nonzero scales -> bound methods, scale x dt
        # (_prepare_reward_function, drone_robot.py:660-691)
        self.reward_fns = []
        for name, scale in cfg.resolved_reward_scales().items():
            if scale == 0.0:
                continue
            if name == "termination":   # applied on crash, not per step
                continue
            self.reward_fns.append(
                (name, scale * self.dt, getattr(self, f"_reward_{name}")))
        self.termination_scale = (
            cfg.resolved_reward_scales().get("termination", 0.0) * self.dt)
        a = cfg.asset
        # the JAX module's jnp.sqrt(2.0) is a float32 square root
        self._arm = fp32.f32(fp32.f32(a.arm_length) / fp32.f32(math.sqrt(2.0)))
        self._inertia = torch.tensor(a.inertia, device=self.device)
        self._gravity = torch.tensor([0.0, 0.0, a.gravity], device=self.device)
        self._up = torch.tensor([0.0, 0.0, 1.0], device=self.device)
        self._down = torch.tensor([0.0, 0.0, -1.0], device=self.device)
        self._identity = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device)

    # -- spawn / reset --------------------------------------------------
    def _uniform(self, g, shape, lo, hi):
        return torch.rand(shape, generator=g, device=self.device) * (hi - lo) + lo

    def _sample_commands(self, g: torch.Generator, n: int) -> torch.Tensor:
        c = self.cfg.commands
        xy = self._uniform(g, (n, 2), *c.lin_vel_xy)
        z = self._uniform(g, (n, 1), *c.lin_vel_z)
        yaw = self._uniform(g, (n, 1), *c.ang_vel_yaw)
        # small commands snap to zero (drone_robot.py:412)
        keep = torch.linalg.vector_norm(xy, dim=1, keepdim=True) > c.min_norm
        return torch.cat([xy * keep, z, yaw], dim=1)

    def _spawn(self, g: torch.Generator, n: int) -> dict:
        cfg = self.cfg
        dev = self.device
        # xy jitter within 1 m, vel in +-0.5 (_reset_root_states:456-480)
        xy = self._uniform(g, (n, 2), -1.0, 1.0)
        pos = torch.cat([xy, torch.full((n, 1), cfg.init_height, device=dev)], 1)
        vel = self._uniform(g, (n, 6), -0.5, 0.5)
        dr = cfg.domain_rand
        added = (self._uniform(g, (n,), *dr.added_mass_range)
                 if dr.randomize_mass else torch.zeros(n, device=dev))
        return dict(
            pos=pos, quat=self._identity.expand(n, 4).clone(),
            lin_vel=vel[:, :3], ang_vel=vel[:, 3:],
            rotor_vel=torch.full((n, 4), cfg.asset.hover_rotor, device=dev),
            commands=self._sample_commands(g, n),
            last_action=torch.zeros(n, 4, device=dev),
            last_torque=torch.zeros(n, 4, device=dev),
            added_mass=added)

    def reset(self, num_envs: int, rng: torch.Generator):
        """A fresh spawn of every env, drawn from `rng` (a generator on the
        env's device); the state carries a generator forked from it."""
        f = self._spawn(rng, num_envs)
        state = DroneState(
            episode_len=torch.zeros(num_envs, dtype=torch.int32,
                                    device=self.device),
            ep_reward=torch.zeros(num_envs, device=self.device),
            rng=rng_lib.fork(rng), **f)
        zeros = torch.zeros(num_envs, device=self.device)
        no = torch.zeros(num_envs, dtype=torch.bool, device=self.device)
        return state, self._out(state, zeros, no, no, rng)

    # -- physics --------------------------------------------------------
    def _rotor_target(self, actions):
        a = self.cfg.asset
        c = self.cfg.control
        return torch.clamp(a.hover_rotor + actions * c.action_scale * a.rotor_max,
                           0.0, a.rotor_max)

    def _substep(self, carry):
        """One sim_dt of quadrotor dynamics (replaces gym.simulate in the
        decimation loop, drone_robot.py:101-110); returns the new carry
        and the rotor drive (the torque proxy)."""
        pos, quat, lin_vel, ang_vel, rotor, target, added = carry
        cfg = self.cfg
        a = cfg.asset
        dt = cfg.sim_dt

        # rotor first-order dynamics toward the PD target (control types
        # P/V collapse to a speed servo on a rotor; T drives speed
        # directly).  `drive` is the applied speed increment; its
        # rotor_max-normalized form is the torque proxy _reward_torques
        # penalizes (drone_robot.py:982-985)
        drive = (target - rotor) / a.rotor_tau * dt
        rotor = torch.clamp(rotor + drive, 0.0, a.rotor_max)

        # X-config mixing: rotors at +-45 deg; signs (ccw, cw, ccw, cw)
        f = a.k_thrust * rotor ** 2                       # [N, 4]
        thrust = f.sum(-1)
        L = self._arm
        tau_x = L * (f[:, 0] + f[:, 3] - f[:, 1] - f[:, 2])
        tau_y = L * (f[:, 2] + f[:, 3] - f[:, 0] - f[:, 1])
        tau_z = a.k_torque * (rotor[:, 0] ** 2 - rotor[:, 1] ** 2
                              + rotor[:, 2] ** 2 - rotor[:, 3] ** 2)
        tau = torch.stack([tau_x, tau_y, tau_z], -1)      # body frame

        mass = a.mass + added[:, None]
        body_z = um.quat_apply(quat, self._up.expand_as(pos))
        acc = (thrust[:, None] * body_z - a.drag * lin_vel) / mass
        acc = acc + self._gravity

        inertia = self._inertia
        ang_acc = (tau - um.cross(ang_vel, ang_vel * inertia)) / inertia

        # semi-implicit Euler + quaternion exp-map increment
        lin_vel = lin_vel + acc * dt
        ang_vel = ang_vel + ang_acc * dt
        pos = pos + lin_vel * dt
        half = 0.5 * ang_vel * dt
        dq = torch.cat([half, torch.ones_like(half[:, :1])], -1)
        quat = um.quat_mul(quat, dq)
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
        return (pos, quat, lin_vel, ang_vel, rotor, target, added), \
            drive / a.rotor_max

    def _gravity_body(self, s: DroneState) -> torch.Tensor:
        return um.quat_apply(um.quat_conjugate(s.quat),
                             self._down.expand_as(s.pos))

    # -- rewards (drone_robot.py:965-1094 -- the drone-relevant subset).
    # Each takes (state, body_vel, body_ang_vel, rotor_drive, actions)
    def _reward_tracking_lin_vel(self, s, body_vel, body_ang, drive, act):
        err = torch.sum((s.commands[:, :3] - body_vel) ** 2, -1)
        return torch.exp(-err / self.cfg.tracking_sigma)

    def _reward_tracking_ang_vel(self, s, body_vel, body_ang, drive, act):
        err = (s.commands[:, 3] - body_ang[:, 2]) ** 2
        return torch.exp(-err / self.cfg.tracking_sigma)

    def _reward_orientation(self, s, body_vel, body_ang, drive, act):
        g = self._gravity_body(s)
        return torch.sum(g[:, :2] ** 2, -1)

    def _reward_ang_vel_xy(self, s, body_vel, body_ang, drive, act):
        return torch.sum(body_ang[:, :2] ** 2, -1)

    def _reward_action_rate(self, s, body_vel, body_ang, drive, act):
        return torch.sum((s.last_action - act) ** 2, -1)

    def _reward_torques(self, s, body_vel, body_ang, drive, act):
        return torch.sum(drive ** 2, -1)

    def _reward_alive(self, s, body_vel, body_ang, drive, act):
        return torch.ones(s.pos.shape[0], device=s.pos.device)

    # -- control step ---------------------------------------------------
    def step(self, state: DroneState, actions: torch.Tensor):
        cfg = self.cfg
        n = state.pos.shape[0]
        actions = torch.clamp(actions, -cfg.clip_actions, cfg.clip_actions)
        target = self._rotor_target(actions)

        carry = (state.pos, state.quat, state.lin_vel, state.ang_vel,
                 state.rotor_vel, target, state.added_mass)
        for _ in range(cfg.control.decimation):
            carry, torque = self._substep(carry)
        pos, quat, lin_vel, ang_vel, rotor, _, added = carry

        episode_len = state.episode_len + 1
        g = rng_lib.restore(state.rng, self.device)

        # impulse pushes (_push_robots:483): overwrite xy vel periodically
        if cfg.domain_rand.push_robots:
            do_push = (episode_len % self.push_interval == 0)
            push = self._uniform(g, (n, 2), -cfg.domain_rand.max_push_vel_xy,
                                 cfg.domain_rand.max_push_vel_xy)
            lin_vel = torch.cat([
                torch.where(do_push[:, None], push, lin_vel[:, :2]),
                lin_vel[:, 2:]], 1)

        # command resampling (_resample_commands cadence, :380-386)
        new_cmd = self._sample_commands(g, n)
        do_res = (episode_len % self.resample_interval == 0)
        commands = torch.where(do_res[:, None], new_cmd, state.commands)

        inter = DroneState(pos, quat, lin_vel, ang_vel, rotor, commands,
                           state.last_action, torque, added, episode_len,
                           state.ep_reward, state.rng)

        body_vel = um.quat_apply(um.quat_conjugate(quat), lin_vel)
        body_ang = ang_vel

        reward = torch.zeros(n, device=self.device)
        for _, scale, fn in self.reward_fns:
            reward = reward + scale * fn(inter, body_vel, body_ang, torque,
                                         actions)

        # termination: crash = ground strike or extreme tilt
        grav = self._gravity_body(inter)
        tilt = torch.arccos(torch.clamp(-grav[:, 2], -1.0, 1.0))
        crash = (pos[:, 2] <= cfg.ground_z) | (tilt > cfg.termination_tilt)
        time_out = episode_len >= self.max_episode_length
        done = crash | time_out
        reward = reward + crash.float() * self.termination_scale
        if cfg.only_positive_rewards:   # legged_robot.py clip semantics
            reward = torch.clamp(reward, min=0.0)

        ep_reward = state.ep_reward + reward
        out = self._out(inter._replace(last_action=actions, ep_reward=ep_reward),
                        reward, done, time_out, g)

        # auto-reset
        fresh = self._spawn(g, n)

        def mask(new, reset_val):
            return torch.where(done.reshape((n,) + (1,) * (new.ndim - 1)),
                               reset_val, new)

        new_state = DroneState(
            pos=mask(pos, fresh["pos"]), quat=mask(quat, fresh["quat"]),
            lin_vel=mask(lin_vel, fresh["lin_vel"]),
            ang_vel=mask(ang_vel, fresh["ang_vel"]),
            rotor_vel=mask(rotor, fresh["rotor_vel"]),
            commands=mask(commands, fresh["commands"]),
            last_action=mask(actions, fresh["last_action"]),
            last_torque=mask(torque, fresh["last_torque"]),
            added_mass=mask(added, fresh["added_mass"]),
            episode_len=torch.where(done, 0, episode_len),
            ep_reward=torch.where(done, 0.0, ep_reward),
            rng=g.get_state(),
        )
        return new_state, out

    def _out(self, s: DroneState, reward, done, time_out,
             g: torch.Generator) -> DroneStepOut:
        body_vel = um.quat_apply(um.quat_conjugate(s.quat), s.lin_vel)
        grav = self._gravity_body(s)
        obs = torch.cat([body_vel, s.ang_vel, grav, s.commands, s.last_action],
                        -1)
        if self.cfg.obs_noise > 0.0:   # noise vector (_get_noise_scale_vec)
            obs = obs + self._uniform(g, obs.shape, -self.cfg.obs_noise,
                                      self.cfg.obs_noise)
        obs = torch.clamp(obs, -self.cfg.clip_observations,
                          self.cfg.clip_observations)
        return DroneStepOut(obs=obs, reward=reward, done=done,
                            time_out=time_out, episode_reward=s.ep_reward,
                            episode_length=s.episode_len.float())
