"""The port's legged robot (``gennbv_tpu_torch/env/legged_robot.py``) against
the JAX package's on the same numpy inputs: the robot zoo and the
constructor's constants, the forward kinematics and foot Jacobian, one
substep with its contact branches, every reward term, termination and the
observation, eight whole control steps for all four robots, and the rough
terrain's hash and heights under the circular bound; the random parts
held to their ranges; then the tests of tests/test_legged_robot.py on the
port alone."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import registry as jax_registry
from gennbv_tpu.env import legged_robot as J
from gennbv_tpu.utils import math as jax_math
from gennbv_tpu_torch import registry
from gennbv_tpu_torch.env import legged_robot as P
from gennbv_tpu_torch.env.legged_robot import (LeggedCommands,
                                               LeggedDomainRand, LeggedRobot,
                                               LeggedRobotConfig, LeggedState,
                                               LeggedTerrain)
from gennbv_tpu_torch.utils.env_checker import check_env

ROBOTS = ("a1", "anymal_b", "anymal_c", "cassie")
N = 64
# Kinematics, rewards and the observation: float32 formulas of values of
# magnitude <= ~10 evaluated in another order (XLA fuses the JAX side into
# FMAs, and differentiates the FK where the port has its closed form): a
# few ulps.
HELPER_ATOL = 2e-6
# One substep (sim_dt 2.5 ms) from the same carry: the drone's step
# tolerance (tests/test_torch_drone.py), elementwise, 1e-5 relative and
# absolute; contact forces are differences k pen - d v of terms of the
# robot's weight per foot (up to ~500 N), so they are held to 1e-5 of the
# robot's weight.
SUB_RTOL, SUB_ATOL = 1e-5, 1e-5
# One control step of 8 substeps from the same state.  The explicit
# penalty contacts are stiff (k_normal up to 1e4 N/m through J^T F into
# joints of 0.035-0.2 kg m^2; the ANYmal joints sit on their velocity
# clamp), so an ulp in one substep grows ~40-fold at a touch-down within
# the step (measured on the four robots: 9e-6 to 3.7e-4 of each field's
# largest value after a step).  The JAX env itself, with one ulp of its
# joint velocities changed, moves by up to 1e-2 of a field's scale over 8
# free-running steps, so 8 steps are compared step by step from the JAX
# trajectory's own states: every field of every step within 1e-3 of the
# field's largest magnitude (at least 1), and the contact, knee and done
# masks equal.
STEP_SCALE_TOL = 1e-3
K_STEPS = 8
# The rough terrain's hash frac(s * 43758.5453): torch.sin and XLA's sine
# differ by at most one ulp of s (<= 2^-24 for |s| < 1), which the gain
# turns into <= 2.6e-3, and each side rounds the product (|h| < 2^16,
# ulp 2^-8) once: the two hashes lie within 2^-7 of each other on the
# circle of [0, 1).  A height is a convex blend of four hashes times amp.
HASH_BOUND = 2.0 ** -7


def _t(x):
    return torch.from_numpy(np.array(x))


def _quiet(mod, robot="a1", **kw):
    """No pushes or friction randomization: deterministic physics."""
    make = getattr(mod, f"{robot}_config")
    return make(domain_rand=mod.LeggedDomainRand(randomize_friction=False,
                                                 push_robots=False), **kw)


def _pair(robot="a1", jax_kw=None, port_kw=None):
    return (J.LeggedRobot(_quiet(J, robot, **(jax_kw or {}))),
            LeggedRobot(_quiet(P, robot, **(port_kw or {})), device="cpu"))


def _arrays(jenv, n, seed):
    """A standing robot state near the default stance over flat ground:
    small tilts, joints within 10% of their defaults, small velocities,
    anchors a few mm from the feet (some feet sticking, some sliding),
    episodes far from their time-out and command resampling."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    L, nj = jenv.num_legs, jenv.nj
    euler = rng.uniform(-0.1, 0.1, (n, 3)).astype(f32)
    quat = np.asarray(jax_math.quat_from_euler_zyx(*euler.T)).astype(f32)
    q = (np.asarray(jenv.default_q).reshape(-1)[None]
         * rng.uniform(0.9, 1.1, (n, nj))).astype(f32)
    q = np.clip(q, np.asarray(jenv.q_low_flat), np.asarray(jenv.q_high_flat))
    pos = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                          jenv.stand_height + rng.uniform(-0.01, 0.01, (n, 1))],
                         1).astype(f32)
    foot, _ = jenv._feet_and_jac(jnp.asarray(q))
    feet = np.asarray(pos[:, None, :] + jax_math.quat_apply(
        quat[:, None, :], jenv.hip_pos[None] + foot))
    return dict(
        pos=pos, quat=quat, lin_vel=rng.uniform(-0.2, 0.2, (n, 3)).astype(f32),
        ang_vel=rng.uniform(-0.2, 0.2, (n, 3)).astype(f32), q=q,
        qd=rng.uniform(-0.5, 0.5, (n, nj)).astype(f32),
        commands=rng.uniform(-1, 1, (n, 4)).astype(f32),
        last_action=rng.uniform(-0.2, 0.2, (n, nj)).astype(f32),
        last_qd=rng.uniform(-0.5, 0.5, (n, nj)).astype(f32),
        torques=rng.uniform(-5, 5, (n, nj)).astype(f32),
        contact_forces=rng.uniform(0, 30, (n, L, 3)).astype(f32),
        foot_anchor=(feet[..., :2]
                     + rng.uniform(-0.003, 0.003, (n, L, 2))).astype(f32),
        feet_air_time=rng.uniform(0, 0.3, (n, L)).astype(f32),
        last_contacts=rng.random((n, L)) < 0.5,
        knee_contact=rng.random((n, L)) < 0.2,
        friction=rng.uniform(0.5, 1.25, n).astype(f32),
        added_mass=np.zeros(n, f32),
        terrain_level=np.zeros(n, np.int32), cmd_max_x=np.ones(n, f32),
        ep_track=rng.uniform(0, 1, n).astype(f32),
        episode_len=rng.integers(0, 20, n).astype(np.int32),
        ep_reward=rng.normal(size=n).astype(f32),
        walked=rng.uniform(-1, 1, (n, 2)).astype(f32))


def _jax_state(arrays, key=0):
    return J.LeggedState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                         rng=jax.random.PRNGKey(key))


def _port_state(arrays):
    return LeggedState(**{k: _t(v) for k, v in arrays.items()},
                       rng=torch.Generator().manual_seed(0).get_state())


def _from_jax(js):
    return _port_state({f: np.asarray(getattr(js, f))
                        for f in J.LeggedState._fields if f != "rng"})


def _close(got, want, msg, rtol=SUB_RTOL, atol=SUB_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _scale_close(got, want, msg):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = STEP_SCALE_TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{msg}: max abs error {err} > {tol}"


# ---------------------------------------------------------------------------
# the zoo and the constructor's constants


@pytest.mark.parametrize("robot", ROBOTS)
def test_zoo_fields_and_constants(robot):
    for mh in (False, True):
        kw = dict(terrain=J.LeggedTerrain(measure_heights=mh))
        jcfg = getattr(J, f"{robot}_config")(**kw)
        pcfg = getattr(P, f"{robot}_config")(
            terrain=LeggedTerrain(measure_heights=mh))
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
        assert pcfg.resolved_reward_scales() == jcfg.resolved_reward_scales()
        jenv, penv = J.LeggedRobot(jcfg), LeggedRobot(pcfg, device="cpu")
        for name in ("dt", "max_episode_length", "num_legs", "nj",
                     "num_actions", "obs_dim", "push_interval",
                     "resample_interval", "termination_scale",
                     "tracking_scale"):
            assert getattr(penv, name) == getattr(jenv, name), name
        assert [(n, s) for n, s, _ in penv.reward_fns] == \
            [(n, s) for n, s, _ in jenv.reward_fns]
        for name in ("side", "hip_pos", "default_q", "q_low_flat",
                     "q_high_flat"):
            np.testing.assert_array_equal(getattr(penv, name).numpy(),
                                          np.asarray(getattr(jenv, name)),
                                          err_msg=name)
        # the FK stance's lowest foot, in float32 on both sides: an ulp
        assert abs(penv.stand_height - jenv.stand_height) <= 6e-8 * 2
        if mh:
            np.testing.assert_allclose(penv.measure_xy.numpy(),
                                       np.asarray(jenv.measure_xy), rtol=0,
                                       atol=1e-7)
    assert set(P.ZOO) == set(ROBOTS)


# ---------------------------------------------------------------------------
# kinematics


@pytest.mark.parametrize("robot", ROBOTS)
def test_fk_and_jacobian_match_jax(robot):
    """The closed-form foot Jacobian against jax.jacfwd of the JAX FK, over
    joint angles spread across each robot's limits."""
    jenv, penv = _pair(robot)
    rng = np.random.default_rng(0)
    lo, hi = np.asarray(jenv.q_low_flat), np.asarray(jenv.q_high_flat)
    q = rng.uniform(lo, hi, (256, jenv.nj)).astype(np.float32)
    jfoot, jjac = jax.jit(jenv._feet_and_jac)(jnp.asarray(q))
    pfoot, pjac = penv._feet_and_jac(_t(q))
    _close(pfoot, jfoot, "feet", 0, HELPER_ATOL)
    _close(pjac, jjac, "jacobian", 0, HELPER_ATOL)
    qL = jnp.asarray(q).reshape(256, jenv.num_legs, 3)
    jknee = jax.jit(jax.vmap(jax.vmap(jenv._knee_local, in_axes=(0, 0)),
                             in_axes=(0, None)))(qL, jenv.side)
    _close(penv._knees(_t(q)), jknee, "knees", 0, HELPER_ATOL)
    # the Jacobian is the derivative of the FK: a central difference in
    # float64 of the port's FK agrees with it
    q64 = torch.from_numpy(q[:8].astype(np.float64))
    penv64 = LeggedRobot(penv.cfg, device="cpu")
    penv64.side = penv.side.double()
    eps = 1e-6
    for j in range(3):
        dq = torch.zeros_like(q64).reshape(8, -1, 3)
        dq[..., j] = eps
        dq = dq.reshape(8, -1)
        fp, _ = penv64._feet_and_jac(q64 + dq)
        fm, _ = penv64._feet_and_jac(q64 - dq)
        _, jac = penv64._feet_and_jac(q64)
        np.testing.assert_allclose(((fp - fm) / (2 * eps)).numpy(),
                                   jac[..., j].numpy(), atol=1e-8)


# ---------------------------------------------------------------------------
# one substep and its branches


def _jax_contact(jenv, carry):
    """The JAX substep's branch inputs on a carry: penetration [N, L] and
    the Coulomb cap over the tangential force's norm [N, L]
    (legged_robot.py:571-595)."""
    pos, quat, lin_vel, ang_vel, q, qd, anchor, _, friction, _, level = carry
    ct, a = jenv.cfg.contact, jenv.cfg.asset
    n, L = pos.shape[0], jenv.num_legs
    q1 = quat[:, None, :]
    foot_hip, jac = jenv._feet_and_jac(q)
    r_world = jax_math.quat_apply(q1, jenv.hip_pos[None] + foot_hip)
    foot_world = pos[:, None, :] + r_world
    v_joint = jnp.einsum("nlij,nlj->nli", jac, qd.reshape(n, L, 3))
    w_world = jax_math.quat_apply(quat, ang_vel)[:, None, :]
    foot_vel = (lin_vel[:, None, :] + jnp.cross(w_world, r_world)
                + jax_math.quat_apply(q1, v_joint))
    ground = jenv.terrain_height(
        foot_world[..., 0].reshape(-1), foot_world[..., 1].reshape(-1),
        jnp.repeat(level, L)).reshape(n, L)
    pen = ground + ct.foot_radius - foot_world[..., 2]
    fn = jnp.where(pen > 0.0, jnp.maximum(
        ct.k_normal * pen - ct.d_normal * foot_vel[..., 2], 0.0), 0.0)
    fn = jnp.minimum(fn, ct.max_force_mg * a.mass * 9.81)
    ft_raw = (-ct.k_tangent * (foot_world[..., :2] - anchor)
              - ct.d_tangent * foot_vel[..., :2])
    norm = jnp.linalg.norm(ft_raw, axis=-1) + 1e-9
    return pen, friction[:, None] * fn / norm


def _carries(jenv, arrays, actions):
    target = (jenv.cfg.control.action_scale * actions
              + np.asarray(jenv.default_q).reshape(-1)[None]).astype(np.float32)
    names = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd", "foot_anchor")
    jc = tuple(jnp.asarray(arrays[k]) for k in names) + (
        jnp.asarray(target), jnp.asarray(arrays["friction"]),
        jnp.asarray(arrays["added_mass"]), jnp.asarray(arrays["terrain_level"]))
    return jc, tuple(_t(np.asarray(x)) for x in jc)


@pytest.mark.parametrize("robot", ROBOTS)
def test_substep_and_its_branches_match_jax(robot):
    """One substep from a converted carry, and the two contact branches
    (pen > 0, the Coulomb cap binding) equal on its inputs.  The state is
    chosen away from the switching surfaces: every foot's |pen| > 1e-5 m
    and every grounded foot's cap ratio > 1e-3 away from 1, so a rounding
    difference cannot flip a branch; it has feet on both sides of both."""
    jenv, penv = _pair(robot)
    arrays = _arrays(jenv, N, 1)
    acts = np.random.default_rng(2).uniform(-0.3, 0.3, (N, jenv.nj)).astype(
        np.float32)
    jc, pc = _carries(jenv, arrays, acts)
    pen, ratio = jax.jit(lambda c: _jax_contact(jenv, c))(jc)
    pen, ratio = np.asarray(pen), np.asarray(ratio)
    ok = (np.abs(pen) > 1e-5).all(1) & np.where(
        pen > 0, np.abs(ratio - 1) > 1e-3, True).all(1)
    assert ok.sum() >= N // 2
    jc = tuple(x[ok] for x in jc)
    pc = tuple(x[torch.from_numpy(ok)] for x in pc)
    pen, ratio = pen[ok], ratio[ok]
    jcarry, (jtau, jf) = jax.jit(lambda c: jenv._substep(c, None))(jc)
    pcarry, (ptau, pf, contact) = penv._substep(pc)
    np.testing.assert_array_equal(contact.in_contact.numpy(), pen > 0)
    grounded = pen > 0
    np.testing.assert_array_equal(contact.capped.numpy()[grounded],
                                  ratio[grounded] < 1)
    for mask in (grounded, ratio < 1):
        assert mask.any() and not mask.all()
    _close(contact.pen, pen, "pen", 0, HELPER_ATOL)
    names = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd", "foot_anchor")
    for name, got, want in zip(names, pcarry, jcarry):
        _close(got, want, name)
    _close(ptau, jtau, "torques")
    weight = jenv.cfg.asset.mass * 9.81
    _close(pf, jf, "contact forces", 0, SUB_ATOL * weight)


# ---------------------------------------------------------------------------
# rewards, termination and the observation

ALL_REWARDS = ("tracking_lin_vel", "tracking_ang_vel", "lin_vel_z",
               "ang_vel_xy", "orientation", "base_height", "torques",
               "dof_vel", "dof_acc", "action_rate", "collision",
               "dof_pos_limits", "dof_vel_limits", "torque_limits",
               "feet_air_time", "stumble", "stand_still",
               "feet_contact_forces", "energy", "alive")


def test_every_reward_term_matches_jax():
    scales = {name: 0.5 + i for i, name in enumerate(ALL_REWARDS)}
    scales["termination"] = -3.0
    jenv, penv = _pair(jax_kw=dict(reward_scales=scales),
                       port_kw=dict(reward_scales=scales))
    assert [n for n, _, _ in penv.reward_fns] == list(ALL_REWARDS)
    arrays = _arrays(jenv, N, 3)
    rng = np.random.default_rng(4)
    arrays["qd"] = rng.uniform(-30, 30, arrays["qd"].shape).astype(np.float32)
    arrays["torques"] = rng.uniform(-40, 40, arrays["torques"].shape).astype(
        np.float32)
    arrays["contact_forces"][:8, :, :2] = 200.0     # stumbles, big forces
    arrays["commands"][:8, :2] = 0.01                # standing still
    arrays["q"][8:16] = np.asarray(jenv.q_high_flat)  # at the limits
    f32 = np.float32
    ctx = dict(body_vel=rng.normal(size=(N, 3)).astype(f32),
               body_ang=rng.normal(size=(N, 3)).astype(f32),
               base_h=rng.uniform(0.1, 0.4, N).astype(f32),
               actions=rng.uniform(-1, 1, (N, jenv.nj)).astype(f32),
               air_reward=rng.normal(size=N).astype(f32))
    js, ps = _jax_state(arrays), _port_state(arrays)
    jctx = J.RewardCtx(**{k: jnp.asarray(v) for k, v in ctx.items()})
    pctx = P.RewardCtx(**{k: _t(v) for k, v in ctx.items()})
    for (name, scale, fn), (_, jscale, jfn) in zip(penv.reward_fns,
                                                    jenv.reward_fns):
        assert scale == jscale
        want = np.asarray(jax.jit(jfn)(js, jctx))
        _close(fn(ps, pctx), want, name, 1e-6,
               HELPER_ATOL * max(1.0, float(np.abs(want).max())))
    assert penv.termination_scale == jenv.termination_scale


@pytest.mark.parametrize("measure_heights", [False, True])
def test_observation_matches_jax(measure_heights):
    kw = dict(terrain=J.LeggedTerrain(measure_heights=measure_heights))
    jenv, penv = _pair(jax_kw=kw, port_kw=dict(
        terrain=LeggedTerrain(measure_heights=measure_heights)))
    arrays = _arrays(jenv, N, 5)
    js, ps = _jax_state(arrays), _port_state(arrays)
    no = np.zeros(N, bool)
    jout = jax.jit(jenv._out)(js, jnp.zeros(N), no, no, jax.random.PRNGKey(0))
    pout = penv._out(ps, torch.zeros(N), _t(no), _t(no), None)
    assert pout.obs.shape == (N, penv.obs_dim)
    _close(pout.obs, jout.obs, "obs", 1e-6, HELPER_ATOL)
    _close(pout.episode_length, jout.episode_length, "episode_length", 0, 0)
    _close(pout.episode_reward, jout.episode_reward, "episode_reward", 0, 0)


def test_termination_matches_jax():
    """Trunks below the clearance, tilted past the limit, or at the last
    step of their episode: done, time_out and the reward (with a
    termination scale) agree.  995-step episodes: the time-out does not
    fall on a command resampling (every 500 steps), whose draws differ
    from JAX's."""
    scales = dict(LeggedRobotConfig().resolved_reward_scales(),
                  termination=-5.0)
    kw = dict(reward_scales=scales, only_positive_rewards=False,
              max_episode_length_s=19.9)
    jenv, penv = _pair(jax_kw=kw, port_kw=kw)
    assert jenv.max_episode_length % jenv.resample_interval != 0
    arrays = _arrays(jenv, 32, 6)
    arrays["pos"][:8, 2] = 0.05                      # below base_clearance
    tilt = np.asarray(jax_math.quat_from_euler_zyx(
        jnp.full(8, 1.4), jnp.zeros(8), jnp.zeros(8)))
    arrays["quat"][8:16] = tilt
    arrays["episode_len"][24:] = jenv.max_episode_length - 1
    acts = np.zeros((32, jenv.nj), np.float32)
    _, jo = jax.jit(jenv.step)(_jax_state(arrays), jnp.asarray(acts))
    _, po = penv.step(_port_state(arrays), _t(acts))
    np.testing.assert_array_equal(po.done.numpy(), np.asarray(jo.done))
    np.testing.assert_array_equal(po.time_out.numpy(), np.asarray(jo.time_out))
    assert po.done[:16].all() and po.time_out[24:].all()
    assert not po.done[16:24].any()
    _scale_close(po.reward, jo.reward, "reward")


# ---------------------------------------------------------------------------
# whole steps


@pytest.mark.parametrize("robot", ROBOTS)
def test_k_steps_from_converted_states_match_jax(robot):
    """K_STEPS control steps along the JAX env's trajectory, each taken by
    the port from JAX's state before it (see STEP_SCALE_TOL).  Pushes are
    off, the command resampling is 500 steps away and no env is done, so
    the random draws only reach masked-out branches."""
    jenv, penv = _pair(robot)
    assert jenv.resample_interval > K_STEPS + 20
    js = _jax_state(_arrays(jenv, N, 7))
    acts = np.random.default_rng(8).uniform(-0.3, 0.3, (K_STEPS, N, jenv.nj))
    acts = acts.astype(np.float32)
    step = jax.jit(jenv.step)
    fields = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd", "commands",
              "last_action", "last_qd", "torques", "contact_forces",
              "foot_anchor", "feet_air_time", "friction", "ep_track",
              "ep_reward", "walked")
    for k in range(K_STEPS):
        ps = _from_jax(js)
        js, jo = step(js, jnp.asarray(acts[k]))
        ps, po = penv.step(ps, _t(acts[k]))
        assert not bool(np.asarray(jo.done).any()) and not po.done.any()
        for name in ("last_contacts", "knee_contact", "episode_len",
                     "terrain_level"):
            np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                          np.asarray(getattr(js, name)),
                                          err_msg=f"{name} at step {k}")
        for name in fields:
            _scale_close(getattr(ps, name), getattr(js, name),
                         f"{name} at step {k}")
        for name in ("obs", "reward", "episode_reward", "episode_length"):
            _scale_close(getattr(po, name), getattr(jo, name),
                         f"out.{name} at step {k}")
        np.testing.assert_array_equal(po.time_out.numpy(),
                                      np.asarray(jo.time_out))


# ---------------------------------------------------------------------------
# the rough terrain


def _rough(measure_heights=False):
    return _pair(jax_kw=dict(terrain=J.LeggedTerrain(
                     mesh_type="rough", measure_heights=measure_heights)),
                 port_kw=dict(terrain=LeggedTerrain(
                     mesh_type="rough", measure_heights=measure_heights)))


def _circular(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % 1.0
    return np.minimum(d, 1.0 - d)


def test_rough_hash_and_heights_within_the_circular_bound():
    """The hash at 100,000 cell corners over +-40 m (read from the JAX
    env's terrain_height at the corners, where the blend is the corner's
    hash alone) within HASH_BOUND on the circle; the heights at 100,000
    points of every level within amp * HASH_BOUND, but where a hash wraps
    across 0 (the circle's seam), where they differ by less than amp."""
    jenv, penv = _rough()
    rng = np.random.default_rng(0)
    n = 100_000
    ix = rng.integers(-160, 160, n).astype(np.float32)
    iy = rng.integers(-160, 160, n).astype(np.float32)
    top = np.full(n, 9, np.int32)                    # amp = 0.08 exactly
    amp = np.float32(0.08)
    jh = np.asarray(jax.jit(jenv.terrain_height)(ix * 0.25, iy * 0.25, top))
    ph = penv.terrain_hash(_t(ix), _t(iy)).numpy()
    # jh / amp carries an ulp or two of the product and the quotient
    circ = _circular(ph, jh / amp)
    assert circ.max() <= HASH_BOUND + 1e-6, circ.max()
    assert (circ > 1e-6).mean() < 0.05               # mostly equal
    x = rng.uniform(-40, 40, n).astype(np.float32)
    y = rng.uniform(-40, 40, n).astype(np.float32)
    level = rng.integers(0, 10, n).astype(np.int32)
    jt = np.asarray(jax.jit(jenv.terrain_height)(x, y, level))
    pt = penv.terrain_height(_t(x), _t(y), _t(level)).numpy()
    amps = 0.08 * (level + 1.0) / 10
    err = np.abs(pt - jt) / amps
    near = err > HASH_BOUND + 1e-5
    # a height leaves the bound only where one of its four corners' hash
    # lies within HASH_BOUND of the circle's seam at 0 (a wrap): for hashes
    # spread evenly over [0, 1), at most 4 * 2 * HASH_BOUND of them
    assert near.mean() <= 8 * HASH_BOUND, near.mean()
    assert (err <= 1.0).all()
    assert ((pt >= 0) & (pt <= amps + 1e-6)).all()


def test_rough_step_within_the_height_error():
    """One control step on rough terrain with measure_heights (obs 235)
    from a converted state on every curriculum level.  The ground under a
    foot differs by at most amp * HASH_BOUND (6.25e-4 m at the top level)
    where no hash wraps: the contact forces by k_normal times that
    (1.6 N), within a step's 8 substeps a few times more; held to the
    plane's step tolerance plus that.  The measured heights, clip(z - 0.5
    - h) x 5, within 5 * amp * HASH_BOUND of each other."""
    jenv, penv = _rough(measure_heights=True)
    assert penv.obs_dim == 235
    arrays = _arrays(jenv, N, 9)
    level = np.arange(N, dtype=np.int32) % 10
    arrays["terrain_level"] = level
    arrays["pos"][:, 2] += np.asarray(jenv.terrain_height(
        jnp.asarray(arrays["pos"][:, 0]), jnp.asarray(arrays["pos"][:, 1]),
        jnp.asarray(level)))
    acts = np.random.default_rng(10).uniform(-0.3, 0.3, (N, 12)).astype(
        np.float32)
    js, jo = jax.jit(jenv.step)(_jax_state(arrays), jnp.asarray(acts))
    ps, po = penv.step(_port_state(arrays), _t(acts))
    np.testing.assert_array_equal(po.done.numpy(), np.asarray(jo.done))
    height_err = 0.08 * HASH_BOUND
    force_tol = 4 * jenv.cfg.contact.k_normal * height_err
    for name in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd", "torques",
                 "foot_anchor"):
        _scale_close(getattr(ps, name), getattr(js, name), name)
    err = np.abs(ps.contact_forces.numpy() - np.asarray(js.contact_forces))
    assert err.max() <= force_tol + STEP_SCALE_TOL * float(
        np.abs(np.asarray(js.contact_forces)).max()), err.max()
    amps = (0.08 * (level + 1.0) / 10)[:, None]
    herr = np.abs(po.obs.numpy()[:, 48:] - np.asarray(jo.obs)[:, 48:])
    assert (herr <= 5 * amps * HASH_BOUND + 1e-5).all(), herr.max()
    _scale_close(po.obs[:, :48], jo.obs[:, :48], "obs")


# ---------------------------------------------------------------------------
# the random parts, held to their ranges


def test_spawn_and_commands_in_their_ranges():
    env = LeggedRobot(device="cpu")
    g = torch.Generator().manual_seed(0)
    n = 20000
    level = torch.zeros(n, dtype=torch.int32)
    f = env._spawn(g, n, level, torch.ones(n))
    assert float(f["pos"][:, :2].abs().max()) <= 1.0
    assert torch.allclose(f["pos"][:, 2], torch.tensor(env.stand_height))
    for k in ("lin_vel", "ang_vel", "qd", "last_action", "torques",
              "contact_forces", "feet_air_time", "walked"):
        assert float(f[k].abs().max()) == 0.0, k
    lo, hi = env.cfg.domain_rand.friction_range
    assert lo <= float(f["friction"].min()) and float(f["friction"].max()) <= hi
    assert float(f["added_mass"].abs().max()) == 0.0
    dq = env.default_q_flat
    ratio = f["q"] / torch.where(dq == 0, 1.0, dq)
    inside = (f["q"] > env.q_low_flat) & (f["q"] < env.q_high_flat) & (dq != 0)
    assert float(ratio[inside].min()) >= 0.8 - 1e-6
    assert float(ratio[inside].max()) <= 1.2 + 1e-6
    assert (f["q"] >= env.q_low_flat).all() and (f["q"] <= env.q_high_flat).all()
    # yaw in +-3.14 about z only
    assert float(f["quat"][:, :2].abs().max()) < 1e-6
    # anchors under the spawned feet
    foot, _ = env._feet_and_jac(f["q"])
    from gennbv_tpu_torch.utils import math as um
    feet = f["pos"][:, None] + um.quat_apply(f["quat"][:, None],
                                             env.hip_pos[None] + foot)
    assert torch.equal(f["foot_anchor"], feet[..., :2])
    cmd = env._sample_commands(g, n, torch.full((n,), 0.5))
    norm = torch.linalg.vector_norm(cmd[:, :2], dim=1)
    snapped = norm == 0
    assert float(norm[~snapped].min()) > 0.2
    assert float(cmd[:, 0].abs().max()) <= 0.5
    assert float(cmd[:, 2].abs().max()) <= 1.0
    assert float(cmd[:, 3].abs().max()) <= 3.14 + 1e-6
    assert snapped.any()
    rough = LeggedRobot(LeggedRobotConfig(terrain=LeggedTerrain(
        mesh_type="rough", curriculum=True)), device="cpu")
    state, out = rough.reset(512, torch.Generator().manual_seed(1))
    assert int(state.terrain_level.max()) == rough.cfg.terrain.max_init_level
    assert int(state.terrain_level.min()) == 0
    ground = rough.terrain_height(state.pos[:, 0], state.pos[:, 1],
                                  state.terrain_level)
    assert torch.allclose(state.pos[:, 2] - ground,
                          torch.tensor(rough.stand_height), atol=1e-6)


def test_step_is_a_function_of_state_and_actions():
    env = LeggedRobot(LeggedRobotConfig(
        domain_rand=LeggedDomainRand(push_interval_s=0.04)), device="cpu")
    g = torch.Generator().manual_seed(3)
    state, _ = env.reset(16, g)
    before = g.get_state()
    state = state._replace(pos=torch.where(torch.arange(16)[:, None] < 4,
                                           -1.0, state.pos))   # crashes
    a = torch.zeros(16, env.nj)
    s1, o1 = env.step(state, a)
    s2, o2 = env.step(state, a)
    assert o1.done[:4].all()
    for x, y in zip(s1, s2):
        assert torch.equal(x, y)
    assert torch.equal(o1.obs, o2.obs) and torch.equal(g.get_state(), before)


def test_obs_noise_in_its_bounds():
    noisy = LeggedRobotConfig(obs_noise=P.LeggedNoise(add_noise=True))
    env = LeggedRobot(noisy, device="cpu")
    clean = LeggedRobot(device="cpu")
    state, _ = env.reset(256, torch.Generator().manual_seed(4))
    no = torch.zeros(256, dtype=torch.bool)
    got = env._out(state, torch.zeros(256), no, no,
                   torch.Generator().manual_seed(5)).obs
    want = clean._out(state, torch.zeros(256), no, no, None).obs
    nz, sc = noisy.obs_noise, noisy.obs_scales
    bound = torch.tensor([nz.lin_vel * sc.lin_vel] * 3 + [nz.ang_vel * sc.ang_vel] * 3
                         + [nz.gravity] * 3 + [0.0] * 3
                         + [nz.dof_pos * sc.dof_pos] * 12
                         + [nz.dof_vel * sc.dof_vel] * 12 + [0.0] * 12)
    diff = (got - want).abs()
    assert (diff <= bound + 1e-6).all()
    assert (diff.amax(0) > 0.5 * bound).all() or bool((bound == 0).any())


# ---------------------------------------------------------------------------
# the tests of tests/test_legged_robot.py, on the port alone


def _quiet_cfg(**kw):
    return LeggedRobotConfig(
        domain_rand=LeggedDomainRand(randomize_friction=False,
                                     push_robots=False),
        commands=LeggedCommands(heading_command=False), **kw)


def _standing_state(env, n=4):
    state, _ = env.reset(n, torch.Generator().manual_seed(0))
    q0 = env.default_q_flat.expand(n, env.nj).clone()
    pos = torch.zeros(n, 3)
    pos[:, 2] = env.stand_height
    foot, _ = env._feet_and_jac(q0)
    feet = pos[:, None, :] + env.hip_pos[None] + foot      # identity quat
    return state._replace(
        pos=pos, quat=torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(n, 1),
        lin_vel=torch.zeros(n, 3), ang_vel=torch.zeros(n, 3), q=q0,
        qd=torch.zeros(n, env.nj), foot_anchor=feet[..., :2],
        commands=torch.zeros(n, 4),
        episode_len=torch.zeros(n, dtype=torch.int32))


def test_env_contract():
    check_env(LeggedRobot(_quiet_cfg(), device="cpu"), num_envs=4, steps=8)


def test_stands_under_gravity():
    cfg = _quiet_cfg()
    cfg = dataclasses.replace(cfg, control=dataclasses.replace(
        cfg.control, stiffness=60.0, damping=2.0))
    env = LeggedRobot(cfg, device="cpu")
    state = _standing_state(env)
    for _ in range(200):                       # 4 s
        state, out = env.step(state, torch.zeros(4, env.nj))
        assert not bool(out.done.any()), "fell while standing"
    h = state.pos[:, 2].numpy()
    assert (h > env.cfg.asset.base_clearance + 0.05).all(), h
    assert (h < env.stand_height + 0.05).all(), h
    total = state.contact_forces[..., 2].sum(1).numpy()
    np.testing.assert_allclose(total, env.cfg.asset.mass * 9.81, rtol=0.4)


def test_fall_terminates_and_resets():
    env = LeggedRobot(_quiet_cfg(), device="cpu")
    state = _standing_state(env)
    rolled = torch.tensor([[np.sin(0.75), 0.0, 0.0, np.cos(0.75)]],
                          dtype=torch.float32).repeat(4, 1)   # 1.5 rad roll
    state = state._replace(quat=rolled,
                           episode_len=torch.full((4,), 5, dtype=torch.int32))
    state, out = env.step(state, torch.zeros(4, env.nj))
    assert bool(out.done.all()) and not bool(out.time_out.any())
    assert int(state.episode_len.max()) == 0


def test_reward_registry_scales_by_dt():
    env = LeggedRobot(_quiet_cfg(reward_scales={
        "alive": 2.0, "termination": -5.0, "orientation": 0.0}), device="cpu")
    assert [n for n, _, _ in env.reward_fns] == ["alive"]
    assert env.reward_fns[0][1] == pytest.approx(2.0 * env.dt)
    assert env.termination_scale == pytest.approx(-5.0 * env.dt)


def test_heading_command_servo():
    env = LeggedRobot(LeggedRobotConfig(
        domain_rand=LeggedDomainRand(randomize_friction=False,
                                     push_robots=False),
        commands=LeggedCommands(heading_command=True)), device="cpu")
    state = _standing_state(env)
    cmd = torch.zeros(4, 4)
    cmd[:, 3] = np.pi / 2
    state, _ = env.step(state._replace(commands=cmd), torch.zeros(4, env.nj))
    yaw_cmd = state.commands[:, 2].numpy()
    np.testing.assert_allclose(yaw_cmd, np.clip(0.5 * np.pi / 2, -1, 1),
                               atol=0.2)
    assert (yaw_cmd > 0.2).all()


def test_feet_air_time_accrues():
    env = LeggedRobot(_quiet_cfg(), device="cpu")
    state = _standing_state(env)
    pos = state.pos.clone()
    pos[:, 2] = 1.0
    cmd = torch.zeros(4, 4)
    cmd[:, 0] = 0.8
    state, _ = env.step(state._replace(pos=pos, commands=cmd),
                        torch.zeros(4, env.nj))
    assert float(state.feet_air_time.min()) > 0.0
    assert not bool(state.last_contacts.any())


def test_terrain_rough_amplitude_and_determinism():
    env = LeggedRobot(_quiet_cfg(terrain=LeggedTerrain(
        mesh_type="rough", max_amplitude=0.1, num_levels=10)), device="cpu")
    x = torch.linspace(-3, 3, 64)
    lvl0 = torch.zeros(64, dtype=torch.int32)
    lvl9 = torch.full((64,), 9, dtype=torch.int32)
    h0 = env.terrain_height(x, x, lvl0)
    h9 = env.terrain_height(x, x, lvl9)
    assert torch.equal(h0, env.terrain_height(x, x, lvl0))
    assert float(h9.max()) <= 0.1 + 1e-6
    assert float(h9.max()) > float(h0.max())
    assert float(h0.max()) <= 0.1 * (1 / 10) + 1e-6


def test_terrain_curriculum_promotes():
    env = LeggedRobot(_quiet_cfg(terrain=LeggedTerrain(
        mesh_type="rough", curriculum=True, terrain_length=1.0)), device="cpu")
    state = _standing_state(env)
    state = state._replace(
        walked=torch.full((4, 2), 1.2 / np.sqrt(2)),
        terrain_level=torch.zeros(4, dtype=torch.int32),
        episode_len=torch.full((4,), env.max_episode_length - 1,
                               dtype=torch.int32))
    state, out = env.step(state, torch.zeros(4, env.nj))
    assert bool(out.time_out.all())
    assert (state.terrain_level.numpy() == 1).all()
    assert state.terrain_level.dtype == torch.int32


def test_command_curriculum_widens():
    """update_command_curriculum (legged_robot.py:511-520): an episode whose
    tracking return passes 80% of its attainable maximum widens |vx| by
    0.5 at its reset; in the JAX env too."""
    kw = dict(commands=LeggedCommands(curriculum=True, heading_command=False))
    jenv, penv = _pair(jax_kw=kw, port_kw=dict(commands=LeggedCommands(
        curriculum=True, heading_command=False)))
    arrays = _arrays(jenv, 8, 11)
    arrays["episode_len"][:] = jenv.max_episode_length - 1
    arrays["cmd_max_x"][:] = 0.5
    arrays["ep_track"][:4] = 0.9 * jenv.tracking_scale * jenv.max_episode_length
    arrays["ep_track"][4:] = 0.0
    acts = np.zeros((8, 12), np.float32)
    js, _ = jax.jit(jenv.step)(_jax_state(arrays), jnp.asarray(acts))
    ps, _ = penv.step(_port_state(arrays), _t(acts))
    np.testing.assert_array_equal(ps.cmd_max_x.numpy(), np.asarray(js.cmd_max_x))
    assert (ps.cmd_max_x.numpy() == [1.0] * 4 + [0.5] * 4).all()


def test_robot_zoo_configs():
    for make, nj in [(P.anymal_b_config, 12), (P.anymal_c_config, 12),
                     (P.cassie_config, 6)]:
        env = LeggedRobot(make(domain_rand=LeggedDomainRand(
            randomize_friction=False, push_robots=False)), device="cpu")
        assert env.nj == nj and env.obs_dim == 12 + 3 * nj
        state, out = env.reset(2, torch.Generator().manual_seed(1))
        state, out = env.step(state, torch.zeros(2, env.nj))
        assert out.obs.shape == (2, env.obs_dim)
        assert bool(torch.isfinite(out.obs).all())


def test_measure_heights_obs():
    env = LeggedRobot(_quiet_cfg(terrain=LeggedTerrain(
        mesh_type="rough", measure_heights=True)), device="cpu")
    assert env.obs_dim == 12 + 36 + 187
    state, out = env.reset(2, torch.Generator().manual_seed(2))
    assert out.obs.shape == (2, env.obs_dim)
    assert bool(torch.isfinite(out.obs).all())


def test_registry_legged_tasks():
    assert registry.task_names() == jax_registry.task_names()
    for robot in ROBOTS:
        env, cfg = registry.make_env(f"{robot}_velocity", None, device="cpu")
        _, jcfg = jax_registry.make_env(f"{robot}_velocity", None)
        assert isinstance(env, LeggedRobot) and env.device.type == "cpu"
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert env.nj == (6 if robot == "cassie" else 12)


def _det_eval(runner, env, steps=120, n=64):
    policy = runner.get_inference_policy()
    state, out = env.reset(n, torch.Generator().manual_seed(42))
    tot, dones = 0.0, 0.0
    for _ in range(steps):
        state, out = env.step(state, policy(out.obs))
        tot += float(out.reward.mean())
        dones += float(out.done.float().mean())
    return tot / steps, dones / steps


@pytest.mark.slow
def test_ppo_learnability():
    """tests/test_legged_robot.py's: the continuous stack learns active
    stand stabilization on the quadruped from scratch (crash rate of the
    deterministic policy at least halved in 80 iterations)."""
    from gennbv_tpu_torch.algo import ppo_continuous as ppoc
    from gennbv_tpu_torch.algo.on_policy_runner import (OnPolicyRunner,
                                                        OnPolicyRunnerConfig)
    cfg = LeggedRobotConfig(
        domain_rand=LeggedDomainRand(randomize_friction=False,
                                     push_robots=False),
        commands=LeggedCommands(heading_command=False, lin_vel_x=(0.0, 0.0),
                                lin_vel_y=(0.0, 0.0), ang_vel_yaw=(0.0, 0.0)),
        max_episode_length_s=4.0, only_positive_rewards=False,
        reward_scales={"alive": 5.0, "orientation": -5.0,
                       "base_height": -50.0, "lin_vel_z": -2.0,
                       "ang_vel_xy": -0.1, "torques": -1e-4,
                       "action_rate": -0.01, "termination": -10.0})
    env = LeggedRobot(cfg, device="cpu")
    runner = OnPolicyRunner(
        env, ppoc.ContinuousPPOConfig(learning_rate=3e-4),
        OnPolicyRunnerConfig(num_steps_per_env=24), num_envs=64, seed=3,
        actor_hidden=(64, 64), critic_hidden=(64, 64))
    runner.learn(1)
    r0, d0 = _det_eval(runner, env)
    runner.learn(80)
    r1, d1 = _det_eval(runner, env)
    assert np.isfinite(r0) and np.isfinite(r1)
    assert d0 > 0.002, d0
    assert d1 <= 0.5 * d0, (d0, d1)
    assert r1 > 0.8 * r0, (r0, r1)
