"""The port's physics drone (``gennbv_tpu_torch/env/drone_robot.py``), its
math helpers (``utils/math.py``), the task registry and the ``train_rsl``
CLI against the JAX package's: the deterministic core on the same numpy
inputs (the substeps of a control step, every reward term, termination,
the observation, and k whole steps from a converted JAX state), the random
parts held to their ranges; then the tests of tests/test_drone_robot.py
and TestRegistry of tests/test_misc.py on the port alone."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import registry as jax_registry
from gennbv_tpu.env import drone_robot as jax_drone
from gennbv_tpu.utils import math as jax_math
from gennbv_tpu_torch import registry, spec
from gennbv_tpu_torch.config import Config, apply_overrides
from gennbv_tpu_torch.env import scene as scene_lib
from gennbv_tpu_torch.env.drone_robot import (DroneCommands, DroneDomainRand,
                                              DroneRobot, DroneRobotConfig,
                                              DroneState)
from gennbv_tpu_torch.train import train_rsl
from gennbv_tpu_torch.utils import math as um
from gennbv_tpu_torch.utils.env_checker import check_env

# elementwise float32 formulas evaluated in another order (XLA fuses the
# JAX side into FMAs): a few ulps of values of magnitude <= ~10
HELPER_ATOL = 1e-6
# The drone's state after one control step (4 substeps): each substep's
# float32 ops differ by an ulp or two (FMA contraction, XLA's reciprocal
# for divisions by constants); rotor speeds ~2e3 rad/s carry ~1e-4
# absolute of that, velocities and rates ~1e-6.  k steps of the
# semi-implicit Euler integrator (stable near hover) keep it at that
# relative level: 1e-5 relative, 1e-5 absolute.
STEP_RTOL, STEP_ATOL = 1e-5, 1e-5
K_STEPS = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _quiet(**kw):
    """No domain rand / pushes / obs noise: deterministic physics."""
    return dict(domain_rand=DroneDomainRand(randomize_mass=False,
                                            push_robots=False), **kw)


def _jax_quiet(**kw):
    return dict(domain_rand=jax_drone.DroneDomainRand(randomize_mass=False,
                                                      push_robots=False), **kw)


def _pair(**kw):
    return (jax_drone.DroneRobot(jax_drone.DroneRobotConfig(**_jax_quiet(**kw))),
            DroneRobot(DroneRobotConfig(**_quiet(**kw)), device="cpu"))


def _state_arrays(n, seed):
    """A moving, tilted, spinning drone state, away from the crash
    thresholds: small tilts, height 1-2 m, rotors near hover."""
    rng = np.random.default_rng(seed)
    hover = jax_drone.DroneAsset().hover_rotor
    euler = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    quat = np.asarray(jax_math.quat_from_euler_zyx(*euler.T))
    f32 = np.float32
    return dict(
        pos=np.concatenate([rng.uniform(-1, 1, (n, 2)),
                            rng.uniform(1, 2, (n, 1))], 1).astype(f32),
        quat=quat.astype(f32),
        lin_vel=rng.uniform(-0.5, 0.5, (n, 3)).astype(f32),
        ang_vel=rng.uniform(-0.5, 0.5, (n, 3)).astype(f32),
        rotor_vel=(hover + rng.uniform(-50, 50, (n, 4))).astype(f32),
        commands=rng.uniform(-1, 1, (n, 4)).astype(f32),
        last_action=rng.uniform(-0.2, 0.2, (n, 4)).astype(f32),
        last_torque=rng.uniform(-0.01, 0.01, (n, 4)).astype(f32),
        added_mass=rng.uniform(-0.005, 0.005, n).astype(f32),
        episode_len=rng.integers(0, 20, n).astype(np.int32),
        ep_reward=rng.normal(size=n).astype(f32))


def _jax_state(arrays, key=0):
    return jax_drone.DroneState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                                rng=jax.random.PRNGKey(key))


def _port_state(arrays):
    return DroneState(**{k: _t(v) for k, v in arrays.items()},
                      rng=torch.Generator().manual_seed(0).get_state())


def _close(got, want, msg, rtol=STEP_RTOL, atol=STEP_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# math helpers


def test_math_helpers_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 4)).astype(np.float32)
    b = rng.normal(size=(64, 4)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    ang = rng.uniform(-20, 20, 256).astype(np.float32)
    eul = rng.uniform(-3, 3, (3, 64)).astype(np.float32)
    pairs = {
        "quat_mul": (um.quat_mul(_t(a), _t(b)), jax_math.quat_mul(a, b)),
        "quat_apply": (um.quat_apply(_t(a), _t(v)), jax_math.quat_apply(a, v)),
        "quat_conjugate": (um.quat_conjugate(_t(a)), jax_math.quat_conjugate(a)),
        "quat_from_euler_zyx": (um.quat_from_euler_zyx(*map(_t, eul)),
                                jax_math.quat_from_euler_zyx(*eul)),
        "quat_apply_yaw": (um.quat_apply_yaw(_t(a), _t(v)),
                           jax_math.quat_apply_yaw(a, v)),
        "wrap_to_pi": (um.wrap_to_pi(_t(ang)), jax_math.wrap_to_pi(ang)),
    }
    for name, (got, want) in pairs.items():
        # products of values ~1-3 summed over 4 terms: 1e-6 relative to ~10
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5 if name != "quat_conjugate" else 0,
                                   err_msg=name)
    w = um.wrap_to_pi(_t(ang)).numpy()
    assert (w > -np.pi).all() and (w <= np.pi).all()


def test_rand_sqrt_float_distribution():
    """Signed sqrt of uniform[-1, 1], rescaled: within [lower, upper], and
    |r| < 1/2 exactly where the uniform draw was within 1/4."""
    g = torch.Generator().manual_seed(0)
    x = um.rand_sqrt_float(g, -2.0, 4.0, (20000,))
    assert x.shape == (20000,) and float(x.min()) >= -2.0 and float(x.max()) <= 4.0
    r = (x - 1.0) / 3.0                      # back to [-1, 1]
    assert abs(float((r.abs() < 0.5).float().mean()) - 0.25) < 0.02
    assert abs(float(r.mean())) < 0.03


# ---------------------------------------------------------------------------
# the deterministic core against the JAX drone


def test_substeps_of_a_control_step_match_jax():
    jenv, penv = _pair()
    arrays = _state_arrays(32, 1)
    acts = np.random.default_rng(2).uniform(-0.5, 0.5, (32, 4)).astype(np.float32)
    js = _jax_state(arrays)
    target = jenv._rotor_target(jnp.asarray(acts))
    carry = (js.pos, js.quat, js.lin_vel, js.ang_vel, js.rotor_vel, target,
             js.added_mass)
    jcarry, jtorques = jax.jit(lambda c: jax.lax.scan(
        jenv._substep, c, None, length=jenv.cfg.control.decimation))(carry)
    ps = _port_state(arrays)
    ptarget = penv._rotor_target(_t(acts))
    # rotor targets ~2e3: a float32 ulp is 1.2e-4
    _close(ptarget, target, "target", rtol=1e-6, atol=0)
    pcarry = (ps.pos, ps.quat, ps.lin_vel, ps.ang_vel, ps.rotor_vel, _t(target),
              ps.added_mass)
    for _ in range(penv.cfg.control.decimation):
        pcarry, torque = penv._substep(pcarry)
    names = ("pos", "quat", "lin_vel", "ang_vel", "rotor_vel")
    for name, got, want in zip(names, pcarry, jcarry):
        _close(got, want, name)
    _close(torque, jtorques[-1], "torque")


def test_reward_terms_termination_and_obs_match_jax():
    # 995-step episodes: the timeout does not fall on a command resampling
    # (every 250 steps), whose draws differ from JAX's
    jenv, penv = _pair(max_episode_length_s=19.9)
    assert jenv.max_episode_length % jenv.resample_interval != 0
    arrays = _state_arrays(32, 3)
    rng = np.random.default_rng(4)
    body_vel = rng.normal(size=(32, 3)).astype(np.float32)
    body_ang = rng.normal(size=(32, 3)).astype(np.float32)
    drive = rng.normal(0, 0.05, (32, 4)).astype(np.float32)
    acts = rng.uniform(-1, 1, (32, 4)).astype(np.float32)
    js, ps = _jax_state(arrays), _port_state(arrays)
    names = [n for n, _, _ in penv.reward_fns]
    assert names == [n for n, _, _ in jenv.reward_fns]
    assert len(names) == 7
    for (name, scale, fn), (_, jscale, jfn) in zip(penv.reward_fns,
                                                    jenv.reward_fns):
        assert scale == jscale
        got = fn(ps, _t(body_vel), _t(body_ang), _t(drive), _t(acts))
        want = jfn(js, body_vel, body_ang, drive, acts)
        _close(got, want, name, rtol=1e-6, atol=HELPER_ATOL)
    assert penv.termination_scale == jenv.termination_scale
    # the observation without noise, and the projected gravity that
    # termination reads
    no = np.zeros(32, bool)
    jout = jenv._out(js, jnp.zeros(32), no, no, jax.random.PRNGKey(0))
    pout = penv._out(ps, torch.zeros(32), _t(no), _t(no), None)
    _close(pout.obs, jout.obs, "obs", rtol=1e-6, atol=HELPER_ATOL)
    _close(pout.episode_length, jout.episode_length, "episode_length", 0, 0)
    # termination: ground strike for some envs, a tilt past 1.2 rad for
    # others, the rest flying, and the last step before the timeout for some
    crashed = dict(arrays)
    crashed["pos"] = arrays["pos"].copy()
    crashed["pos"][:8, 2] = -0.05
    tilt = np.asarray(jax_math.quat_from_euler_zyx(
        jnp.full(8, 1.4), jnp.zeros(8), jnp.zeros(8)))
    crashed["quat"] = arrays["quat"].copy()
    crashed["quat"][8:16] = tilt
    crashed["episode_len"] = np.where(np.arange(32) >= 24,
                                      jenv.max_episode_length - 1,
                                      0).astype(np.int32)
    zero = np.zeros((32, 4), np.float32)
    _, jo = jenv.step(_jax_state(crashed), jnp.asarray(zero))
    _, po = penv.step(_port_state(crashed), _t(zero))
    np.testing.assert_array_equal(po.done.numpy(), np.asarray(jo.done))
    np.testing.assert_array_equal(po.time_out.numpy(), np.asarray(jo.time_out))
    assert po.done[:16].all() and po.time_out[24:].all()
    assert not po.done[16:24].any()
    _close(po.reward, jo.reward, "reward", rtol=1e-5, atol=1e-6)
    _close(po.obs, jo.obs, "obs after the step")


def test_k_steps_from_a_converted_state_match_jax():
    """K_STEPS control steps from the same state and actions, with pushes
    off and the command resampling interval past K_STEPS (5 s = 250
    steps), away from the crash thresholds: no env is done, so the random
    draws only ever reach masked-out branches."""
    jenv, penv = _pair()
    assert jenv.resample_interval > K_STEPS + 20
    arrays = _state_arrays(64, 5)
    js, ps = _jax_state(arrays), _port_state(arrays)
    acts = np.random.default_rng(6).uniform(-0.3, 0.3, (K_STEPS, 64, 4)).astype(
        np.float32)
    step = jax.jit(jenv.step)
    for k in range(K_STEPS):
        js, jo = step(js, jnp.asarray(acts[k]))
        ps, po = penv.step(ps, _t(acts[k]))
        assert not bool(np.asarray(jo.done).any()) and not po.done.any()
        for name in ("pos", "quat", "lin_vel", "ang_vel", "rotor_vel",
                     "commands", "last_action", "last_torque", "ep_reward"):
            _close(getattr(ps, name), getattr(js, name), f"{name} at step {k}")
        np.testing.assert_array_equal(ps.episode_len.numpy(),
                                      np.asarray(js.episode_len))
        _close(po.obs, jo.obs, f"obs at step {k}")
        _close(po.reward, jo.reward, f"reward at step {k}", rtol=1e-5, atol=1e-6)
        _close(po.episode_reward, jo.episode_reward, f"episode reward at {k}",
               rtol=1e-5, atol=1e-6)


def test_spawn_and_commands_in_their_ranges():
    """The random parts, held to their ranges and to the min-norm snap
    (not to JAX's stream)."""
    env = DroneRobot(device="cpu")
    g = torch.Generator().manual_seed(0)
    n = 20000
    f = env._spawn(g, n)
    assert float(f["pos"][:, :2].abs().max()) <= 1.0
    assert torch.all(f["pos"][:, 2] == env.cfg.init_height)
    for k in ("lin_vel", "ang_vel"):
        assert float(f[k].abs().max()) <= 0.5
    lo, hi = env.cfg.domain_rand.added_mass_range
    assert float(f["added_mass"].min()) >= lo and float(f["added_mass"].max()) <= hi
    assert float(f["added_mass"].std()) > 0.002
    assert torch.equal(f["quat"], torch.tensor([[0.0, 0, 0, 1]]).expand(n, 4))
    np.testing.assert_allclose(f["rotor_vel"].numpy(),
                               np.float32(env.cfg.asset.hover_rotor))
    for k in ("last_action", "last_torque"):
        assert float(f[k].abs().max()) == 0.0
    cmd = env._sample_commands(g, n)
    c = env.cfg.commands
    xy = cmd[:, :2]
    norm = torch.linalg.vector_norm(xy, dim=1)
    snapped = norm == 0
    # the snap zeroes both components of the small commands and no other
    # P(|xy| <= 0.2) for xy uniform in [-1, 1]^2 is pi * 0.04 / 4
    assert abs(float(snapped.float().mean()) - np.pi * 0.04 / 4) < 0.006
    assert float(norm[~snapped].min()) > c.min_norm
    assert float(cmd[:, 2].min()) >= c.lin_vel_z[0] and float(cmd[:, 2].max()) <= c.lin_vel_z[1]
    assert float(cmd[:, 3].min()) >= c.ang_vel_yaw[0] and float(cmd[:, 3].max()) <= c.ang_vel_yaw[1]
    quiet = DroneRobot(DroneRobotConfig(**_quiet()), device="cpu")
    assert float(quiet._spawn(g, 8)["added_mass"].abs().max()) == 0.0


def test_step_is_a_function_of_state_and_actions():
    """The random draws come from the state's generator: the same (state,
    actions) gives the same step, pushes and resets included, and the
    caller's generator is not advanced by a step."""
    env = DroneRobot(DroneRobotConfig(domain_rand=DroneDomainRand(
        push_interval_s=0.04)), device="cpu")
    g = torch.Generator().manual_seed(3)
    state, _ = env.reset(16, g)
    before = g.get_state()
    state = state._replace(pos=torch.where(torch.arange(16)[:, None] < 4,
                                           -1.0, state.pos))   # crashes
    a = torch.zeros(16, 4)
    s1, o1 = env.step(state, a)
    s2, o2 = env.step(state, a)
    assert o1.done[:4].all()
    for x, y in zip(s1, s2):
        assert torch.equal(x, y)
    assert torch.equal(o1.obs, o2.obs) and torch.equal(g.get_state(), before)


# ---------------------------------------------------------------------------
# the tests of tests/test_drone_robot.py, on the port alone


def _hover_state(env, n=4):
    a = env.cfg.asset
    return DroneState(
        pos=torch.tensor([[0.0, 0.0, env.cfg.init_height]]).repeat(n, 1),
        quat=torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(n, 1),
        lin_vel=torch.zeros(n, 3), ang_vel=torch.zeros(n, 3),
        rotor_vel=torch.full((n, 4), a.hover_rotor),
        commands=torch.zeros(n, 4), last_action=torch.zeros(n, 4),
        last_torque=torch.zeros(n, 4), added_mass=torch.zeros(n),
        episode_len=torch.zeros(n, dtype=torch.int32), ep_reward=torch.zeros(n),
        rng=torch.Generator().manual_seed(7).get_state())


def _quiet_env(**kw):
    return DroneRobot(DroneRobotConfig(**_quiet(**kw)), device="cpu")


def test_env_contract():
    check_env(_quiet_env(), num_envs=4, steps=8)
    check_env(DroneRobot(DroneRobotConfig(obs_noise=0.05), device="cpu"))


def test_hover_equilibrium():
    env = _quiet_env()
    state = _hover_state(env)
    for _ in range(50):
        state, out = env.step(state, torch.zeros(4, 4))
    np.testing.assert_allclose(state.pos[:, 2].numpy(), env.cfg.init_height,
                               atol=1e-3)
    assert float(state.lin_vel.abs().max()) < 1e-3
    assert float(state.ang_vel.abs().max()) < 1e-3


def test_collective_thrust_climbs():
    env = _quiet_env()
    state = _hover_state(env)
    for _ in range(10):
        state, _ = env.step(state, torch.full((4, 4), 0.5))
    assert float(state.lin_vel[:, 2].min()) > 0.1
    assert float(state.pos[:, 2].min()) > env.cfg.init_height
    assert float(state.ang_vel.abs().max()) < 1e-4


def test_yaw_torque_sign():
    env = _quiet_env()
    state, _ = env.step(_hover_state(env),
                        torch.tensor([[0.2, -0.2, 0.2, -0.2]]).repeat(4, 1))
    assert float(state.ang_vel[:, 2].min()) > 0.0
    assert float(state.ang_vel[:, :2].abs().max()) < 1e-5


def test_crash_terminates_and_resets():
    env = _quiet_env()
    state = _hover_state(env)
    state = state._replace(
        pos=torch.cat([state.pos[:, :2], torch.full((4, 1), -0.1)], 1),
        episode_len=torch.full((4,), 5, dtype=torch.int32),
        ep_reward=torch.full((4,), 3.0))
    state, out = env.step(state, torch.zeros(4, 4))
    assert bool(out.done.all()) and not bool(out.time_out.any())
    assert float(out.reward.max()) < 0.0
    np.testing.assert_allclose(state.pos[:, 2].numpy(), env.cfg.init_height,
                               atol=1e-6)
    assert int(state.episode_len.max()) == 0
    assert float(state.ep_reward.abs().max()) == 0.0


def test_timeout_flags():
    env = _quiet_env(max_episode_length_s=0.1)       # 5 control steps
    state, _ = env.reset(4, torch.Generator().manual_seed(0))
    outs = []
    for _ in range(env.max_episode_length):
        state, out = env.step(state, torch.zeros(4, 4))
        outs.append(out)
    assert bool(outs[-1].time_out.all()) and bool(outs[-1].done.all())
    assert not any(bool(o.done.any()) for o in outs[:-1])


def test_reward_registry_scales_by_dt():
    env = _quiet_env(reward_scales={"alive": 2.0, "termination": -5.0,
                                    "orientation": 0.0})
    assert [n for n, _, _ in env.reward_fns] == ["alive"]
    assert env.reward_fns[0][1] == pytest.approx(2.0 * env.dt)
    assert env.termination_scale == pytest.approx(-5.0 * env.dt)
    _, out = env.step(_hover_state(env), torch.zeros(4, 4))
    np.testing.assert_allclose(out.reward.numpy(), 2.0 * env.dt, rtol=1e-6)


def test_command_resampling_and_push():
    env = DroneRobot(DroneRobotConfig(
        domain_rand=DroneDomainRand(randomize_mass=False, push_robots=True,
                                    push_interval_s=0.04, max_push_vel_xy=3.0),
        commands=DroneCommands(resampling_time_s=0.04)), device="cpu")
    assert env.push_interval == 2 and env.resample_interval == 2
    state = _hover_state(env)
    cmd0 = state.commands
    state, _ = env.step(state, torch.zeros(4, 4))          # len=1: no events
    assert torch.equal(state.commands, cmd0)
    vel_before = state.lin_vel[:, :2]
    state, _ = env.step(state, torch.zeros(4, 4))          # len=2: both
    assert not torch.equal(state.commands, cmd0)
    assert not torch.allclose(state.lin_vel[:, :2], vel_before)


def _det_eval(policy, env, steps=80, n=32):
    state, out = env.reset(n, torch.Generator().manual_seed(42))
    tot = 0.0
    for _ in range(steps):
        state, out = env.step(state, policy(out.obs))
        tot += float(out.reward.mean())
    return tot / steps


def test_ppo_learnability():
    """The continuous stack improves velocity tracking on the physics drone
    from scratch (tests/test_drone_robot.py's, at 32 envs and 30
    iterations instead of 64 and 80)."""
    from gennbv_tpu_torch.algo import ppo_continuous as ppoc
    from gennbv_tpu_torch.algo.on_policy_runner import (OnPolicyRunner,
                                                        OnPolicyRunnerConfig)
    env = _quiet_env(max_episode_length_s=2.0)
    runner = OnPolicyRunner(
        env, ppoc.ContinuousPPOConfig(learning_rate=3e-4),
        OnPolicyRunnerConfig(num_steps_per_env=24), num_envs=32, seed=3,
        actor_hidden=(64, 64), critic_hidden=(64, 64))
    runner.learn(1)
    r0 = _det_eval(runner.get_inference_policy(), env)
    runner.learn(30)
    r1 = _det_eval(runner.get_inference_policy(), env)
    assert np.isfinite(r0) and np.isfinite(r1)
    assert r1 > r0 + 0.005, (r0, r1)


# ---------------------------------------------------------------------------
# the registry (TestRegistry of tests/test_misc.py) and the CLI


def test_registry_names_and_drone_task():
    assert registry.task_names() == jax_registry.task_names()
    env, dcfg = registry.make_env("drone_velocity", None, device="cpu")
    assert isinstance(env, DroneRobot) and isinstance(dcfg, DroneRobotConfig)
    assert env.device == torch.device("cpu")
    assert dataclasses.asdict(dcfg) == dataclasses.asdict(
        jax_drone.DroneRobotConfig())
    for robot in ("a1", "anymal_b", "anymal_c", "cassie"):
        with pytest.raises(NotImplementedError, match="item 11"):
            registry.make_env(f"{robot}_velocity", None, device="cpu")
    with pytest.raises(KeyError):
        registry.make_env("humanoid", None, device="cpu")


def test_registry_recon_tasks():
    cfg = apply_overrides(Config(), (
        "env.num_envs=2", "env.scene.num_scenes=2", "env.camera.height=32",
        "env.camera.width=32", "env.renderer.resolution=16"))
    env, env_cfg = registry.make_env("train_gennbv", cfg, device="cpu")
    assert env_cfg.num_envs == 2
    state, out = env.reset(2)
    assert tuple(out.obs.shape) == (2, env.obs_dim)
    env, env_cfg = registry.make_env("eval_gennbv", cfg, device="cpu")
    assert env_cfg.max_episode_length == spec.MAX_EPISODE_LENGTH_EVAL
    assert env.scenes.num_scenes == spec.EVAL_NUM_ENVS
    want = scene_lib.make_scenes(dataclasses.replace(
        cfg.env.scene, num_scenes=spec.EVAL_NUM_ENVS, seed=100), 16, device="cpu")
    assert torch.equal(env.scenes.render_occ, want.render_occ)


def test_train_rsl_cli_and_resume(tmp_path, capsys):
    """Two iterations with a save each, then --resume to three: the resumed
    runner starts at iteration 2 from the saved parameters."""
    log_dir = str(tmp_path / "run")
    args = ["--task", "drone_velocity", "--num_envs", "16",
            "--num_steps_per_env", "8", "--hidden", "32", "16",
            "--log_dir", log_dir, "--save_interval", "1", "--device", "cpu"]
    r1 = train_rsl.main(args + ["--max_iterations", "2"])
    assert r1.iteration == 2
    assert sorted(os.listdir(log_dir)) == ["metrics.jsonl", "model_1.pt",
                                           "model_2.pt"]
    assert train_rsl.newest_checkpoint(log_dir).endswith("model_2.pt")
    saved = torch.load(os.path.join(log_dir, "model_2.pt"), weights_only=True)
    seen = {}
    from gennbv_tpu_torch.algo import on_policy_runner as opr
    orig = opr.OnPolicyRunner.learn

    def spy(self, n, log=False):
        seen["start"] = self.iteration
        seen["params"] = {k: v.clone() for k, v in self.model.state_dict().items()}
        return orig(self, n, log)

    opr.OnPolicyRunner.learn = spy
    try:
        r2 = train_rsl.main(args + ["--max_iterations", "3", "--resume"])
    finally:
        opr.OnPolicyRunner.learn = orig
    assert seen["start"] == 2 and r2.iteration == 3
    for k, v in saved["params"].items():
        assert torch.equal(seen["params"][k], v), k
    assert train_rsl.newest_checkpoint(log_dir).endswith("model_3.pt")
    out = capsys.readouterr().out
    assert "resumed from" in out and "it     3" in out
    with pytest.raises(NotImplementedError, match="item 11"):
        train_rsl.main(args + ["--recurrent"])
    with pytest.raises(NotImplementedError, match="item 11"):
        train_rsl.main(["--task", "a1_velocity", "--device", "cpu"])
    assert train_rsl.parse_args([]).device == "cuda"


def test_newest_checkpoint_orders_by_iteration(tmp_path):
    for name in ("model_9.pt", "model_10.pt", "model_x.pt", "model_11.pt.tmp",
                 "notes.txt"):
        (tmp_path / name).write_text("")
    assert train_rsl.newest_checkpoint(str(tmp_path)).endswith("model_10.pt")
    assert train_rsl.newest_checkpoint(str(tmp_path / "none")) is None
