"""The port's env contract pieces against the JAX package's: the running
normalizer (``utils/normalizer.py``), the synthetic envs
(``env/synthetic.py``), the env checker (``utils/env_checker.py``) and the
wrappers (``env/wrappers.py``), on the same numpy inputs; then the tests of
tests/test_wrappers.py, the check_env tests of tests/test_aux.py and
TestNormalizer of tests/test_misc.py on the port alone."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu.env import synthetic as jax_synth
from gennbv_tpu.env import wrappers as jax_wrappers
from gennbv_tpu.utils import normalizer as jax_norm
from gennbv_tpu_torch import spec
from gennbv_tpu_torch.config import (CameraConfig, EnvConfig, RendererConfig,
                                     SceneConfig)
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.env import wrappers
from gennbv_tpu_torch.env.drone_robot import DroneRobot
from gennbv_tpu_torch.env.synthetic import (GoalPointEnv,
                                            IdentityEnvMultiDiscrete,
                                            PointGoalEnv, SynthOutput)
from gennbv_tpu_torch.utils import normalizer
from gennbv_tpu_torch.utils.env_checker import check_env

# Chan's update and the normalization: float32 means, variances and a
# division, each summed in another order than XLA's: 1e-6 relative
NORM_RTOL, NORM_ATOL = 1e-6, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# the normalizer


def test_normalizer_matches_jax():
    rng = np.random.default_rng(0)
    js, ps = jax_norm.init(5), normalizer.init(5, device="cpu")
    for _ in range(6):
        batch = rng.normal(3.0, 2.0, (64, 5)).astype(np.float32)
        js = jax_norm.update(js, jnp.asarray(batch))
        ps = normalizer.update(ps, _t(batch))
        for field in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(ps, field).numpy(),
                                       np.asarray(getattr(js, field)),
                                       rtol=NORM_RTOL, atol=NORM_ATOL,
                                       err_msg=field)
    x = rng.normal(3.0, 30.0, (16, 5)).astype(np.float32)
    for clip in (10.0, 0.5):
        np.testing.assert_allclose(normalizer.normalize(ps, _t(x), clip).numpy(),
                                   np.asarray(jax_norm.normalize(js, x, clip)),
                                   rtol=NORM_RTOL, atol=NORM_ATOL)
    js = jax_norm.init(spec.STATE_DIM)
    js = js._replace(mean=jnp.linspace(-2, 5, spec.STATE_DIM),
                     var=jnp.linspace(0.5, 3, spec.STATE_DIM))
    ps = normalizer.NormalizerState(*(_t(v) for v in js))
    obs = rng.normal(0, 4, (3, spec.OBS_DIM)).astype(np.float32)
    got = normalizer.normalize_obs_state_slice(ps, _t(obs)).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jax_norm.normalize_obs_state_slice(js, jnp.asarray(obs))),
        rtol=NORM_RTOL, atol=NORM_ATOL)


class TestNormalizer:
    def test_running_stats_converge(self):
        rng = np.random.RandomState(0)
        st = normalizer.init(4, device="cpu")
        for _ in range(50):
            batch = rng.normal(3.0, 2.0, size=(64, 4)).astype(np.float32)
            st = normalizer.update(st, _t(batch))
        np.testing.assert_allclose(st.mean.numpy(), 3.0, atol=0.2)
        np.testing.assert_allclose(np.sqrt(st.var.numpy()), 2.0, atol=0.2)
        assert abs(float(normalizer.normalize(st, _t(batch)).mean())) < 0.3

    def test_state_slice_only(self):
        st = normalizer.init(spec.STATE_DIM, device="cpu")
        st = st._replace(mean=torch.full((spec.STATE_DIM,), 5.0))
        obs = torch.ones(2, spec.OBS_DIM)
        out = normalizer.normalize_obs_state_slice(st, obs)
        assert float(out[0, 0]) != 1.0
        assert torch.equal(out[:, spec.STATE_DIM:], obs[:, spec.STATE_DIM:])


# ---------------------------------------------------------------------------
# the synthetic envs: their deterministic parts against JAX


def test_identity_env_matches_jax():
    jenv = jax_synth.IdentityEnvMultiDiscrete(nvec=(3, 4), ep_length=5)
    penv = IdentityEnvMultiDiscrete(nvec=(3, 4), ep_length=5, device="cpu")
    js, jo = jenv.reset(6, jax.random.PRNGKey(0))
    ps, po = penv.reset(6, _gen())
    assert po.obs.shape == (6, 7) and po.obs.dtype == torch.float32
    ps = ps._replace(target=_t(js.target))
    rng = np.random.default_rng(1)
    for t in range(4):                        # no episode ends: no resample
        a = np.where(rng.random((6, 1)) < 0.5, np.asarray(js.target),
                     rng.integers(0, 3, (6, 2))).astype(np.int32)
        js, jo = jenv.step(js, jnp.asarray(a))
        ps, po = penv.step(ps, _t(a))
        for f in ("obs", "reward", "done", "time_out"):
            np.testing.assert_array_equal(getattr(po, f).numpy(),
                                          np.asarray(getattr(jo, f)), err_msg=f)
        np.testing.assert_array_equal(ps.episode_len.numpy(),
                                      np.asarray(js.episode_len))


def test_point_and_goal_envs_match_jax():
    rng = np.random.default_rng(2)
    jenv = jax_synth.PointGoalEnv(dim=3, ep_length=10)
    penv = PointGoalEnv(dim=3, ep_length=10, device="cpu")
    js, _ = jenv.reset(8, jax.random.PRNGKey(0))
    ps = penv.reset(8, _gen())[0]._replace(target=_t(js.target))
    for _ in range(5):
        a = rng.normal(size=(8, 3)).astype(np.float32)
        js, jo = jenv.step(js, jnp.asarray(a))
        ps, po = penv.step(ps, _t(a))
        np.testing.assert_allclose(po.obs.numpy(), np.asarray(jo.obs), rtol=1e-6)
        # a float32 norm of 3 terms
        np.testing.assert_allclose(po.reward.numpy(), np.asarray(jo.reward),
                                   rtol=1e-6)
    for tos in (False, True):
        jenv = jax_synth.GoalPointEnv(dim=2, ep_length=4, goal_eps=0.3,
                                      terminate_on_success=tos)
        penv = GoalPointEnv(dim=2, ep_length=4, goal_eps=0.3,
                            terminate_on_success=tos, device="cpu")
        jst, _ = jenv.reset(64, jax.random.PRNGKey(1))
        pst = (_t(jst[0]), _t(jst[1]), _t(jst[2]), penv.reset(64, _gen())[0][3])
        a = (0.8 * (np.asarray(jst[1]) - np.asarray(jst[0])) / 0.25).astype(np.float32)
        jst, jo = jenv.step(jst, jnp.asarray(a))
        pst, po = penv.step(pst, _t(a))
        for f in ("obs", "reward", "done", "time_out"):
            np.testing.assert_allclose(getattr(po, f).numpy(),
                                       np.asarray(getattr(jo, f)), rtol=1e-6,
                                       err_msg=f)
        assert bool(po.done.any()) == tos and bool((po.reward == 0).any())
        got = penv.compute_reward(_t(a[:, :2]), _t(a[:, :2] + 0.2))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jenv.compute_reward(a[:, :2], a[:, :2] + 0.2)))


def test_identity_env_contract():
    env = IdentityEnvMultiDiscrete(nvec=(3, 4), ep_length=5, device="cpu")
    state, out = env.reset(6, _gen())
    assert out.obs.shape == (6, 7)
    _, out2 = env.step(state, state.target)
    assert torch.all(out2.reward == 1.0)
    wrong = (state.target + 1) % torch.tensor([3, 4])
    _, out3 = env.step(state, wrong)
    assert torch.all(out3.reward == 0.0)
    s = state
    for _ in range(5):
        s, o = env.step(s, s.target)
    assert bool(o.done.all())


def test_synthetic_steps_are_functions_of_state_and_actions():
    """The state carries the random state: the same (state, actions)
    re-spawns the same way, and the caller's generator is untouched."""
    env = PointGoalEnv(dim=2, ep_length=1, device="cpu")
    g = _gen(4)
    state, _ = env.reset(8, g)
    before = g.get_state()
    a = torch.zeros(8, 2)
    (s1, o1), (s2, o2) = env.step(state, a), env.step(state, a)
    assert bool(o1.done.all())
    assert torch.equal(o1.obs, o2.obs) and torch.equal(s1.rng, s2.rng)
    assert not torch.equal(o1.obs, state.target)          # re-spawned
    assert torch.equal(g.get_state(), before)
    s3, o3 = env.step(s1, a)
    assert not torch.equal(o3.obs, o1.obs)                # the stream moves on


# ---------------------------------------------------------------------------
# the env checker (tests/test_aux.py:28-55)


def _tiny_recon_env():
    cfg = EnvConfig(num_envs=4, camera=CameraConfig(height=16, width=16),
                    renderer=RendererConfig(resolution=16),
                    scene=SceneConfig(num_scenes=2, seed=0), max_episode_length=5)
    return ReconEnv(cfg, make_scenes(cfg.scene, cfg.renderer.resolution,
                                     device="cpu"))


def test_check_env_passes_on_all_envs():
    check_env(IdentityEnvMultiDiscrete(nvec=(3, 4), ep_length=4, device="cpu"))
    check_env(PointGoalEnv(dim=2, ep_length=4, device="cpu"))
    check_env(GoalPointEnv(dim=2, ep_length=3, device="cpu"))
    check_env(DroneRobot(device="cpu"))
    check_env(_tiny_recon_env())


def test_check_env_catches_violation():
    class BadEnv:
        num_actions = 2
        obs_dim = 3
        device = torch.device("cpu")

        def reset(self, n, rng=None):
            return (torch.zeros(n),), SynthOutput(
                torch.zeros(n, 3), torch.zeros(n), torch.zeros(n, dtype=torch.bool),
                torch.zeros(n, dtype=torch.bool))

        def step(self, state, actions):
            n = actions.shape[0]
            return state, SynthOutput(
                torch.full((n, 3), float("nan")), torch.zeros(n),
                torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.bool))

    with pytest.raises(AssertionError, match="non-finite obs"):
        check_env(BadEnv())

    class DriftingEnv(BadEnv):
        def step(self, state, actions):
            n = actions.shape[0]
            return (torch.zeros(n + 1),), SynthOutput(
                torch.zeros(n, 3), torch.zeros(n),
                torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool))

    with pytest.raises(AssertionError, match="state shapes"):
        check_env(DriftingEnv())


# ---------------------------------------------------------------------------
# the wrappers against JAX's, over an env without randomness


class _JaxRamp:
    """pos += action, reward = sum(pos); episodes of 3 steps, then pos
    restarts at 0.1 * (env index + 1)."""
    num_actions = obs_dim = 2

    def _start(self, n):
        return jnp.tile((0.1 * (jnp.arange(n) + 1.0))[:, None], (1, 2))

    def reset(self, num_envs):
        z = jnp.zeros(num_envs, bool)
        return (self._start(num_envs), jnp.zeros(num_envs, jnp.int32)), \
            jax_synth.SynthOutput(self._start(num_envs), jnp.zeros(num_envs), z, z)

    def step(self, state, actions):
        pos, ln = state
        pos = pos + actions
        reward = pos.sum(-1)
        ln = ln + 1
        done = ln >= 3
        pos = jnp.where(done[:, None], self._start(pos.shape[0]), pos)
        return (pos, jnp.where(done, 0, ln)), jax_synth.SynthOutput(
            pos, reward, done, done)


class _Ramp:
    num_actions = obs_dim = 2
    device = torch.device("cpu")

    def _start(self, n):
        return (0.1 * (torch.arange(n) + 1.0))[:, None].repeat(1, 2)

    def reset(self, num_envs):
        z = torch.zeros(num_envs, dtype=torch.bool)
        return (self._start(num_envs), torch.zeros(num_envs, dtype=torch.int32)), \
            SynthOutput(self._start(num_envs), torch.zeros(num_envs), z, z)

    def step(self, state, actions):
        pos, ln = state
        pos = pos + actions
        reward = pos.sum(-1)
        ln = ln + 1
        done = ln >= 3
        pos = torch.where(done[:, None], self._start(pos.shape[0]), pos)
        return (pos, torch.where(done, 0, ln)), SynthOutput(pos, reward, done, done)


@pytest.mark.parametrize("name,kw", [
    ("NormalizeWrapper", dict(gamma=0.9)),
    ("NormalizeWrapper", dict(norm_reward=False, clip_obs=1.0)),
    ("FrameStackWrapper", dict(k=3)),
    ("MonitorWrapper", {}),
    ("CheckNanWrapper", {}),
    ("ClipActionWrapper", dict(lo=-0.2, hi=0.3)),
])
def test_wrapper_matches_jax(name, kw):
    """Eight steps (episodes end at 3 and 6) with the same actions, NaN
    actions in one env at the seventh: every output field and the
    wrapper's state."""
    jw = getattr(jax_wrappers, name)(_JaxRamp(), **kw)
    pw = getattr(wrappers, name)(_Ramp(), **kw)
    jst, jo = jw.reset(4)
    pst, po = pw.reset(4)
    rng = np.random.default_rng(0)
    for t in range(8):
        assert po._fields == jo._fields
        for f in po._fields:
            np.testing.assert_allclose(getattr(po, f).numpy(),
                                       np.asarray(getattr(jo, f)),
                                       rtol=NORM_RTOL, atol=NORM_ATOL,
                                       err_msg=f"{f} after {t} steps")
        a = rng.normal(size=(4, 2)).astype(np.float32)
        if t == 6:
            a[1] = np.nan
        jst, jo = jw.step(jst, jnp.asarray(a))
        pst, po = pw.step(pst, _t(a))
    jleaves = jax.tree.leaves(jst.extra)
    pleaves = jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), pst.extra))
    assert len(jleaves) == len(pleaves)
    for j, p in zip(jleaves, pleaves):
        np.testing.assert_allclose(p, np.asarray(j), rtol=NORM_RTOL, atol=NORM_ATOL)


# ---------------------------------------------------------------------------
# the tests of tests/test_wrappers.py, on the port alone


def test_wrappers_pass_env_checker():
    base = PointGoalEnv(dim=2, ep_length=4, device="cpu")
    for wrap in (wrappers.NormalizeWrapper(base),
                 wrappers.FrameStackWrapper(base, k=3),
                 wrappers.MonitorWrapper(base), wrappers.CheckNanWrapper(base),
                 wrappers.ClipActionWrapper(base),
                 wrappers.ObsNoiseWrapper(base, 0.01),
                 wrappers.NormalizeWrapper(DroneRobot(device="cpu"))):
        check_env(wrap)


def test_normalize_wrapper_stats_converge():
    env = wrappers.NormalizeWrapper(PointGoalEnv(dim=2, ep_length=8, device="cpu"),
                                    gamma=0.9)
    g = _gen()
    state, out = env.reset(64, g)
    for _ in range(30):
        state, out = env.step(state, torch.randn(64, 2, generator=g))
    o = out.obs.numpy()
    assert abs(o.mean()) < 0.5 and 0.3 < o.std() < 3.0
    assert float(out.reward.abs().max()) <= 10.0
    assert float(state.extra["obs"].count) > 64 * 30


def test_frame_stack_semantics():
    env = wrappers.FrameStackWrapper(PointGoalEnv(dim=2, ep_length=100,
                                                  device="cpu"), k=3)
    assert env.obs_dim == 6
    state, out = env.reset(4, _gen())
    first = out.obs.numpy()
    np.testing.assert_array_equal(first[:, 0:2], first[:, 2:4])
    np.testing.assert_array_equal(first[:, 2:4], first[:, 4:6])
    state, out2 = env.step(state, torch.full((4, 2), 0.1))
    stacked = out2.obs.numpy()
    np.testing.assert_allclose(stacked[:, 2:4], first[:, 4:6], rtol=1e-6)
    np.testing.assert_allclose(stacked[:, 4:6], first[:, 4:6] + 0.1, rtol=1e-5)


def test_monitor_wrapper_episode_accounting():
    env = wrappers.MonitorWrapper(PointGoalEnv(dim=2, ep_length=3, device="cpu"))
    state, out = env.reset(8, _gen())
    rets = []
    for _ in range(3):
        state, out = env.step(state, torch.zeros(8, 2))
        rets.append(out.reward.numpy())
    assert bool(out.done.all())
    np.testing.assert_allclose(out.ep_len.numpy(), 3.0)
    np.testing.assert_allclose(out.ep_return.numpy(), np.sum(rets, axis=0),
                               rtol=1e-5)


def test_checknan_flags_bad_actions():
    env = wrappers.CheckNanWrapper(PointGoalEnv(dim=2, ep_length=10, device="cpu"))
    state, out = env.reset(4, _gen())
    assert not bool(out.invalid.any())
    state, out = env.step(state, torch.full((4, 2), float("nan")))
    assert bool(out.invalid.all())


def test_clip_action_wrapper():
    env = wrappers.ClipActionWrapper(PointGoalEnv(dim=1, ep_length=10,
                                                  device="cpu"), lo=-0.5, hi=0.5)
    state, out = env.reset(2, _gen())
    pos0 = out.obs.numpy()
    state, out = env.step(state, torch.full((2, 1), 100.0))
    np.testing.assert_allclose(out.obs.numpy(), pos0 + 0.5, rtol=1e-6)


def test_obs_noise_wrapper_scale_and_resampling():
    """Noise is bounded by the per-component vector, zero where the vector
    is zero, and resampled every step."""
    base = PointGoalEnv(dim=2, ep_length=8, device="cpu")
    vec = torch.zeros(base.obs_dim)
    vec[0] = 0.5
    env = wrappers.ObsNoiseWrapper(base, vec)
    ws, out = env.reset(16, _gen())
    a = torch.zeros(16, base.num_actions)
    _, c1 = base.step(ws.inner, a)
    ws, o1 = env.step(ws, a)
    assert torch.equal(o1.obs[:, 1:], c1.obs[:, 1:])
    d = (o1.obs[:, 0] - c1.obs[:, 0]).numpy()
    assert (np.abs(d) <= 0.5).all() and np.abs(d).max() > 0.0
    _, c2 = base.step(ws.inner, a)
    ws, o2 = env.step(ws, a)
    d2 = (o2.obs[:, 0] - c2.obs[:, 0]).numpy()
    assert np.abs(d2 - d).max() > 0.0
    # without a generator the reset seeds one with 0, as the JAX wrapper's
    # PRNGKey(0): two resets agree
    _, r1 = wrappers.ObsNoiseWrapper(_Ramp(), 0.5).reset(4)
    _, r2 = wrappers.ObsNoiseWrapper(_Ramp(), 0.5).reset(4)
    assert torch.equal(r1.obs, r2.obs)
