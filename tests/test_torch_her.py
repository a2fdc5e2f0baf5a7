"""The port's HER (``gennbv_tpu_torch/algo/her.py``) against the JAX
package's on the same numpy inputs and JAX's own draws: segment ends, the
episode buffer's ring writes (with in-round boundaries and the legacy
fixed-length default) and relabeled samples, all exact; then the tests of
tests/test_her.py on the port alone, the learnability ones at their
thresholds."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu.algo import her as jax_her
from gennbv_tpu.env import synthetic as jax_synth
from gennbv_tpu_torch.algo import her as her_lib
from gennbv_tpu_torch.algo.off_policy import OffPolicyConfig
from gennbv_tpu_torch.env.synthetic import GoalPointEnv


def _t(x):
    return torch.from_numpy(np.array(x))


def _dones(rng, n, t_len, p):
    return (rng.uniform(size=(n, t_len)) < p).astype(np.float32)


@pytest.mark.parametrize("p", [0.0, 0.2, 0.6, 1.0])
def test_segment_ends_equal_jax(p):
    d = _dones(np.random.default_rng(int(p * 10)), 64, 9, p)
    want = np.asarray(jax_her.segment_ends(jnp.asarray(d)))
    got = her_lib.segment_ends(_t(d))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _fill(rng, rounds, e_cap=8, n=4, t_len=6, goal_dim=2, boundaries=True,
          p_done=0.3):
    """The same rounds written to a JAX and a port episode buffer."""
    d = 1 + 2 * goal_dim
    jbuf = jax_her.init_episode_buffer(e_cap, t_len, d, goal_dim)
    pbuf = her_lib.init_episode_buffer(e_cap, t_len, d, goal_dim, device="cpu")
    for _ in range(rounds):
        args = [rng.normal(size=(n, t_len + 1, d)).astype(np.float32),
                rng.uniform(-1, 1, (n, t_len, goal_dim)).astype(np.float32)]
        if boundaries:
            done = _dones(rng, n, t_len, p_done)
            args += [done, done * (rng.uniform(size=done.shape) < 0.5)]
        jbuf = jax_her.add_episodes(jbuf, *map(jnp.asarray, args))
        pbuf = her_lib.add_episodes(pbuf, *map(_t, args))
    return jbuf, pbuf


@pytest.mark.parametrize("boundaries", [True, False])
def test_add_episodes_equals_jax(boundaries):
    """Five rounds of 4 envs into a ring of 8 (two wraps): every array,
    pos and size equal, with in-round boundaries and with the legacy
    fixed-length default."""
    rng = np.random.default_rng(1)
    jbuf, pbuf = _fill(rng, 5, boundaries=boundaries)
    assert (pbuf.pos, pbuf.size) == (int(jbuf.pos), int(jbuf.size)) == (4, 8)
    for f in ("obs", "actions", "done", "terminal", "seg_end"):
        want = np.asarray(getattr(jbuf, f))
        got = getattr(pbuf, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _jax_draws(key, size, batch, t_len):
    """The draws jax her.sample_relabeled makes from `key` (:127-150)."""
    r_e, r_t, r_f, r_m = jax.random.split(key, 4)
    return her_lib.RelabelDraws(
        _t(jax.random.randint(r_e, (batch,), 0, max(size, 1))).long(),
        _t(jax.random.randint(r_t, (batch,), 0, t_len)).long(),
        _t(jax.random.randint(r_f, (batch,), 1, t_len + 1)).long(),
        _t(jax.random.uniform(r_m, (batch,))))


def _assert_same_batch(got, want):
    for f in ("obs", "actions", "rewards", "next_obs", "terminals"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("p_done", [0.0, 0.3, 0.7])
@pytest.mark.parametrize("fraction", [0.8, 1.0])
def test_sample_relabeled_from_jax_draws_equals_jax(p_done, fraction):
    """Random rounds (many in-round boundaries at 0.7: consecutive
    one-step episodes, stale indices that fall back to t = 0) sampled with
    JAX's draws: every field equal."""
    rng = np.random.default_rng(int(10 * p_done))
    jbuf, pbuf = _fill(rng, 3, p_done=p_done)
    jenv = jax_synth.GoalPointEnv(dim=2)
    env = GoalPointEnv(dim=2, device="cpu")
    cfg = (jax_her.HERConfig(future_fraction=fraction),
           her_lib.HERConfig(future_fraction=fraction))
    key = jax.random.PRNGKey(int(100 * p_done + fraction))
    want = jax_her.sample_relabeled(jbuf, key, 512, 2, jenv.compute_reward,
                                    cfg[0])
    got = her_lib.relabel(pbuf, _jax_draws(key, pbuf.size, 512, 6), 2,
                          env.compute_reward, cfg[1])
    _assert_same_batch(got, want)


def _boundary_buffers(lib, np_lib, device):
    """tests/test_her.py's round (:62-101): episode A = steps 0..2 (done
    at 2, pos .1/.2/.3), episode B = steps 3..5 (pos 7.1/7.2/7.3); obs[3]
    is A's terminal (pre-reset contract), so transition 3 is stale."""
    pos = np_lib.asarray([0.0, 0.1, 0.2, 0.3, 7.1, 7.2, 7.3], np.float32)[:, None]
    goal = np.full((7, 1), 9.0, np.float32)
    obs_seq = np.concatenate([pos, pos, goal], axis=-1)[None]
    acts = np.ones((1, 6, 1), np.float32)
    done = np.asarray([[0.0, 0.0, 1.0, 0.0, 0.0, 1.0]], np.float32)
    timeout = np.asarray([[0.0, 0.0, 0.0, 0.0, 0.0, 1.0]], np.float32)
    args = [np.tile(obs_seq, (4, 1, 1)), np.tile(acts, (4, 1, 1)),
            np.tile(done, (4, 1)), np.tile(timeout, (4, 1))]
    if lib is her_lib:
        buf = lib.init_episode_buffer(4, 6, 3, 1, device=device)
        return lib.add_episodes(buf, *map(_t, args))
    buf = lib.init_episode_buffer(4, 6, 3, 1)
    return lib.add_episodes(buf, *map(jnp.asarray, args))


def test_sample_relabeled_at_segment_boundaries_equals_jax():
    """The boundary round of tests/test_her.py with JAX's draws: the
    stale shift and the segment clamping give the same batch."""
    jbuf = _boundary_buffers(jax_her, np, None)
    pbuf = _boundary_buffers(her_lib, np, "cpu")
    np.testing.assert_array_equal(pbuf.seg_end[0].numpy(), [2, 2, 2, 5, 5, 5])
    jenv = jax_synth.GoalPointEnv(dim=1, ep_length=6)
    env = GoalPointEnv(dim=1, ep_length=6, device="cpu")
    key = jax.random.PRNGKey(0)
    want = jax_her.sample_relabeled(jbuf, key, 512, 1, jenv.compute_reward,
                                    jax_her.HERConfig(future_fraction=1.0))
    got = her_lib.relabel(pbuf, _jax_draws(key, pbuf.size, 512, 6), 1,
                          env.compute_reward,
                          her_lib.HERConfig(future_fraction=1.0))
    _assert_same_batch(got, want)


# ---------------------------------------------------------------------------
# tests/test_her.py on the port


def test_relabel_semantics():
    """Relabeled transitions must use a FUTURE achieved goal of the same
    episode and recompute the reward accordingly."""
    env = GoalPointEnv(dim=1, ep_length=4, device="cpu")
    buf = her_lib.init_episode_buffer(4, 4, env.obs_dim, 1, device="cpu")
    pos = torch.tensor([0.0, 0.1, 0.2, 0.3, 0.4])[:, None]
    goal = torch.full((5, 1), 9.0)
    obs_seq = torch.cat([pos, pos, goal], dim=-1)[None]  # [1, 5, 3]
    acts = torch.ones((1, 4, 1))
    buf = her_lib.add_episodes(buf, obs_seq.repeat(4, 1, 1), acts.repeat(4, 1, 1))
    batch = her_lib.sample_relabeled(
        buf, torch.Generator().manual_seed(0), 256, env.goal_dim,
        env.compute_reward, her_lib.HERConfig(future_fraction=1.0, goal_eps=0.1))
    g = batch.obs[:, -1].numpy()
    achieved_next = batch.next_obs[:, 1].numpy()
    assert np.isin(np.round(g.astype(np.float64), 5), [0.1, 0.2, 0.3, 0.4]).all()
    assert (g >= achieved_next - 1e-6).all()
    rew = batch.rewards.numpy()
    hit = np.abs(achieved_next - g) < 0.1
    np.testing.assert_array_equal(rew == 0.0, hit)


def test_relabel_respects_segment_boundaries():
    """With in-round episode boundaries (auto-reset envs), relabeled future
    goals must come from the SAME episode segment, never across a reset."""
    env = GoalPointEnv(dim=1, ep_length=6, device="cpu")
    buf = _boundary_buffers(her_lib, np, "cpu")
    batch = her_lib.sample_relabeled(
        buf, torch.Generator().manual_seed(0), 512, env.goal_dim,
        env.compute_reward, her_lib.HERConfig(future_fraction=1.0))
    obs_pos = batch.obs[:, 0].numpy()
    g = batch.obs[:, -1].numpy()
    ep_a = obs_pos < 1.0
    assert np.isin(np.round(g[ep_a].astype(np.float64), 5), [0.1, 0.2, 0.3]).all()
    assert np.isin(np.round(g[~ep_a].astype(np.float64), 5), [7.2, 7.3]).all()
    stale = (np.abs(obs_pos - 0.3) < 1e-6) & (
        np.abs(batch.next_obs[:, 0].numpy() - 7.2) < 1e-6)
    assert not stale.any()
    term_t2 = np.abs(obs_pos - 0.2) < 1e-6
    np.testing.assert_array_equal(batch.terminals.numpy()[term_t2], 1.0)


def _success_rate(env, runner) -> float:
    pol = runner.exploit_policy()
    st, out = env.reset(256, torch.Generator().manual_seed(7))
    obs = out.obs
    success = torch.zeros(256, dtype=torch.bool)
    for _ in range(8):
        st, out = env.step(st, pol(obs))
        obs = out.obs
        success = success | (out.reward == 0.0)
    return float(success.float().mean())


@pytest.mark.parametrize("terminate_on_success,rounds", [(False, 120),
                                                         (True, 90)])
def test_her_learns_sparse_goal(terminate_on_success, rounds):
    """Fixed-length episodes (120 rounds) and, with terminate_on_success,
    variable-length ones (90 rounds; boundary-safe relabeling), as
    tests/test_her.py trains them; a random policy succeeds ~2-5%."""
    env = GoalPointEnv(dim=2, ep_length=8,
                       terminate_on_success=terminate_on_success, device="cpu")
    runner = her_lib.HERRunner(
        env, OffPolicyConfig(algo="sac", batch_size=256, learning_starts=2048,
                             learning_rate=1e-3),
        her_lib.HERConfig(future_fraction=0.8), num_envs=32,
        capacity_episodes=2048, seed=0, updates_per_round=32)
    runner.learn(rounds)
    rate = _success_rate(env, runner)
    assert rate > 0.3, rate
