"""The port's off-policy family (``gennbv_tpu_torch/models/off_policy_nets.py``,
``algo/replay_buffer.py``, ``algo/off_policy.py``, ``algo/dqn.py``) against
the JAX package's on the same numpy inputs and JAX's own random draws: each
network from converted weights, the squashed sample, the ring buffer and
its gather, three consecutive SAC, TD3 and DDPG updates, three DQN updates
across a target sync, and DQN's epsilon; then the learner tests of
tests/test_off_policy.py on the port alone, at their thresholds."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu.algo import dqn as jax_dqn
from gennbv_tpu.algo import off_policy as jax_op
from gennbv_tpu.algo import replay_buffer as jax_rb
from gennbv_tpu.env import synthetic as jax_synth
from gennbv_tpu.models import off_policy_nets as jax_nets
from gennbv_tpu_torch.algo import replay_buffer as rb
from gennbv_tpu_torch.algo.dqn import DQNConfig, DQNRunner, DQNState
from gennbv_tpu_torch.algo.off_policy import (OffPolicyConfig, OffPolicyLearner,
                                              OffPolicyRunner, OffPolicyState)
from gennbv_tpu_torch.env.synthetic import IdentityEnvMultiDiscrete, PointGoalEnv
from gennbv_tpu_torch.models import convert, off_policy_nets as nets

OBS, ACT, B, HIDDEN = 5, 2, 32, (32, 32)
LR = 1e-3
# the MLP forward: float32 dot products of <= 32 terms summed in another
# order, ~1e-7 relative to the terms
FORWARD_RTOL, FORWARD_ATOL = 1e-5, 1e-6
# float32 elementwise formulas evaluated in another order (XLA fuses the
# JAX side into FMAs): a few ulps of the log-prob's terms (up to ~50)
SAMPLE_ATOL = 1e-5
# After each update.  Gradients agree to ~1e-7 of their tensor's largest
# entry (float32 sums in another order), so Adam's moments are held to
# 1e-4 relative plus a share of the tensor's largest moment (as
# tests/test_torch_ppo.py derives them; second moments are squares, hence
# twice the share), and a parameter moves by lr * m / (sqrt(v) + eps)
# within PARAM_ATOL.  The exception is an entry whose gradient is at that
# float32 noise (a first moment inside the share of its tensor's
# largest): Adam's first step is lr * g / (|g| + 1e-8),
# so there the two sides' noise moves the entry by up to lr a step
# either way.  Such entries (marked at every update from JAX's moments)
# are held to lr per update taken, their moments to the share.  A polyak
# target is a blend XLA may fuse into one FMA: an ulp of PARAM_ATOL.
PARAM_ATOL = 1e-6
MOMENT_RTOL = 1e-4
MOMENT_SCALE_TOL = {"mu": 2e-5, "nu": 4e-5}
# losses, Q means and alpha: float32 means over the batch
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(rng, n=B, discrete=0):
    acts = (rng.integers(0, discrete, (n, 1)).astype(np.int32) if discrete
            else rng.uniform(-1, 1, (n, ACT)).astype(np.float32))
    obs_dim = discrete or OBS
    return dict(obs=rng.normal(size=(n, obs_dim)).astype(np.float32),
                actions=acts,
                rewards=(3 * rng.normal(size=n)).astype(np.float32),
                next_obs=rng.normal(size=(n, obs_dim)).astype(np.float32),
                terminals=(rng.uniform(size=n) < 0.2).astype(np.float32))


# ---------------------------------------------------------------------------
# the networks


NETS = {
    "twin_q": (lambda: jax_nets.QCritic(HIDDEN),
               lambda: nets.QCritic(OBS, ACT, HIDDEN, device="cpu"), True),
    "single_q": (lambda: jax_nets.QCritic(HIDDEN, n_critics=1),
                 lambda: nets.QCritic(OBS, ACT, HIDDEN, 1, device="cpu"), True),
    "deterministic": (lambda: jax_nets.DeterministicActor(ACT, 2.0, HIDDEN),
                      lambda: nets.DeterministicActor(OBS, ACT, 2.0, HIDDEN,
                                                      device="cpu"), False),
    "squashed": (lambda: jax_nets.SquashedGaussianActor(ACT, 1.0, HIDDEN),
                 lambda: nets.SquashedGaussianActor(OBS, ACT, 1.0, HIDDEN,
                                                    device="cpu"), False),
    "discrete_q": (lambda: jax_nets.DiscreteQNet(4, HIDDEN),
                   lambda: nets.DiscreteQNet(OBS, 4, HIDDEN, device="cpu"), False),
}


@pytest.mark.parametrize("name", list(NETS))
def test_net_forward_from_converted_params(name):
    make_jax, make_port, takes_actions = NETS[name]
    rng = np.random.default_rng(0)
    args = [(4 * rng.normal(size=(16, OBS))).astype(np.float32)]
    if takes_actions:
        args.append(rng.uniform(-1, 1, (16, ACT)).astype(np.float32))
    jm = make_jax()
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), *args)["params"])
    sd = convert.off_policy_net_to_state_dict(params)
    pm = make_port()
    assert sorted(sd) == sorted(pm.state_dict())
    pm.load_state_dict(sd)
    want = jm.apply({"params": params}, *args)
    with torch.no_grad():
        got = pm(*map(_t, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FORWARD_RTOL,
                                   atol=FORWARD_ATOL)


def test_squashed_sample_from_jax_noise():
    rng = np.random.default_rng(2)
    mean = (2 * rng.normal(size=(64, 3))).astype(np.float32)
    log_std = rng.uniform(-5, 2, (64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want_a, want_logp = jax_nets.squashed_sample(mean, log_std, key, 1.5)
    noise = np.asarray(jax.random.normal(key, mean.shape))
    a, logp = nets.squashed_sample(_t(mean), _t(log_std), _t(noise), 1.5)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=0,
                               atol=SAMPLE_ATOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(want_logp), rtol=1e-6,
                               atol=SAMPLE_ATOL)


# ---------------------------------------------------------------------------
# the replay buffer: exact


def _rb_fields(buf):
    return {f: np.asarray(getattr(buf, f)) for f in
            ("obs", "actions", "rewards", "next_obs", "terminals")}


@pytest.mark.parametrize("action_dtype", ["float32", "int32"])
def test_ring_writes_wrap_and_terminals_equal_jax(action_dtype):
    """Six writes of 4 into a ring of 12 (two wraps), with dones and
    timeouts (and one write without timeouts): every array, pos and size
    equal the JAX buffer's after each write; then the JAX buffer's own
    test of the ring on the port."""
    rng = np.random.default_rng(4)
    jbuf = jax_rb.init(12, 3, 2, getattr(jnp, action_dtype))
    pbuf = rb.init(12, 3, 2, getattr(torch, action_dtype), device="cpu")
    for k in range(6):
        acts = (rng.integers(-5, 5, (4, 2)) if action_dtype == "int32"
                else rng.normal(size=(4, 2))).astype(action_dtype)
        args = [rng.normal(size=(4, 3)).astype(np.float32), acts,
                rng.normal(size=4).astype(np.float32),
                rng.normal(size=(4, 3)).astype(np.float32),
                rng.uniform(size=4) < 0.5]
        if k != 3:
            args.append(rng.uniform(size=4) < 0.5)
        jbuf = jax_rb.add_batch(jbuf, *map(jnp.asarray, args))
        pbuf = rb.add_batch(pbuf, *map(_t, args))
        assert (pbuf.pos, pbuf.size) == (int(jbuf.pos), int(jbuf.size))
        for f, want in _rb_fields(jbuf).items():
            got = getattr(pbuf, f)
            assert str(got.dtype).endswith(str(want.dtype)), f
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    assert (pbuf.pos, pbuf.size) == (0, 12)


def test_ring_semantics_of_the_jax_test():
    buf = rb.init(8, obs_dim=2, action_dim=1, device="cpu")

    def mk(v, n=4):
        return (torch.full((n, 2), v), torch.full((n, 1), v), torch.full((n,), v),
                torch.full((n, 2), v + 0.5), torch.zeros(n, dtype=torch.bool))

    buf = rb.add_batch(buf, *mk(1.0))
    assert buf.size == 4 and buf.pos == 4
    buf = rb.add_batch(buf, *mk(2.0))
    buf = rb.add_batch(buf, *mk(3.0))   # wraps, overwrites the 1.0 batch
    assert buf.size == 8 and buf.pos == 4
    assert set(np.unique(buf.obs.numpy())) == {2.0, 3.0}
    n = 4
    buf = rb.add_batch(buf, torch.zeros(n, 2), torch.zeros(n, 1), torch.zeros(n),
                       torch.zeros(n, 2), torch.ones(n, dtype=torch.bool),
                       torch.ones(n, dtype=torch.bool))
    assert float(buf.terminals[0:4].sum()) == 0.0
    assert rb.sample(buf, torch.Generator().manual_seed(0), 16).obs.shape == (16, 2)
    with pytest.raises(ValueError):
        rb.add_batch(buf, *mk(4.0, n=3))


@pytest.mark.parametrize("fill", [12, 20, 48])
def test_gather_from_jax_indices_equals_jax_sample(fill):
    """A partly filled, a wrapped and a full ring; JAX's sample draws its
    indices with randint over the filled slots, which the port's gather
    takes."""
    rng = np.random.default_rng(fill)
    jbuf = jax_rb.init(48, 3, 2)
    pbuf = rb.init(48, 3, 2, device="cpu")
    for _ in range(fill // 4):
        args = [rng.normal(size=(4, 3)).astype(np.float32),
                rng.normal(size=(4, 2)).astype(np.float32),
                rng.normal(size=4).astype(np.float32),
                rng.normal(size=(4, 3)).astype(np.float32),
                rng.uniform(size=4) < 0.5]
        jbuf = jax_rb.add_batch(jbuf, *map(jnp.asarray, args))
        pbuf = rb.add_batch(pbuf, *map(_t, args))
    key = jax.random.PRNGKey(fill)
    want = jax_rb.sample(jbuf, key, 64)
    idx = np.asarray(jax.random.randint(key, (64,), 0, max(fill, 1)))
    got = rb.gather(pbuf, _t(idx).long())
    for f in rb.Batch._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


# ---------------------------------------------------------------------------
# SAC / TD3 / DDPG updates


def _port_state(js) -> OffPolicyState:
    c = convert.off_policy_net_to_state_dict

    def scalar(x):
        return {"log_alpha": _t(np.asarray(x, np.float32))}

    return OffPolicyState(
        c(js.actor_params), c(js.critic_params), c(js.target_actor_params),
        c(js.target_critic_params),
        convert.jax_opt_state_to_port(js.actor_opt, c),
        convert.jax_opt_state_to_port(js.critic_opt, c),
        _t(np.asarray(js.log_alpha, np.float32)),
        convert.jax_opt_state_to_port(js.alpha_opt, scalar), int(js.step))


def _assert_params(label, got: dict, want: dict, noisy: dict, steps: int):
    for name, w in want.items():
        tol = np.where(noisy[name], steps * LR, PARAM_ATOL)
        err = np.abs(got[name].numpy() - w.numpy())
        assert (err <= tol).all(), (label, name, float(err.max()))


def _mark_noise(noisy: dict, mu: dict) -> None:
    for name, m in mu.items():
        m = np.abs(m.numpy())
        noisy[name] = noisy.get(name, False) | (
            m <= MOMENT_SCALE_TOL["mu"] * m.max())


def _assert_opt(label, got, want, noisy):
    assert got.count == want.count, label
    for moment in ("mu", "nu"):
        for name, w in getattr(want, moment).items():
            w = w.numpy()
            g = getattr(got, moment)[name].numpy()
            band = MOMENT_SCALE_TOL[moment] * float(np.abs(w).max())
            tol = np.where(noisy[name], 2 * band, MOMENT_RTOL * np.abs(w) + band)
            err = np.abs(g - w)
            assert (err <= tol).all(), (label, moment, name, float(err.max()))


@pytest.mark.parametrize("algo", ["sac", "td3", "ddpg"])
def test_three_updates_equal_jax(algo):
    """Three consecutive updates from the JAX learner's converted initial
    state on three batches, each with the JAX update's own normal draws
    (split from its key as ``update`` splits it); TD3's second update
    skips the actor, which stays bit-equal."""
    jcfg = jax_op.OffPolicyConfig(algo=algo, batch_size=B, learning_rate=LR)
    learner = jax_op.OffPolicyLearner(jcfg, OBS, ACT, jax.random.PRNGKey(0))
    port = OffPolicyLearner(OffPolicyConfig(algo=algo, batch_size=B,
                                            learning_rate=LR), OBS, ACT,
                            torch.Generator().manual_seed(0))
    js = jax.device_get(learner.state)
    ps = _port_state(js)
    update = jax.jit(learner.update)
    rng = np.random.default_rng(5)
    noisy = {"actor": {}, "critic": {}, "alpha": {}}
    for k in range(3):
        b = _batch(rng)
        key = jax.random.PRNGKey(10 + k)
        r_tgt, r_pi = jax.random.split(key)
        noise_tgt = _t(jax.random.normal(r_tgt, (B, ACT))) if algo != "ddpg" else None
        noise_pi = _t(jax.random.normal(r_pi, (B, ACT))) if algo == "sac" else None
        js, jm = jax.device_get(update(
            js, jax_rb.Batch(**{f: jnp.asarray(v) for f, v in b.items()}), key))
        before = ps
        ps, pm = port.update(ps, rb.Batch(**{f: _t(v) for f, v in b.items()}),
                             noise_tgt, noise_pi)
        want = _port_state(js)
        assert ps.step == want.step == k + 1
        for part in ("actor", "critic", "alpha"):
            _mark_noise(noisy[part], getattr(want, f"{part}_opt").mu)
        label = f"{algo} update {k}"
        _assert_params(label, ps.actor_params, want.actor_params,
                       noisy["actor"], k + 1)
        _assert_params(label, ps.critic_params, want.critic_params,
                       noisy["critic"], k + 1)
        _assert_params(label, ps.target_actor_params, want.target_actor_params,
                       noisy["actor"], k + 1)
        _assert_params(label, ps.target_critic_params, want.target_critic_params,
                       noisy["critic"], k + 1)
        for part in ("actor", "critic", "alpha"):
            _assert_opt(f"{label} {part}", getattr(ps, f"{part}_opt"),
                        getattr(want, f"{part}_opt"), noisy[part])
        np.testing.assert_allclose(float(ps.log_alpha), float(want.log_alpha),
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL)
        for name, v in jm.items():
            np.testing.assert_allclose(float(pm[name]), float(v),
                                       rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                       err_msg=f"{label} {name}")
        skipped = algo == "td3" and k == 1
        for name, p in ps.actor_params.items():
            assert torch.equal(p, before.actor_params[name]) == skipped, name
        if skipped:
            assert ps.actor_opt is before.actor_opt
            assert ps.target_actor_params is before.target_actor_params
        if algo == "sac":
            assert float(ps.log_alpha) != float(before.log_alpha)


def test_update_is_pure():
    """The update leaves its state and batch as they were."""
    learner = OffPolicyLearner(OffPolicyConfig(batch_size=B), OBS, ACT,
                               torch.Generator().manual_seed(0))
    st = learner.state
    copies = [{k: v.clone() for k, v in d.items()} for d in
              (st.actor_params, st.critic_params, st.target_critic_params,
               st.critic_opt.mu)]
    batch = rb.Batch(**{f: _t(v) for f, v in _batch(np.random.default_rng(0)).items()})
    new, _ = learner.draw_update(st, batch, torch.Generator().manual_seed(1))
    assert new.step == 1 and st.step == 0
    for before, now in zip(copies, (st.actor_params, st.critic_params,
                                    st.target_critic_params, st.critic_opt.mu)):
        for k, v in before.items():
            assert torch.equal(v, now[k]), k


# ---------------------------------------------------------------------------
# DQN


@pytest.mark.parametrize("max_grad_norm", [10.0, 0.05])
def test_three_dqn_updates_across_a_sync_equal_jax(max_grad_norm):
    """Three updates with target_update_interval=2: the target stays at
    the initial parameters, then equals the online ones after the second
    update, then stays there.  At max_grad_norm 0.05 every update is
    clipped (the device-side select), at 10 none is."""
    n = 4
    jenv = jax_synth.IdentityEnvMultiDiscrete(nvec=(n,))
    jrun = jax_dqn.DQNRunner(jenv, jax_dqn.DQNConfig(
        target_update_interval=2, batch_size=B, max_grad_norm=max_grad_norm),
        num_envs=4, seed=0)
    port = DQNRunner(IdentityEnvMultiDiscrete(nvec=(n,), device="cpu"),
                     DQNConfig(target_update_interval=2, batch_size=B,
                               max_grad_norm=max_grad_norm), num_envs=4)
    c = convert.off_policy_net_to_state_dict

    def port_state(js):
        return DQNState(c(js.params), c(js.target_params),
                        convert.jax_opt_state_to_port(js.opt_state, c),
                        int(js.grad_steps), int(js.env_steps))

    js = jax.device_get(jrun.state)
    ps = port_state(js)
    update = jax.jit(jrun._update)
    rng = np.random.default_rng(6)
    noisy = {}
    for k in range(3):
        b = _batch(rng, discrete=n)
        js = jax.device_get(update(
            js, jax_rb.Batch(**{f: jnp.asarray(v) for f, v in b.items()})))
        before = ps
        ps = port.update(ps, rb.Batch(**{f: _t(v) for f, v in b.items()}))
        want = port_state(js)
        assert ps.grad_steps == want.grad_steps == k + 1
        _mark_noise(noisy, want.opt_state.mu)
        label = f"dqn update {k}"
        _assert_params(label, ps.params, want.params, noisy, k + 1)
        _assert_params(label, ps.target_params, want.target_params, noisy, k + 1)
        _assert_opt(label, ps.opt_state, want.opt_state, noisy)
        for name, p in ps.target_params.items():
            if k + 1 == 2:
                assert torch.equal(p, ps.params[name]), name
            else:
                assert p is before.target_params[name], name


def test_huber_is_optax():
    import optax
    e = np.linspace(-3, 3, 61).astype(np.float32)
    t = np.random.default_rng(7).normal(size=61).astype(np.float32)
    from gennbv_tpu_torch.algo.dqn import huber_loss
    np.testing.assert_array_equal(huber_loss(_t(e), _t(t)).numpy(),
                                  np.asarray(optax.huber_loss(e, t)))


def test_eps_equals_jax_bit_for_bit():
    """Epsilon at step counts across the decay, in float32 as the JAX
    runner's jitted iteration computes it."""
    cfg = dict(eps_decay_steps=5000, eps_start=1.0, eps_end=0.05)
    jrun = jax_dqn.DQNRunner(jax_synth.IdentityEnvMultiDiscrete(nvec=(4,)),
                             jax_dqn.DQNConfig(**cfg), num_envs=4)
    port = DQNRunner(IdentityEnvMultiDiscrete(nvec=(4,), device="cpu"),
                     DQNConfig(**cfg), num_envs=4)
    steps = [0, 1, 7, 16, 333, 1000, 2500, 4095, 4096, 4999, 5000, 8192, 10 ** 6]
    jitted = jax.jit(jrun._eps)
    for s in steps:
        want = np.float32(jitted(jnp.float32(s)))
        assert np.float32(port._eps(s)) == want, (s, port._eps(s), want)


# ---------------------------------------------------------------------------
# the learner tests of tests/test_off_policy.py, on the port


@pytest.mark.parametrize("algo", ["sac", "td3", "ddpg"])
def test_update_is_finite_and_moves_the_critic(algo):
    learner = OffPolicyLearner(OffPolicyConfig(algo=algo, batch_size=32), 3, 2,
                               torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = rb.Batch(torch.randn(32, 3, generator=g),
                     torch.rand(32, 2, generator=g) * 2 - 1,
                     torch.randn(32, generator=g), torch.randn(32, 3, generator=g),
                     torch.zeros(32))
    st, metrics = learner.draw_update(learner.state, batch, g)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), (k, v)
    diff = sum(float((st.critic_params[k] - v).abs().sum())
               for k, v in learner.state.critic_params.items())
    assert diff > 0.0


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_off_policy_learns_point_goal(algo):
    env = PointGoalEnv(dim=2, ep_length=16, device="cpu")
    runner = OffPolicyRunner(
        env, OffPolicyConfig(algo=algo, batch_size=128, buffer_capacity=16384,
                             learning_starts=512, learning_rate=1e-3),
        num_envs=16, seed=0)
    runner.learn(800, chunk=100)
    pol = runner.exploit_policy()
    st, out = env.reset(64, torch.Generator().manual_seed(5))
    obs, tot = out.obs, 0.0
    for _ in range(16):
        st, out = env.step(st, pol(obs))
        obs = out.obs
        tot += float(out.reward.mean())
    mean_rew = tot / 16
    # random policy scores ~ -1.3; learned should be clearly better
    assert mean_rew > -0.75, (algo, mean_rew)


def test_dqn_learns_identity():
    env = IdentityEnvMultiDiscrete(nvec=(4,), ep_length=8, device="cpu")
    runner = DQNRunner(env, DQNConfig(batch_size=64, buffer_capacity=8192,
                                      learning_starts=256, eps_decay_steps=2000,
                                      target_update_interval=50),
                       num_envs=16, seed=0)
    runner.learn(1500, chunk=150)
    pol = runner.greedy_policy()
    st, out = env.reset(64, torch.Generator().manual_seed(3))
    _, out2 = env.step(st, pol(out.obs))
    acc = float(out2.reward.mean())
    assert acc > 0.9, acc   # matches the target from the one-hot obs


# ---------------------------------------------------------------------------
# the all-families example


def test_example_runs_on_the_cpu(capsys):
    """gennbv_tpu_torch.examples.custom_env_families on the CPU: the JAX
    example's six lines, every number finite; the card is the default."""
    import math
    import re

    from gennbv_tpu_torch.examples import custom_env_families
    assert custom_env_families.parse_args([]).device == "cuda"
    out = custom_env_families.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == [
        "ppo", "a2c", "sac mean reward", "dqn mean reward", "recurrent ppo",
        "her"]
    numbers = [float(x) for line in lines for x in re.findall(
        r"[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|nan|inf)", line)]
    assert numbers and all(math.isfinite(x) for x in numbers), lines
    # 10 rounds of 16 envs into a buffer of 512
    assert out["her"] == 160
