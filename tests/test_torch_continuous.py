"""The port's continuous-control learner (``gennbv_tpu_torch/algo/
ppo_continuous.py``, ``on_policy_runner.py``, ``models/gaussian.py``,
``models/actor_critic.py``) against the JAX package's on the same numpy
inputs: the Gaussian helpers, the actor-critic from converted parameters,
whole updates from converted fresh and mid-run states under Adam and
RMSprop, and one runner iteration on PointGoalEnv; then the learner tests
of tests/test_continuous.py on the port alone."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu.algo import on_policy_runner as jax_runner
from gennbv_tpu.algo import ppo_continuous as jax_ppoc
from gennbv_tpu.env import synthetic as jax_synth
from gennbv_tpu.models import gaussian as jax_gaussian
from gennbv_tpu.models.actor_critic import GaussianActorCritic as JaxAC
from gennbv_tpu_torch.algo import on_policy_runner as runner_lib
from gennbv_tpu_torch.algo import ppo_continuous as ppoc
from gennbv_tpu_torch.env.synthetic import PointGoalEnv, SynthState
from gennbv_tpu_torch.models import convert, gaussian
from gennbv_tpu_torch.models.actor_critic import GaussianActorCritic

OBS_DIM, N_ACT, HIDDEN = 6, 3, (32, 32)
M = 128                                      # rollout rows of an update
# float32 elementwise formulas evaluated in another order (XLA fuses the
# JAX side into FMAs): a few ulps
HELPER_RTOL, HELPER_ATOL = 1e-6, 1e-6
# the MLP forward: float32 dot products of <= 32 terms summed in another
# order, ~1e-7 relative to the terms
FORWARD_RTOL, FORWARD_ATOL = 1e-5, 1e-6
# After a whole update.  The gradients agree to ~1e-6 relative (float32
# sums in another order); Adam divides by sqrt(v) ~ |g|, so a step of lr
# <= 1e-2 moves by ~1e-8 between the two sides, and 20 steps keep the
# parameters within 1e-6.  The moments carry the gradients' relative
# error; second moments are squares, hence twice it.  Entries much
# smaller than their tensor's largest (a near-zero first moment is a sum
# of gradients that cancel) keep the error of their tensor's scale, so
# the absolute tolerance is that relative error times the tensor's
# largest entry.
PARAM_ATOL = 1e-6
MOMENT_RTOL = {"mu": 1e-4, "nu": 2e-4}
MOMENT_SCALE_TOL = {"mu": 1e-5, "nu": 2e-5}
# losses and KL are float32 means over 20 minibatches: 1e-5 relative
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-7


def _jax_model():
    return JaxAC(num_actions=N_ACT, actor_hidden=HIDDEN, critic_hidden=HIDDEN)


def _port_model(params):
    model = GaussianActorCritic(OBS_DIM, N_ACT, HIDDEN, HIDDEN, device="cpu")
    model.load_state_dict(convert.gaussian_ac_to_state_dict(params))
    return model


@pytest.fixture(scope="module")
def params():
    model = _jax_model()
    return jax.device_get(model.init(jax.random.PRNGKey(3),
                                     jnp.zeros((1, OBS_DIM)))["params"])


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# helpers and the model


def test_gaussian_helpers_match_jax():
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(32, 4)).astype(np.float32)
    log_std = rng.uniform(-1, 0.5, 4).astype(np.float32)
    acts = (mean + rng.normal(size=(32, 4))).astype(np.float32)
    new_mean = (mean + 0.1 * rng.normal(size=(32, 4))).astype(np.float32)
    new_log_std = (log_std + 0.05).astype(np.float32)
    pairs = [
        (gaussian.log_prob(_t(mean), _t(log_std), _t(acts)),
         jax_gaussian.log_prob(mean, log_std, acts)),
        (gaussian.entropy(_t(log_std), _t(acts)),
         jax_gaussian.entropy(log_std, acts)),
        (gaussian.kl(_t(mean), _t(log_std), _t(new_mean), _t(new_log_std)),
         jax_gaussian.kl(mean, log_std, new_mean, new_log_std)),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=HELPER_RTOL, atol=HELPER_ATOL)
    # sample: mean + std * the generator's normal draws
    g = torch.Generator().manual_seed(5)
    a = gaussian.sample(_t(mean), _t(log_std), g)
    noise = torch.randn(32, 4, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, _t(mean) + torch.exp(_t(log_std)) * noise,
                               rtol=0, atol=0)


def test_actor_critic_forward_from_converted_params(params):
    obs = np.random.default_rng(1).normal(size=(16, OBS_DIM)).astype(np.float32)
    want = _jax_model().apply({"params": params}, obs)
    got = _port_model(params)(_t(obs))
    for field in ("mean", "log_std", "value"):
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=FORWARD_RTOL, atol=FORWARD_ATOL,
                                   err_msg=field)
    assert sorted(dict(_port_model(params).named_parameters())) == sorted(
        convert.gaussian_ac_to_state_dict(params))


def test_actor_critic_init_is_flax_lecun_normal():
    """Weights of a truncated normal at two standard deviations with
    variance 1 / fan_in (flax's lecun_normal), zero biases, log_std =
    log(init_noise_std); the same draws from the same seed."""
    def build(seed):
        return GaussianActorCritic(256, 4, (512,), (64,), init_noise_std=0.5,
                                   generator=torch.Generator().manual_seed(seed),
                                   device="cpu")
    model = build(0)
    w = model.actor_0.weight.detach()
    assert float(w.abs().max()) <= 2 * (1 / 256) ** 0.5 / 0.87962566103423978
    assert abs(float(w.std()) - (1 / 256) ** 0.5) < 0.02 * (1 / 256) ** 0.5
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert float(p.detach().abs().max()) == 0.0, name
    np.testing.assert_allclose(model.log_std.detach().numpy(), np.log(0.5),
                               rtol=1e-6)
    for a, b in zip(model.parameters(), build(0).parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# whole updates against ppo_continuous.update


def _data(params, seed):
    """A flat rollout of M rows from the JAX model: actions sampled around
    its mean, old log-probs and values as collect records them, whole-batch
    normalized advantages.  The old means are the model's moved by 1e-2
    noise, so the first minibatch's KL is clearly above 0 (at exactly 0
    the adaptive rule keeps the lr, at a rounding error above it raises
    it)."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(M, OBS_DIM)).astype(np.float32)
    out = _jax_model().apply({"params": params}, obs)
    mean, log_std = np.asarray(out.mean), np.asarray(out.log_std)
    acts = (mean + np.exp(log_std) * rng.normal(size=mean.shape)).astype(np.float32)
    logp = np.asarray(jax_gaussian.log_prob(mean, log_std, acts))
    mean = (mean + 1e-2 * rng.normal(size=mean.shape)).astype(np.float32)
    adv = rng.normal(size=M).astype(np.float32)
    adv = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    ret = (np.asarray(out.value) + rng.normal(size=M)).astype(np.float32)
    return dict(obs=obs, actions=acts, old_log_probs=logp,
                old_values=np.asarray(out.value), old_mean=mean,
                old_log_std=log_std, advantages=adv, returns=ret)


def _jax_update(cfg, ts, d, rng):
    model, tx = _jax_model(), jax_ppoc.make_optimizer(cfg)
    fn = jax.jit(lambda ts, d, r: jax_ppoc.update(
        model, tx, cfg, ts, d["obs"], None, d["actions"], d["old_log_probs"],
        d["old_values"], d["old_mean"], d["old_log_std"], d["advantages"],
        d["returns"], r))
    return jax.device_get(fn(ts, {k: jnp.asarray(v) for k, v in d.items()}, rng))


def _jax_indices(cfg, rng):
    """The minibatch rows jax ppo_continuous.update takes (:122-125)."""
    perm = np.asarray(jax.random.permutation(rng, M))
    return np.tile(perm.reshape(cfg.num_mini_batches, -1),
                   (cfg.num_learning_epochs, 1))


def _port_update(pcfg, params, opt_state, d, indices):
    model = _port_model(params)
    state = convert.jax_continuous_opt_state_to_port(opt_state)
    t = {k: _t(v) for k, v in d.items()}
    state, metrics = ppoc.update(
        model, ppoc.make_optimizer(pcfg), pcfg, state, t["obs"], None,
        t["actions"], t["old_log_probs"], t["old_values"], t["old_mean"],
        t["old_log_std"], t["advantages"], t["returns"],
        indices=torch.from_numpy(indices).long())
    return model, state, metrics


def _assert_same(model, state, metrics, ts, jm, metric_atol=METRIC_ATOL):
    want = convert.gaussian_ac_to_state_dict(ts.params)
    for name, got in model.state_dict().items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    want_state = convert.jax_continuous_opt_state_to_port(ts.opt_state)
    assert state.count == want_state.count
    # the learning rate is float32 arithmetic on the same decisions: equal
    assert float(state.learning_rate) == float(want_state.learning_rate)
    assert float(metrics.learning_rate) == float(jm.learning_rate)
    for moment in ("mu", "nu"):
        want_m = getattr(want_state, moment)
        assert sorted(getattr(state, moment)) == sorted(want_m)
        for name, got in getattr(state, moment).items():
            w = want_m[name].numpy()
            np.testing.assert_allclose(
                got.numpy(), w, rtol=MOMENT_RTOL[moment],
                atol=MOMENT_SCALE_TOL[moment] * float(np.abs(w).max()),
                err_msg=f"{moment} {name}")
    for field in ("surrogate_loss", "value_loss", "entropy", "mean_kl"):
        np.testing.assert_allclose(float(getattr(metrics, field)),
                                   float(getattr(jm, field)),
                                   rtol=METRIC_RTOL, atol=metric_atol,
                                   err_msg=field)


def _record_kls(monkeypatch):
    """The KL of every minibatch the port's update adapts its lr on."""
    kls, lrs = [], []
    real = ppoc.adapt_lr

    def recording(cfg, lr, kl):
        new = real(cfg, lr, kl)
        kls.append(float(kl))
        lrs.append((float(lr), float(new)))
        return new

    monkeypatch.setattr(ppoc, "adapt_lr", recording)
    return kls, lrs


def _clear_of_thresholds(cfg, kls):
    """No KL within 5% of a threshold of the adaptive rule, nor within 1e-7
    above 0: a rounding difference cannot flip its decision."""
    if cfg.desired_kl is None:
        return
    assert all(kl == 0.0 or kl > 1e-7 for kl in kls), kls
    for thr in (2.0 * cfg.desired_kl, cfg.desired_kl / 2.0):
        for kl in kls:
            assert abs(kl - thr) > 0.05 * thr, (thr, kls)


# (config, data seed) of each case
CASES = {
    # Adam's adaptive lr rises on the first minibatches' small KLs, then
    # falls to min_lr once the policy has moved
    "adam": (dict(learning_rate=1e-3), 11),
    # RMSprop's first steps are small (its mean square starts at 1): the
    # lr rises to max_lr
    "rmsprop": (dict(learning_rate=1e-3, optimizer="rmsprop"), 12),
    # every minibatch's gradient norm above max_grad_norm
    "clip": (dict(learning_rate=1e-3, max_grad_norm=0.05), 11),
    "a2c": (None, 11),
}


def _cfgs(case):
    kw, _ = CASES[case]
    if kw is None:
        return jax_ppoc.a2c_config(), ppoc.a2c_config()
    return jax_ppoc.ContinuousPPOConfig(**kw), ppoc.ContinuousPPOConfig(**kw)


@pytest.mark.parametrize("mid_run", [False, True], ids=["fresh", "mid_run"])
@pytest.mark.parametrize("case", ["adam", "rmsprop", "clip", "a2c"])
def test_update_matches_jax(params, monkeypatch, case, mid_run):
    """From optax's fresh state, or from the JAX state after a first update
    (count, moments and the adapted lr carried over by
    jax_continuous_opt_state_to_port), with JAX's permutation as indices."""
    jcfg, pcfg = _cfgs(case)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    tx = jax_ppoc.make_optimizer(jcfg)
    ts = jax_ppoc.ContinuousTrainState(params, tx.init(params))
    if mid_run:
        ts, _ = _jax_update(jcfg, ts, _data(params, 10), jax.random.PRNGKey(10))
        assert convert.jax_continuous_opt_state_to_port(ts.opt_state).count > 0
    seed = CASES[case][1]
    d = _data(ts.params, seed)
    rng = jax.random.PRNGKey(seed)
    ts2, jm = _jax_update(jcfg, ts, d, rng)
    kls, lrs = _record_kls(monkeypatch)
    model, state, pm = _port_update(pcfg, ts.params, ts.opt_state, d,
                                    _jax_indices(jcfg, rng))
    _clear_of_thresholds(pcfg, kls)
    _assert_same(model, state, pm, ts2, jm)
    n = jcfg.num_learning_epochs * jcfg.num_mini_batches
    assert state.count == (n if not mid_run else 2 * n)
    if case == "clip":
        t = {k: _t(v) for k, v in d.items()}
        m = _port_model(ts.params)
        loss, _ = ppoc._loss(m, pcfg, t["old_log_std"], t["obs"][:32], None,
                             *(t[k][:32] for k in (
                                 "actions", "old_log_probs", "old_values",
                                 "old_mean", "advantages", "returns")))
        grads = torch.autograd.grad(loss, list(m.parameters()))
        assert float(ppoc.global_norm(grads)) > 4 * pcfg.max_grad_norm
    if case in ("adam", "rmsprop") and not mid_run:
        assert any(new > old for old, new in lrs), lrs
    if case == "adam" and not mid_run:
        assert any(new < old for old, new in lrs), lrs


def test_optimizer_state_conversion(params):
    """jax_continuous_opt_state_to_port maps optax's moments like the
    parameters and keeps the injected learning rate and the counts."""
    for kind in ("adam", "rmsprop"):
        cfg = jax_ppoc.ContinuousPPOConfig(optimizer=kind, max_grad_norm=1e9)
        tx = jax_ppoc.make_optimizer(cfg)
        grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), params)
        _, st = jax.jit(tx.update)(grads, tx.init(params), params)
        got = convert.jax_continuous_opt_state_to_port(st)
        names = sorted(dict(_port_model(params).named_parameters()))
        assert got.count == 1 and float(got.learning_rate) == np.float32(1e-3)
        assert sorted(got.nu) == names
        assert sorted(got.mu) == (names if kind == "adam" else [])
        # optax injects b2 and decay as float32: 1 - b2 rounds in float32
        decay = np.float32(0.999 if kind == "adam" else 0.99)
        init = 0.0 if kind == "adam" else 1.0
        want_nu = (np.float32(1) - decay) * np.float32(0.25) + decay * np.float32(init)
        for n in names:
            np.testing.assert_allclose(got.nu[n].numpy(), want_nu, rtol=1e-6)
    with pytest.raises(ValueError, match="optimizer"):
        ppoc.make_optimizer(ppoc.ContinuousPPOConfig(optimizer="sgd"))


# ---------------------------------------------------------------------------
# one runner iteration on PointGoalEnv

T, N, EP_LEN = 8, 16, 5
# The first minibatch's KL compares the policy with itself: 0 up to
# rounding, which decides between keeping and raising the lr.  Starting at
# max_lr makes both the same.
RUN_CFG = dict(num_learning_epochs=2, num_mini_batches=4, learning_rate=1e-2)


def _jax_draws(rng, env_state):
    """What the JAX iteration draws (on_policy_runner.py:61-76, 93-94):
    each step's normal noise of the actions, each step's re-spawn
    positions of PointGoalEnv (synthetic.py:128-133), the update's
    permutation."""
    r_roll, r_upd, _ = jax.random.split(rng, 3)
    noise = [np.asarray(jax.random.normal(k, (N, 2)))
             for k in jax.random.split(r_roll, T)]
    keys, spawns = env_state.rng, []
    for _ in range(T):
        ks = jax.vmap(jax.random.split)(keys)
        spawns.append(np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (2,), minval=-1.0, maxval=1.0))(ks[:, 0])))
        keys = ks[:, 1]
    return noise, spawns, np.asarray(jax.random.permutation(r_upd, T * N))


def _jax_iteration(runner, env_state, obs, rng):
    """The JAX iteration, with its advantages and returns after the
    whole-batch normalization (on_policy_runner.py:89-102)."""
    cfg = runner.alg_cfg
    r_roll, _, _ = jax.random.split(rng, 3)
    _, _, (_, _, rews, dones, values, _, _, last) = runner._rollout(
        runner.train_state.params, env_state, obs, r_roll)
    adv, ret = jax_runner.gae_lib.compute_gae(
        rews, values, dones.astype(jnp.float32), last.value, cfg.gamma, cfg.lam)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    ts, env_state, obs, _, metrics = runner._iter_fn(
        runner.train_state, env_state, obs, rng)
    return jax.device_get((ts, env_state, obs, metrics, adv, ret))


def test_runner_iteration_matches_jax(monkeypatch):
    """One iteration from the same parameters and env state: the rollout's
    actions and the env's re-spawns fed from JAX's draws, episodes that
    time out mid-rollout (the V(s_t) bootstrap), GAE, the whole-batch
    normalization and the update."""
    jcfg = jax_ppoc.ContinuousPPOConfig(**RUN_CFG)
    jr = jax_runner.OnPolicyRunner(
        jax_synth.PointGoalEnv(dim=2, ep_length=EP_LEN), jcfg,
        jax_runner.OnPolicyRunnerConfig(num_steps_per_env=T), num_envs=N,
        seed=0, actor_hidden=(16, 16), critic_hidden=(16, 16))
    env_state, out = jr.env.reset(N, jax.random.PRNGKey(1))
    env_state = env_state._replace(episode_len=jnp.arange(N, dtype=jnp.int32) % EP_LEN)
    rng = jax.random.PRNGKey(2)
    noise, spawns, perm = _jax_draws(rng, env_state)
    ts, j_env, j_obs, jm, j_adv, j_ret = _jax_iteration(jr, env_state, out.obs, rng)

    env = PointGoalEnv(dim=2, ep_length=EP_LEN, device="cpu")
    pr = runner_lib.OnPolicyRunner(
        env, ppoc.ContinuousPPOConfig(**RUN_CFG),
        runner_lib.OnPolicyRunnerConfig(num_steps_per_env=T), num_envs=N,
        seed=0, actor_hidden=(16, 16), critic_hidden=(16, 16))
    params0 = jax.device_get(jr.train_state.params)
    pr.model.load_state_dict(convert.gaussian_ac_to_state_dict(params0))
    pr.opt_state = convert.jax_continuous_opt_state_to_port(
        jax.device_get(jr.train_state.opt_state))
    steps = iter(noise)
    monkeypatch.setattr(gaussian, "sample", lambda mean, log_std, g:
                        mean + torch.exp(log_std) * _t(next(steps)))
    respawns = iter(spawns)
    monkeypatch.setattr(env, "_uniform", lambda g, shape: _t(next(respawns)))
    monkeypatch.setattr(ppoc, "minibatch_indices", lambda cfg, m, g: torch.from_numpy(
        np.tile(perm.reshape(cfg.num_mini_batches, -1),
                (cfg.num_learning_epochs, 1))).long())
    seen = {}
    real_update = ppoc.update

    def capturing(*args, **kw):
        seen["adv"], seen["ret"] = args[11], args[12]
        return real_update(*args, **kw)

    monkeypatch.setattr(ppoc, "update", capturing)
    kls, _ = _record_kls(monkeypatch)

    state = SynthState(_t(env_state.target), _t(env_state.episode_len),
                       torch.Generator().get_state())
    state, obs, metrics = pr._train_iteration(state, _t(out.obs))
    _clear_of_thresholds(pr.alg_cfg, kls)
    assert next(steps, None) is None and next(respawns, None) is None

    # the rollout: every env timed out once, so the bootstrap ran
    np.testing.assert_allclose(obs.numpy(), np.asarray(j_obs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(state.target.numpy(), np.asarray(j_env.target),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(state.episode_len.numpy(),
                                  np.asarray(j_env.episode_len))
    # GAE over 8 steps and the normalization: the rewards' and values'
    # 1e-6 relative differences, divided by the advantages' std
    np.testing.assert_allclose(seen["adv"].numpy(), np.asarray(j_adv).reshape(-1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(seen["ret"].numpy(), np.asarray(j_ret).reshape(-1),
                               rtol=1e-5, atol=1e-5)
    # the surrogate is a mean of advantage-weighted ratios of magnitude ~1
    # that cancel to ~0.03: it keeps the advantages' 1e-6 absolute error
    _assert_same(pr.model, pr.opt_state, ppoc.ContinuousUpdateMetrics(
        *metrics[1:6]), ts, jax_ppoc.ContinuousUpdateMetrics(
            *(jm[k] for k in ("surrogate_loss", "value_loss", "entropy",
                              "mean_kl", "learning_rate"))), metric_atol=1e-6)
    got = dict(zip(runner_lib.METRIC_KEYS, metrics.tolist()))
    assert sorted(got) == sorted(jm)
    for k in ("mean_reward", "mean_episode_length"):
        np.testing.assert_allclose(got[k], float(jm[k]), rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the learner tests of tests/test_continuous.py, on the port alone


def test_adaptive_lr_moves():
    """LR must drop when KL explodes and never decrease at tiny KL."""
    cfg = ppoc.ContinuousPPOConfig(num_learning_epochs=1, num_mini_batches=1,
                                   desired_kl=0.01, learning_rate=1e-3)
    g = torch.Generator().manual_seed(0)
    model = GaussianActorCritic(4, 2, (16,), (16,), generator=g, device="cpu")
    opt = ppoc.make_optimizer(cfg)
    obs = torch.randn(64, 4, generator=g)
    with torch.no_grad():
        out = model(obs)
        acts = gaussian.sample(out.mean, out.log_std, g)
        logp = gaussian.log_prob(out.mean, out.log_std, acts)
    adv = torch.randn(64, generator=g)
    ret = torch.zeros(64)
    base = {k: v.clone() for k, v in model.state_dict().items()}

    def run(old_mean):
        model.load_state_dict(base)
        _, um = ppoc.update(model, opt, cfg, opt.init(model), obs, None, acts,
                            logp, out.value, old_mean, out.log_std, adv, ret, g)
        return float(um.learning_rate)

    # old_mean far from the model's mean -> huge KL -> lr / 1.5
    assert run(out.mean + 10.0) == pytest.approx(1e-3 / 1.5, rel=1e-6)
    # old_mean == current mean -> KL ~ 0 -> never decreases
    assert run(out.mean) >= np.float32(1e-3)


def _det_eval(runner, env, n=128, steps=24):
    """Mean per-step reward of the deterministic (mean-action) policy."""
    st, out = env.reset(n, torch.Generator().manual_seed(99))
    policy = runner.get_inference_policy()
    tot = 0.0
    for _ in range(steps):
        st, out = env.step(st, policy(out.obs))
        tot += float(out.reward.mean())
    return tot / steps


def test_ppo_continuous_learns_point_goal():
    """Gaussian PPO drives the point toward the origin: the deterministic
    policy's reward improves to near-optimal."""
    env = PointGoalEnv(dim=2, ep_length=16, device="cpu")
    runner = runner_lib.OnPolicyRunner(
        env, ppoc.ContinuousPPOConfig(num_learning_epochs=4, num_mini_batches=4,
                                      learning_rate=1e-3, desired_kl=0.01,
                                      entropy_coef=0.01),
        runner_lib.OnPolicyRunnerConfig(num_steps_per_env=16), num_envs=64,
        seed=0, actor_hidden=(32, 32), critic_hidden=(32, 32))
    runner.learn(1)
    r0 = _det_eval(runner, env)
    runner.learn(30)
    r1 = _det_eval(runner, env)
    assert r1 > r0 + 0.1, (r0, r1)
    assert r1 > -0.5, r1  # near-optimal: |reward| ~ residual noise only
    a = runner.get_inference_policy()(torch.tensor([[0.8, -0.6]]))
    assert float(a[0, 0]) < 0.0 and float(a[0, 1]) > 0.0


def test_runner_save_load(tmp_path):
    def build(seed):
        return runner_lib.OnPolicyRunner(
            PointGoalEnv(dim=2, ep_length=8, device="cpu"),
            ppoc.ContinuousPPOConfig(),
            runner_lib.OnPolicyRunnerConfig(num_steps_per_env=8), num_envs=8,
            seed=seed, actor_hidden=(16,), critic_hidden=(16,))
    runner = build(0)
    runner.learn(2)
    p = str(tmp_path / "model_2.pt")
    runner.save(p)
    runner2 = build(1)
    runner2.load(p)
    assert runner2.iteration == 2
    x = torch.ones(1, 2)
    assert torch.equal(runner.get_inference_policy()(x),
                       runner2.get_inference_policy()(x))
    for a, b in ((runner.opt_state, runner2.opt_state),):
        assert a.count == b.count and torch.equal(a.learning_rate, b.learning_rate)
        for k in a.mu:
            assert torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k])


def test_a2c_variant_learns():
    """A2C (degenerate PPO: 1 epoch, no clip, TF-style RMSprop) learns
    PointGoal in its natural regime: tiny rollouts, many cheap updates."""
    env = PointGoalEnv(dim=2, ep_length=16, device="cpu")
    runner = runner_lib.OnPolicyRunner(
        env, ppoc.a2c_config(learning_rate=7e-4),
        runner_lib.OnPolicyRunnerConfig(num_steps_per_env=5), num_envs=64,
        seed=0, actor_hidden=(32, 32), critic_hidden=(32, 32))
    runner.learn(1)
    r0 = _det_eval(runner, env)
    runner.learn(1500)
    r1 = _det_eval(runner, env)
    assert r1 > r0 + 0.4, (r0, r1)


def test_seeded_runners_are_equal():
    """Two runners from one seed end two iterations with equal parameters,
    optimizer state and metrics (the card's check, chip_smoke.py phase
    11, on the CPU)."""
    def run():
        r = runner_lib.OnPolicyRunner(
            PointGoalEnv(dim=2, ep_length=6, device="cpu"),
            ppoc.ContinuousPPOConfig(),
            runner_lib.OnPolicyRunnerConfig(num_steps_per_env=8), num_envs=16,
            seed=4, actor_hidden=(16,), critic_hidden=(16,))
        return r, r.learn(2)
    (a, ma), (b, mb) = run(), run()
    assert ma == mb
    for k, v in a.variables().items():
        assert torch.equal(v, b.variables()[k]), k
    for k in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k])
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k])
