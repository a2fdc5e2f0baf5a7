"""The port's recurrent family (``gennbv_tpu_torch/models/actor_critic.py``
LSTMCell, GRUCell, RecurrentActorCritic; ``algo/ppo_recurrent.py``;
``train/play.py``'s export_recurrent_policy; ``models/convert.py``) against
the JAX package's on the same numpy inputs: the cells and the actor-critic
from converted Flax params over an unroll with resets, the loss and
gradients of one minibatch against jax.value_and_grad, and one whole
update from one rollout with JAX's env permutation; then the tests of
tests/test_recurrent_ppo.py and the export round trip on the port."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu.algo import ppo_continuous as jax_ppoc
from gennbv_tpu.algo import ppo_recurrent as jax_ppor
from gennbv_tpu.models import actor_critic as jax_ac
from gennbv_tpu.models import gaussian as jax_gaussian
from gennbv_tpu_torch.algo import ppo_continuous as ppoc
from gennbv_tpu_torch.algo import ppo_recurrent as ppor
from gennbv_tpu_torch.env.synthetic import PointGoalEnv, SynthOutput, SynthState
from gennbv_tpu_torch.models import convert
from gennbv_tpu_torch.models.actor_critic import (RecurrentActorCritic,
                                                  hidden_from_leaves,
                                                  hidden_leaves, reset_hidden)
from gennbv_tpu_torch.train import play
from gennbv_tpu_torch.utils import rng as rng_lib

OBS_DIM, N_ACT, H, HEADS = 5, 3, 16, (16,)
T, N = 8, 8                                   # rollout steps and envs
# The cells and the heads: float32 dot products of <= 16 terms summed in
# another order, then sigmoid/tanh (slope <= 1): ~1e-7 relative per step,
# and an unroll of T steps carries it through the cell state: 1e-5
# relative and 1e-6 absolute, as the MLP forward's
# (tests/test_torch_continuous.py).
FORWARD_RTOL, FORWARD_ATOL = 1e-5, 1e-6
# One minibatch's loss and gradients through a T-step BPTT unroll: the
# gradients are sums over T steps and 8 envs of products of the forward's
# values, each ~1e-6 relative; held to 1e-4 relative plus 1e-5 of each
# tensor's largest gradient (entries much smaller than their tensor's
# largest are sums that cancel and keep the error of the tensor's scale).
GRAD_RTOL, GRAD_SCALE_TOL = 1e-4, 1e-5
# After a whole update (2 epochs x 2 minibatches of Adam steps of lr <=
# 1e-2 on those gradients), as tests/test_torch_continuous.py's update:
# parameters within 1e-6, moments within 1e-4 / 2e-4 relative plus 1e-5 /
# 2e-5 of their tensor's largest.
PARAM_ATOL = 1e-6
MOMENT_RTOL = {"mu": 1e-4, "nu": 2e-4}
MOMENT_SCALE_TOL = {"mu": 1e-5, "nu": 2e-5}
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-7


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_model(rnn_type):
    return jax_ac.RecurrentActorCritic(num_actions=N_ACT, rnn_hidden=H,
                                       rnn_type=rnn_type, actor_hidden=HEADS,
                                       critic_hidden=HEADS)


def _port_model(rnn_type, params):
    model = RecurrentActorCritic(OBS_DIM, N_ACT, H, rnn_type, HEADS, HEADS,
                                 device="cpu")
    model.load_state_dict(convert.gaussian_ac_to_state_dict(params))
    return model


def _params(rnn_type, seed=0):
    model = _jax_model(rnn_type)
    return jax.device_get(model.init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, OBS_DIM)),
                                     model.initial_state(1))["params"])


def _hidden(rnn_type, rng, n=N):
    """A random hidden state: its leaves (numpy), the JAX RNNState and the
    port's."""
    template = _jax_model(rnn_type).initial_state(n)
    leaves = [rng.normal(size=(n, H)).astype(np.float32) * 0.5
              for _ in jax.tree.leaves(template)]
    jh = jax.tree.unflatten(jax.tree.structure(template),
                            [jnp.asarray(x) for x in leaves])
    return leaves, jh, hidden_from_leaves([_t(x) for x in leaves], rnn_type)


def _close(got, want, msg, rtol=FORWARD_RTOL, atol=FORWARD_ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# the cells and the actor-critic


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_actor_critic_unroll_matches_flax(rnn_type):
    """T steps of RecurrentActorCritic from a random hidden state with
    episode resets, from converted Flax params: the means, values, log_std
    and every hidden leaf at every step."""
    params = _params(rnn_type)
    jm, pm = _jax_model(rnn_type), _port_model(rnn_type, params)
    sd = pm.state_dict()
    names = ({"weight_i", "weight_h", "bias_h"} if rnn_type == "lstm" else
             {"weight_i", "bias_i", "weight_h", "bias_hn"})
    assert {k.split(".", 1)[1] for k in sd if k.startswith("memory_a.")} == names
    rng = np.random.default_rng(1)
    _, jh, ph = _hidden(rnn_type, rng)
    obs = rng.normal(size=(T, N, OBS_DIM)).astype(np.float32)
    dones = rng.random((T, N)) < 0.25
    apply = jax.jit(lambda o, h: jm.apply({"params": params}, o, h))
    with torch.no_grad():
        for t in range(T):
            jout, jh = apply(obs[t], jh)
            pout, ph = pm(_t(obs[t]), ph)
            _close(pout.mean, jout.mean, f"mean at {t}")
            _close(pout.value, jout.value, f"value at {t}")
            _close(pout.log_std, jout.log_std, "log_std", 0, 0)
            for i, (a, b) in enumerate(zip(hidden_leaves(ph),
                                           jax.tree.leaves(jh))):
                _close(a, b, f"hidden leaf {i} at {t}")
            jh = jax_ac.reset_hidden(jh, jnp.asarray(dones[t]))
            ph = reset_hidden(ph, _t(dones[t]))
            for a, b in zip(hidden_leaves(ph), jax.tree.leaves(jh)):
                assert torch.equal(a[_t(dones[t])], torch.zeros_like(
                    a[_t(dones[t])]))
                _close(a, b, f"reset hidden at {t}")


def test_initial_state_and_leaves():
    for rnn_type, k in (("lstm", 4), ("gru", 2)):
        pm = RecurrentActorCritic(OBS_DIM, N_ACT, H, rnn_type, HEADS, HEADS,
                                  device="cpu")
        h0 = pm.initial_state(3)
        leaves = hidden_leaves(h0)
        assert len(leaves) == len(jax.tree.leaves(
            _jax_model(rnn_type).initial_state(3))) == k
        assert all(x.shape == (3, H) and not x.any() for x in leaves)
        back = hidden_from_leaves(leaves, rnn_type)
        assert all(a is b for a, b in zip(hidden_leaves(back), leaves))
    with pytest.raises(ValueError, match="rnn_type"):
        RecurrentActorCritic(OBS_DIM, N_ACT, H, "rnn", device="cpu")


# ---------------------------------------------------------------------------
# the loss, the gradients and the update


def _rollout(rnn_type, params, seed):
    """A rollout of T steps of N envs from the JAX model: random obs and
    episode ends, actions sampled around its means, the hidden state reset
    where done, from a random initial hidden state.  The old means are the
    model's moved by 1e-2 noise, so the KL is clearly above 0 (at exactly
    0 the adaptive rule keeps the lr, at a rounding error above it raises
    it)."""
    rng = np.random.default_rng(seed)
    jm = _jax_model(rnn_type)
    leaves, jh, _ = _hidden(rnn_type, rng)
    h0 = jh
    obs = rng.normal(size=(T, N, OBS_DIM)).astype(np.float32)
    dones = rng.random((T, N)) < 0.2
    apply = jax.jit(lambda o, h: jm.apply({"params": params}, o, h))
    acts, values, logps, means = [], [], [], []
    for t in range(T):
        out, jh = apply(obs[t], jh)
        mean, log_std = np.asarray(out.mean), np.asarray(out.log_std)
        a = (mean + np.exp(log_std) * rng.normal(size=mean.shape)).astype(
            np.float32)
        logps.append(np.asarray(jax_gaussian.log_prob(mean, log_std, a)))
        acts.append(a)
        values.append(np.asarray(out.value))
        means.append((mean + 1e-2 * rng.normal(size=mean.shape)).astype(
            np.float32))
        jh = jax_ac.reset_hidden(jh, jnp.asarray(dones[t]))
    last, _ = apply(rng.normal(size=(N, OBS_DIM)).astype(np.float32), jh)
    arrays = dict(obs=obs, actions=np.stack(acts),
                  rewards=rng.normal(size=(T, N)).astype(np.float32),
                  dones=dones, values=np.stack(values),
                  log_probs=np.stack(logps), means=np.stack(means),
                  last_value=np.asarray(last.value),
                  log_std=np.asarray(last.log_std))
    jroll = jax_ppor.RecurrentRollout(
        init_hidden=h0, **{k: jnp.asarray(v) for k, v in arrays.items()})
    proll = ppor.RecurrentRollout(
        init_hidden=hidden_from_leaves([_t(x) for x in leaves], rnn_type),
        **{k: _t(v) for k, v in arrays.items()})
    return jroll, proll


def _jax_loss(model, cfg, params, mb, roll_log_std):
    """gennbv_tpu/algo/ppo_recurrent.py's loss_fn (:92-119), for one
    minibatch of whole trajectories."""
    def unroll(hidden, xs):
        ob, done = xs
        out, hidden = model.apply({"params": params}, ob, hidden)
        return jax_ac.reset_hidden(hidden, done), out

    _, outs = jax.lax.scan(unroll, mb["h0"], (mb["obs"], mb["dones"]))
    logp = jax_gaussian.log_prob(outs.mean, outs.log_std[0], mb["actions"])
    ent = jax_gaussian.entropy(outs.log_std[0], mb["actions"]).mean()
    ratio = jnp.exp(logp - mb["old_log_probs"])
    surr = jnp.maximum(-mb["advantages"] * ratio, -mb["advantages"] * jnp.clip(
        ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param)).mean()
    v_clipped = mb["old_values"] + jnp.clip(
        outs.value - mb["old_values"], -cfg.clip_param, cfg.clip_param)
    value_loss = jnp.maximum((outs.value - mb["returns"]) ** 2,
                             (v_clipped - mb["returns"]) ** 2).mean()
    loss = surr + cfg.value_loss_coef * value_loss - cfg.entropy_coef * ent
    kl = jax_gaussian.kl(mb["old_mean"], roll_log_std, outs.mean,
                         outs.log_std[0])
    return loss, (surr, value_loss, ent, kl)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_loss_and_gradients_match_jax(rnn_type):
    params = _params(rnn_type, 2)
    jroll, proll = _rollout(rnn_type, params, 3)
    cfg = jax_ppoc.ContinuousPPOConfig()
    rng = np.random.default_rng(4)
    adv = rng.normal(size=(T, N)).astype(np.float32)
    ret = rng.normal(size=(T, N)).astype(np.float32)
    jmb = {"obs": jroll.obs, "actions": jroll.actions,
           "old_log_probs": jroll.log_probs, "old_values": jroll.values,
           "old_mean": jroll.means, "advantages": jnp.asarray(adv),
           "returns": jnp.asarray(ret), "dones": jroll.dones,
           "h0": jroll.init_hidden}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(_jax_model(rnn_type), cfg, p, jmb,
                            jroll.log_std), has_aux=True))(params)
    pm = _port_model(rnn_type, params)
    pmb = {"obs": proll.obs, "actions": proll.actions,
           "old_log_probs": proll.log_probs, "old_values": proll.values,
           "old_mean": proll.means, "advantages": _t(adv), "returns": _t(ret),
           "dones": proll.dones, "h0": proll.init_hidden}
    ploss, stats = ppor._loss(pm, ppoc.ContinuousPPOConfig(), proll.log_std,
                              pmb)
    _close(ploss, jloss, "loss", METRIC_RTOL, METRIC_ATOL)
    for got, want, name in zip(stats, jaux, ("surrogate", "value loss",
                                             "entropy", "kl")):
        _close(got, want, name, METRIC_RTOL, METRIC_ATOL)
    names, tensors = zip(*pm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(ploss, tensors)))
    want = convert.gaussian_ac_to_state_dict(jax.device_get(jgrads))
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        w = want[name].numpy()
        _close(g, w, f"grad {name}", GRAD_RTOL,
               GRAD_SCALE_TOL * float(np.abs(w).max()))
    assert float(grads["memory_a.weight_h"].abs().max()) > 0.0


@pytest.mark.parametrize("mid_run", [False, True], ids=["fresh", "mid_run"])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_update_matches_jax(rnn_type, mid_run):
    """One update (2 epochs x 2 minibatches of 4 envs) from one rollout,
    with JAX's env permutation injected: parameters, Adam's moments and
    count, the learning rate and the metrics.  From optax's fresh state,
    or mid-run (after a first JAX update, its state converted)."""
    cfg_kw = dict(num_learning_epochs=2, num_mini_batches=2)
    jcfg = jax_ppoc.ContinuousPPOConfig(**cfg_kw)
    pcfg = ppoc.ContinuousPPOConfig(**cfg_kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    jm = _jax_model(rnn_type)
    tx = jax_ppoc.make_optimizer(jcfg)
    params = _params(rnn_type, 5)
    ts = jax_ppoc.ContinuousTrainState(params, tx.init(params))
    upd = jax.jit(lambda ts, roll, r: jax_ppor.update(jm, tx, jcfg, ts, roll, r))
    if mid_run:
        roll0, _ = _rollout(rnn_type, params, 6)
        ts, _ = jax.device_get(upd(ts, roll0, jax.random.PRNGKey(6)))
    jroll, proll = _rollout(rnn_type, ts.params, 7)
    key = jax.random.PRNGKey(7)
    ts2, jmet = jax.device_get(upd(ts, jroll, key))
    perm = np.asarray(jax.random.permutation(key, N))
    groups = np.tile(perm.reshape(2, N // 2), (2, 1))
    pm = _port_model(rnn_type, ts.params)
    state = convert.jax_continuous_opt_state_to_port(ts.opt_state)
    kls = []
    real = ppoc.adapt_lr

    def recording(cfg, lr, kl):
        kls.append(float(kl))
        return real(cfg, lr, kl)

    ppoc.adapt_lr = recording
    try:
        state, pmet = ppor.update(pm, ppoc.make_optimizer(pcfg), pcfg, state,
                                  proll, groups=torch.from_numpy(groups).long())
    finally:
        ppoc.adapt_lr = real
    # no KL within 5% of a threshold of the adaptive rule: a rounding
    # difference cannot flip its decision
    for thr in (2.0 * pcfg.desired_kl, pcfg.desired_kl / 2.0):
        assert all(abs(kl - thr) > 0.05 * thr for kl in kls), kls
    want = convert.gaussian_ac_to_state_dict(ts2.params)
    for name, got in pm.state_dict().items():
        _close(got, want[name], name, 0, PARAM_ATOL)
    want_state = convert.jax_continuous_opt_state_to_port(ts2.opt_state)
    assert state.count == want_state.count == (8 if mid_run else 4)
    assert float(state.learning_rate) == float(want_state.learning_rate)
    for moment in ("mu", "nu"):
        want_m = getattr(want_state, moment)
        assert sorted(getattr(state, moment)) == sorted(want_m)
        for name, got in getattr(state, moment).items():
            w = want_m[name].numpy()
            _close(got, w, f"{moment} {name}", MOMENT_RTOL[moment],
                   MOMENT_SCALE_TOL[moment] * float(np.abs(w).max()))
    for field in ("surrogate_loss", "value_loss", "entropy", "mean_kl",
                  "learning_rate"):
        _close(getattr(pmet, field), getattr(jmet, field), field, METRIC_RTOL,
               METRIC_ATOL)


def test_env_groups_tile_one_permutation():
    cfg = ppoc.ContinuousPPOConfig(num_learning_epochs=3, num_mini_batches=4)
    g = ppor.env_groups(cfg, 16, torch.Generator().manual_seed(0))
    assert g.shape == (12, 4)
    assert sorted(g[:4].reshape(-1).tolist()) == list(range(16))
    assert torch.equal(g[:4], g[4:8]) and torch.equal(g[:4], g[8:])
    with pytest.raises(ValueError, match="divide"):
        ppor.env_groups(cfg, 10, torch.Generator())


def test_collect_resets_hidden_and_bootstraps_timeouts():
    """collect's rollout: init_hidden the hidden state it started from,
    the hidden state zeroed where an episode ended, and the rewards with
    gamma * V(s_t) * time_out added (two collects from the same seeds with
    gamma 0.9 and 0)."""
    env = PointGoalEnv(dim=2, ep_length=3, device="cpu")
    pm = RecurrentActorCritic(2, 2, 8, "lstm", (8,), (8,), device="cpu",
                              generator=torch.Generator().manual_seed(0))
    h0 = hidden_from_leaves([torch.randn(4, 8, generator=torch.Generator()
                                         .manual_seed(i)) for i in range(4)],
                            "lstm")
    rolls = {}
    for gamma in (0.9, 0.0):
        g = torch.Generator().manual_seed(1)
        state, out = env.reset(4, g)
        _, _, hidden, rolls[gamma] = ppor.collect(pm, env, state, out.obs, h0,
                                                  g, 6, gamma)
        assert rolls[gamma].init_hidden is h0
        assert rolls[gamma].dones[2].all() and rolls[gamma].dones[5].all()
        assert not rolls[gamma].dones[[0, 1, 3, 4]].any()
        assert all(not x.any() for x in hidden_leaves(hidden))
    a, b = rolls[0.9], rolls[0.0]
    assert torch.equal(a.values, b.values) and torch.equal(a.obs, b.obs)
    torch.testing.assert_close(a.rewards - b.rewards,
                               0.9 * a.values * a.dones.float())


# ---------------------------------------------------------------------------
# the tests of tests/test_recurrent_ppo.py, on the port


class CueEnv:
    """tests/test_recurrent_ppo.py's memory fixture: the goal direction is
    shown only at the first step of each episode (obs = cue at t=0, zeros
    after); reward = tanh(action) . cue.  A feedforward policy cannot beat
    0 in expectation; a recurrent one can carry the cue."""

    def __init__(self, dim: int = 2, ep_length: int = 6, device="cpu"):
        self.dim = dim
        self.ep_length = ep_length
        self.num_actions = dim
        self.obs_dim = dim
        self.device = torch.device(device)

    def _cue(self, g, n):
        c = torch.randn(n, self.dim, generator=g, device=self.device)
        return c / (torch.linalg.vector_norm(c, dim=-1, keepdim=True) + 1e-8)

    def reset(self, num_envs: int, rng: torch.Generator):
        cue = self._cue(rng, num_envs)
        state = SynthState(target=cue, episode_len=torch.zeros(
            num_envs, dtype=torch.int32, device=self.device),
            rng=rng_lib.fork(rng))
        zeros = torch.zeros(num_envs, device=self.device)
        no = torch.zeros(num_envs, dtype=torch.bool, device=self.device)
        return state, SynthOutput(cue, zeros, no, no)

    def step(self, state: SynthState, actions: torch.Tensor):
        reward = (torch.tanh(actions) * state.target).sum(-1)
        episode_len = state.episode_len + 1
        done = episode_len >= self.ep_length
        g = rng_lib.restore(state.rng, self.device)
        new_cue = self._cue(g, actions.shape[0])
        target = torch.where(done[:, None], new_cue, state.target)
        obs = torch.where(done[:, None], new_cue, torch.zeros_like(new_cue))
        state = SynthState(target=target,
                           episode_len=torch.where(done, 0, episode_len),
                           rng=g.get_state())
        return state, SynthOutput(obs, reward, done, done)


def test_recurrent_rollout_and_update_shapes():
    env = PointGoalEnv(dim=2, ep_length=8, device="cpu")
    runner = ppor.RecurrentOnPolicyRunner(
        env, ppoc.ContinuousPPOConfig(num_learning_epochs=2, num_mini_batches=2),
        num_steps_per_env=8, num_envs=8, seed=0, rnn_hidden=16,
        actor_hidden=(16,), critic_hidden=(16,))
    m = runner.learn(2)
    assert sorted(m) == sorted(ppor.METRIC_KEYS)
    assert all(np.isfinite(v) for v in m.values()), m
    assert runner.iteration == 2 and runner.opt_state.count == 8


def test_bptt_gradient_reaches_lstm():
    env = PointGoalEnv(dim=2, ep_length=8, device="cpu")
    runner = ppor.RecurrentOnPolicyRunner(
        env, ppoc.ContinuousPPOConfig(num_learning_epochs=1, num_mini_batches=1),
        num_steps_per_env=8, num_envs=4, seed=0, rnn_hidden=8,
        actor_hidden=(8,), critic_hidden=(8,))
    before = {k: v.clone() for k, v in runner.model.memory_a.state_dict().items()}
    runner.learn(1)
    after = runner.model.memory_a.state_dict()
    assert sum(float((after[k] - v).abs().sum()) for k, v in before.items()) > 0


def test_recurrent_learns_memory_task():
    """On the cue task the port's recurrent policy must clearly beat the
    zero baseline (the ceiling for any memoryless policy on the
    mid-episode steps), as the JAX one does."""
    env = CueEnv(dim=2, ep_length=6)
    runner = ppor.RecurrentOnPolicyRunner(
        env, ppoc.ContinuousPPOConfig(num_learning_epochs=4, num_mini_batches=4,
                                      learning_rate=3e-3, desired_kl=None,
                                      entropy_coef=0.0),
        num_steps_per_env=12, num_envs=64, seed=0, rnn_hidden=32,
        actor_hidden=(32,), critic_hidden=(32,))
    runner.learn(30)
    policy = runner.get_inference_policy()
    st, out = env.reset(128, torch.Generator().manual_seed(9))
    hidden = runner.model.initial_state(128)
    obs, mid = out.obs, []
    for t in range(6):
        a, hidden = policy(obs, hidden)
        st, out = env.step(st, a)
        obs = out.obs
        if t >= 1:
            mid.append(float(out.reward.mean()))
    assert float(np.mean(mid)) > 0.3, mid


def test_runners_from_one_seed_are_equal():
    env = PointGoalEnv(dim=2, ep_length=5, device="cpu")
    cfg = ppoc.ContinuousPPOConfig(num_learning_epochs=2, num_mini_batches=2)
    runs = []
    for _ in range(2):
        r = ppor.RecurrentOnPolicyRunner(env, cfg, num_steps_per_env=6,
                                         num_envs=4, seed=3, rnn_hidden=8,
                                         rnn_type="gru", actor_hidden=(8,),
                                         critic_hidden=(8,))
        runs.append((r.learn(2), r.model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


# ---------------------------------------------------------------------------
# the export (tests/test_aux.py's round trip) and the optimizer state


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_export_recurrent_policy_round_trip(tmp_path, rnn_type):
    """The exported program carries the hidden state in its signature and
    matches the live model over 3 steps of carried hidden state."""
    model = RecurrentActorCritic(OBS_DIM, N_ACT, H, rnn_type, HEADS, HEADS,
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / f"rec_{rnn_type}.pt2")
    n = play.export_recurrent_policy(model, OBS_DIM, path, batch=2)
    assert n > 0
    fn = play.load_exported_policy(path)
    g = torch.Generator().manual_seed(1)
    leaves = hidden_leaves(model.initial_state(2))
    hidden = model.initial_state(2)
    for _ in range(3):
        obs = torch.randn(2, OBS_DIM, generator=g)
        mean_e, *leaves = fn(obs, *leaves)
        with torch.no_grad():
            out, hidden = model(obs, hidden)
        assert len(leaves) == (4 if rnn_type == "lstm" else 2)
        torch.testing.assert_close(mean_e, out.mean, rtol=1e-5, atol=1e-6)
        for a, b in zip(leaves, hidden_leaves(hidden)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_recurrent_optimizer_state_conversion():
    """jax_continuous_opt_state_to_port walks the recurrent tree: the
    cells' moments stack gate by gate like their parameters."""
    params = _params("lstm", 8)
    tx = jax_ppoc.make_optimizer(jax_ppoc.ContinuousPPOConfig(max_grad_norm=1e9))
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), params)
    _, st = jax.jit(tx.update)(grads, tx.init(params), params)
    got = convert.jax_continuous_opt_state_to_port(st)
    names = sorted(dict(_port_model("lstm", params).named_parameters()))
    assert got.count == 1 and sorted(got.mu) == sorted(got.nu) == names
    assert got.mu["memory_a.weight_i"].shape == (4 * H, OBS_DIM)
    b1 = np.float32(1) - np.float32(0.9)
    np.testing.assert_allclose(got.mu["memory_c.bias_h"].numpy(),
                               b1 * np.float32(0.5), rtol=1e-6)
