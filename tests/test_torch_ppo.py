"""The port's PPO learner (``gennbv_tpu_torch/algo/ppo.py``) against the JAX
package's (``gennbv_tpu/algo/ppo.py``): the optimizer, the minibatch
layout, and whole updates at a narrow HybridEncoder from the same weights,
data and minibatch indices; then the learner tests of tests/test_ppo.py
on the port alone."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gennbv_tpu import spec
from gennbv_tpu.algo import ppo as jax_ppo
from gennbv_tpu.config import ModelConfig as JaxModelConfig
from gennbv_tpu.config import PPOConfig as JaxPPOConfig
from gennbv_tpu.models import distributions as jax_dist
from gennbv_tpu.models import init_policy
from gennbv_tpu_torch.algo import ppo
from gennbv_tpu_torch.config import ModelConfig, PPOConfig
from gennbv_tpu_torch.models import convert
from gennbv_tpu_torch.models import distributions as pt_dist
from gennbv_tpu_torch.models.encoder import BatchNorm
from gennbv_tpu_torch.models.policy import ActorCriticPolicy, PolicyOutput

NARROW = dict(pose_mlp_hidden=32, grid_channels=4, fused_dim=32)
N_ENVS, N_STEPS = 8, 16                       # M = 128 transitions
# Parameters, BN stats and Adam moments after a whole update: float32 sums
# in another order put the gradients ~1e-7 apart relative, and Adam's
# first steps divide by sqrt(v) ~ |g|, so the parameter steps (lr = 3e-4)
# agree to ~1e-8 and the trained parameters to 2e-6
PARAM_ATOL = 2e-6
# The conv biases ahead of a BatchNorm have a zero gradient in exact
# arithmetic (the BN subtracts their per-channel constant): each side
# computes float32 cancellation noise of ~1e-8, different on either side,
# which Adam (eps 1e-5) turns into steps of up to ~lr * 1e-3 a minibatch.
# Those two parameters, their moments and the BN running means, which take
# in the biases, are held to that noise level.
NOISE = ("encoder.grid_conv1.bias", "encoder.grid_conv2.bias",
         "encoder.grid_bn1.running_mean", "encoder.grid_bn2.running_mean")
NOISE_PARAM_ATOL = 3e-5
# Adam's moments are sums of the minibatch gradients (nu of their squares).
# Each gradient element carries a float32 rounding error set by the scale
# of its tensor's gradients, not by the element: the activations it sums
# over differ between the sides by the parameters' ~1e-6 relative drift,
# and the rounding of the products and sums by the host CPU's vector path
# (XLA compiles for the host's ISA, ATen picks AVX2 or AVX-512 kernels;
# on one host, forcing XLA to AVX2 moved action_net's error 1.5x).  Near-
# zero first moments, where gradients cancel, keep that absolute error, so
# an elementwise relative tolerance on them depends on the host (one host
# put two entries of action_net's mu 2.0e-6 of the tensor's largest |mu|
# off, 1.0e-3 of their own value).  Measured over ISA paths: up to 2.2e-6
# of the tensor's largest |mu|, 5.6e-6 of its largest nu.  Each moment is
# held to 1e-4 relative plus this fraction of its tensor's largest entry
# (twice as much for nu, a square), ~9x and ~7x above those errors.
MOMENT_RTOL = 1e-4
MOMENT_SCALE_TOL = {"mu": 2e-5, "nu": 4e-5}
NOISE_MOMENT_ATOL = {"mu": 1e-6, "nu": 1e-12}
# losses and KL are float32 means over 32 rows: 1e-5 relative; the
# explained variance, 1 minus a ratio of two float32 variances near 1, to
# 1e-6 absolute
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6


def _cfg(**kw):
    base = dict(n_steps=N_STEPS, batch_size=32, n_epochs=2, learning_rate=3e-4,
                minibatch_shards=4)
    base.update(kw)
    return JaxPPOConfig(**base), PPOConfig(**base)


def _obs(n, seed):
    """Observations with the env's layout: poses, a tri-class grid, frames."""
    rng = np.random.default_rng(seed)
    pose = rng.uniform(-8, 10, (n, spec.STATE_DIM))
    grid = rng.choice([-1.0, 0.0, 1.0], (n, spec.GRID_DIM))
    rgb = rng.uniform(0, 255, (n, spec.RGB_DIM))
    return np.concatenate([pose, grid, rgb], -1).astype(np.float32)


def _rollout_data(model, variables, seed):
    """A flat rollout [M] of N_ENVS x N_STEPS transitions (t-major): old
    log-probs and values from the JAX policy in eval mode, as collect
    records them; random advantages."""
    m = N_ENVS * N_STEPS
    rng = np.random.default_rng(seed)
    obs = _obs(m, seed)
    actions = np.stack([rng.integers(0, k, m) for k in spec.NVEC], -1).astype(np.int32)
    out = model.apply(variables, jnp.asarray(obs), train=False)
    logp = np.asarray(jax_dist.log_prob(out.logits, actions))
    values = np.asarray(out.value)
    adv = rng.normal(0, 1, m).astype(np.float32)
    return dict(obs=obs, actions=actions, old_log_probs=logp, old_values=values,
                advantages=adv, returns=(adv + values).astype(np.float32))


def _jax_indices(cfg, m, num_envs, rng):
    """The minibatch positions ppo.update draws from `rng` (ppo.py:137-144)."""
    s = jax_ppo._minibatch_shards(cfg, num_envs)
    ml, bl, n_mb = m // s, cfg.batch_size // s, m // cfg.batch_size
    keys = jax.random.split(rng, cfg.n_epochs * s).reshape(cfg.n_epochs, s, 2)
    perms = jax.vmap(jax.vmap(lambda k: jax.random.permutation(k, ml)))(keys)
    return np.asarray(perms.reshape(cfg.n_epochs, s, n_mb, bl)
                      .transpose(0, 2, 1, 3).reshape(cfg.n_epochs * n_mb, s, bl))


def _jax_update(model, cfg, ts, data, rng):
    tx = jax_ppo.make_optimizer(cfg, N_ENVS)
    fn = jax.jit(lambda ts, d, r: jax_ppo.update(
        model, tx, cfg, ts, d["obs"], d["actions"], d["old_log_probs"],
        d["old_values"], d["advantages"], d["returns"], r, num_envs=N_ENVS))
    return jax.device_get(fn(ts, {k: jnp.asarray(v) for k, v in data.items()}, rng))


def _port(ts):
    """(policy, AdamState) from a JAX train state."""
    policy = ActorCriticPolicy(ModelConfig(**NARROW), device="cpu")
    policy.load_state_dict(convert.jax_to_state_dict(
        {"params": ts.params, "batch_stats": ts.batch_stats}))
    return policy, convert.jax_opt_state_to_port(ts.opt_state)


def _port_update(policy, cfg, state, data, indices):
    opt = ppo.make_optimizer(cfg, N_ENVS)
    t = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    return ppo.update(policy, opt, cfg, state, t["obs"], t["actions"],
                      t["old_log_probs"], t["old_values"], t["advantages"],
                      t["returns"], num_envs=N_ENVS,
                      indices=torch.tensor(indices, dtype=torch.long))


def _assert_same(policy, state, metrics, ts, jm):
    want_sd = convert.jax_to_state_dict(
        {"params": ts.params, "batch_stats": ts.batch_stats})
    for name, got in policy.state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert got == 0, name
            continue
        np.testing.assert_allclose(
            got.numpy(), want_sd[name].numpy(), rtol=0,
            atol=NOISE_PARAM_ATOL if name in NOISE else PARAM_ATOL, err_msg=name)
    want = convert.jax_opt_state_to_port(ts.opt_state)
    assert state.count == want.count
    for moment in ("mu", "nu"):
        for name, got in getattr(state, moment).items():
            w = getattr(want, moment)[name].numpy()
            tol = (dict(rtol=0, atol=NOISE_MOMENT_ATOL[moment]) if name in NOISE
                   else dict(rtol=MOMENT_RTOL, atol=MOMENT_SCALE_TOL[moment]
                             * float(np.abs(w).max())))
            np.testing.assert_allclose(got.numpy(), w,
                                       err_msg=f"{moment} {name}", **tol)
    assert metrics.n_minibatches_done == float(jm.n_minibatches_done)
    for field in metrics._fields:
        np.testing.assert_allclose(getattr(metrics, field),
                                   float(getattr(jm, field)),
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=field)


@pytest.fixture(scope="module")
def narrow():
    model, variables = init_policy(JaxModelConfig(**NARROW), jax.random.PRNGKey(5))
    return model, jax.device_get(variables)


def _fresh_ts(variables, cfg):
    tx = jax_ppo.make_optimizer(cfg, N_ENVS)
    return jax_ppo.PPOTrainState(variables["params"], variables["batch_stats"],
                                 tx.init(variables["params"]))


def _run_case(narrow, jcfg, pcfg, data_seed, ts=None, perturb=0.0):
    model, variables = narrow
    ts = ts if ts is not None else _fresh_ts(variables, jcfg)
    data = _rollout_data(model, {"params": ts.params,
                                 "batch_stats": ts.batch_stats}, data_seed)
    data["old_log_probs"] = data["old_log_probs"] + np.float32(perturb)
    rng = jax.random.PRNGKey(data_seed)
    ts2, jm = _jax_update(model, jcfg, ts, data, rng)
    policy, state = _port(ts)
    indices = _jax_indices(jcfg, N_ENVS * N_STEPS, N_ENVS, rng)
    state, pm = _port_update(policy, pcfg, state, data, indices)
    _assert_same(policy, state, pm, ts2, jm)
    return policy, pm, ts, ts2


def test_update_from_fresh_state(narrow):
    """All 8 minibatches of 2 epochs over 4 shards, from optax's zero state."""
    jcfg, pcfg = _cfg(target_kl=None)
    _, pm, _, _ = _run_case(narrow, jcfg, pcfg, 11)
    assert pm.n_minibatches_done == 8


def test_update_from_converted_mid_run_state(narrow):
    """A second update under the linear schedule from the JAX state after a
    first one (count 8 of 16: the bias correction past its first step and
    the lr at half), carried over by jax_opt_state_to_port."""
    model, variables = narrow
    jcfg, pcfg = _cfg(target_kl=None, lr_schedule="linear", total_iters=2,
                      learning_rate=1e-3)
    ts0 = _fresh_ts(variables, jcfg)
    data = _rollout_data(model, variables, 20)
    ts_mid, _ = _jax_update(model, jcfg, ts0, data, jax.random.PRNGKey(20))
    assert convert.jax_opt_state_to_port(ts_mid.opt_state).count == 8
    _, pm, _, ts2 = _run_case(narrow, jcfg, pcfg, 21, ts=ts_mid)
    assert convert.jax_opt_state_to_port(ts2.opt_state).count == 16
    assert ppo.make_optimizer(pcfg, N_ENVS).lr(8) == pytest.approx(5e-4)


def test_update_with_the_clip_engaged(narrow):
    """max_grad_norm small enough that every minibatch's gradient is
    clipped."""
    model, variables = narrow
    jcfg, pcfg = _cfg(target_kl=None, max_grad_norm=0.05)
    data = _rollout_data(model, variables, 30)
    policy, _ = _port(_fresh_ts(variables, jcfg))
    t = {k: torch.from_numpy(np.array(v[:32])) for k, v in data.items()}
    loss, _ = ppo._loss(policy.train(), pcfg, t["obs"], t["actions"],
                        t["old_log_probs"], t["old_values"], t["advantages"],
                        t["returns"])
    norm = float(ppo.global_norm(torch.autograd.grad(loss, list(policy.parameters()))))
    assert norm > 4 * pcfg.max_grad_norm, norm
    _run_case(narrow, jcfg, pcfg, 30)


def test_kl_stop_at_the_first_minibatch(narrow):
    """Old log-probs one nat off: the first minibatch's KL breaches
    1.5 * target_kl, so nothing is applied, BN stats included."""
    model, variables = narrow
    jcfg, pcfg = _cfg(target_kl=0.01)
    policy, pm, ts, _ = _run_case(narrow, jcfg, pcfg, 40, perturb=1.0)
    assert pm.n_minibatches_done == 0
    assert pm.policy_loss == 0.0 and pm.approx_kl == 0.0
    before = convert.jax_to_state_dict({"params": ts.params,
                                        "batch_stats": ts.batch_stats})
    for name, got in policy.state_dict().items():
        assert torch.equal(got, before[name]), name


def test_kl_stop_mid_run(narrow, monkeypatch):
    """A stop after some minibatches: the same count as JAX, and the KLs
    on either side of the stop clear the threshold by 20% (the margin is
    checked on the port's KLs of the run without a stop, which are the
    same up to the stop)."""
    model, variables = narrow
    target = 0.004
    jcfg, pcfg = _cfg(target_kl=target, learning_rate=3e-3)
    kls = []
    real_loss = ppo._loss

    def recording_loss(*args):
        loss, metrics = real_loss(*args)
        kls.append(float(metrics[3]))
        return loss, metrics

    monkeypatch.setattr(ppo, "_loss", recording_loss)
    data = _rollout_data(model, variables, 50)
    indices = _jax_indices(jcfg, N_ENVS * N_STEPS, N_ENVS, jax.random.PRNGKey(50))
    policy, state = _port(_fresh_ts(variables, jcfg))
    _port_update(policy, dataclasses.replace(pcfg, target_kl=None), state, data,
                 indices)
    thr = 1.5 * target
    stop = next(i for i, kl in enumerate(kls) if kl > thr)
    assert 0 < stop < 7, kls
    assert max(kls[:stop]) < thr / 1.2 and kls[stop] > thr * 1.2, kls
    kls.clear()
    _, pm, _, _ = _run_case(narrow, jcfg, pcfg, 50)
    assert pm.n_minibatches_done == stop


# every Tensor method that brings a value to the host
HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__float__",
              "__int__")


@contextlib.contextmanager
def no_host_reads():
    """Raises from any Tensor method that reads a value on the host: on a
    card each would wait for the device."""
    def refuse(name):
        def read(*args, **kwargs):
            raise AssertionError(f"Tensor.{name} read a value on the host")
        return read

    with pytest.MonkeyPatch.context() as mp:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, refuse(name))
        yield


def test_update_with_a_kl_stop_reads_nothing_on_the_host(narrow):
    """One update with a stop mid-run (test_kl_stop_mid_run's case) runs
    with every host read refused; its state and metrics, read afterwards,
    equal JAX's at the tolerances above."""
    model, variables = narrow
    jcfg, pcfg = _cfg(target_kl=0.004, learning_rate=3e-3)
    ts = _fresh_ts(variables, jcfg)
    data = _rollout_data(model, variables, 50)
    rng = jax.random.PRNGKey(50)
    ts2, jm = _jax_update(model, jcfg, ts, data, rng)
    assert 0 < float(jm.n_minibatches_done) < 8
    policy, state = _port(ts)
    indices = _jax_indices(jcfg, N_ENVS * N_STEPS, N_ENVS, rng)
    with no_host_reads():
        with pytest.raises(AssertionError, match="Tensor.item"):
            torch.zeros(()).item()
        state, pm = _port_update(policy, pcfg, state, data, indices)
    assert isinstance(state.count, torch.Tensor)
    _assert_same(policy, state, pm, ts2, jm)


@pytest.mark.parametrize("schedule", ["linear", "constant"])
def test_schedule_tables_equal_the_optimizer(schedule):
    """The device tables give Optimizer.lr(c) and apply_'s bias
    corrections of step c + 1 bit for bit at every count: across the
    linear anneal's end (and, under the constant schedule, the constant)
    and past the step where both corrections settle at 1.0; and the
    flagship's anneal (1,280,000 updates) at sampled counts."""
    cfg = PPOConfig(learning_rate=3e-4, lr_schedule=schedule, n_epochs=2,
                    n_steps=4, batch_size=8, total_iters=5)
    opt = ppo.make_optimizer(cfg, 8)
    tables = ppo.schedule_tables(opt, "cpu")
    settle = tables.bias.shape[0]
    assert 17_000 < settle < 18_000       # 1 - 0.999^step reaches 1.0
    assert tables.lr.shape[0] == (
        opt.total_updates + 1 if schedule == "linear" else 1)
    for c in range(settle + 30):
        lr, bc1, bc2 = tables.at(torch.tensor(c))
        assert float(lr) == opt.lr(c), c
        assert (float(bc1), float(bc2)) == opt.bias_corrections(c + 1), c
    flagship = dataclasses.replace(opt, learning_rate=1e-4,
                                   total_updates=1_280_000)
    lr_table = ppo.schedule_tables(flagship, "cpu").lr
    for c in [*range(0, 1_280_001, 997), 1_279_999, 1_280_000]:
        assert float(lr_table[c]) == flagship.lr(c), c


@pytest.mark.parametrize("max_norm", [10.0, 0.3])
def test_gated_step_equals_apply(max_norm):
    """gated_apply_ (count and schedule on the device, the clip and the
    keep as selects) against apply_ (host count and floats): bit for bit
    where a step is kept, nothing moved where it is not."""
    cfg = PPOConfig(learning_rate=1e-2, lr_schedule="linear", n_epochs=1,
                    n_steps=4, batch_size=8, total_iters=5,
                    max_grad_norm=max_norm)
    opt = ppo.make_optimizer(cfg, 8)
    tables = ppo.schedule_tables(opt, "cpu")
    rng = np.random.default_rng(4)
    p0 = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=7).astype(np.float32)]
    host = [[torch.from_numpy(x.copy()) for x in p0]] + [
        [torch.zeros(x.shape) for x in p0] for _ in range(2)]
    dev = [[t.clone() for t in ts] for ts in host]
    count, dev_count = 0, torch.zeros((), dtype=torch.int64)
    for k in range(30):
        g = [torch.from_numpy(rng.normal(0, 0.2, x.shape).astype(np.float32))
             for x in p0]
        keep = k % 3 != 1
        go = None if k < 6 else torch.tensor(keep)
        before = [[t.clone() for t in ts] for ts in dev]
        norm = ppo.global_norm(g)
        opt.gated_apply_(dev[0], [x.clone() for x in g], dev[1], dev[2],
                         dev_count, norm, tables, go)
        if go is None or keep:
            count = opt.apply_(host[0], g, host[1], host[2], count,
                               float(norm))
            want = host
        else:
            want = before
        assert int(dev_count) == count
        for a, b in zip(dev, want):
            for x, y in zip(a, b):
                assert torch.equal(x, y), k
    assert count == 22


def test_minibatch_rows_are_the_shard_major_gather():
    """flat_rows gathers what the JAX learner's shard-major relayout and
    per-shard take gather (ppo.py:109-114, 203-206), and an epoch of
    minibatch_indices visits every transition once."""
    cfg = PPOConfig(n_steps=6, batch_size=12, n_epochs=3, minibatch_shards=4)
    t_len, n = 6, 8
    m = t_len * n
    s = ppo._minibatch_shards(cfg, n)
    assert s == 4
    x = np.arange(m * 2).reshape(m, 2)
    idx = ppo.minibatch_indices(cfg, m, n, torch.Generator().manual_seed(0))
    assert idx.shape == (3 * 4, s, 3)
    rows = ppo.flat_rows(idx, m, n).numpy()
    shard_major = x.reshape(t_len, s, n // s, 2).swapaxes(0, 1).reshape(s, -1, 2)
    for k in range(idx.shape[0]):
        want = shard_major[np.arange(s)[:, None], idx[k].numpy()].reshape(-1, 2)
        np.testing.assert_array_equal(x[rows[k]], want)
    for epoch in range(3):
        assert sorted(rows[epoch * 4:(epoch + 1) * 4].ravel()) == list(range(m))
    # shards adapt downward to a divisor of both num_envs and batch_size
    assert ppo._minibatch_shards(PPOConfig(batch_size=12, minibatch_shards=8), 9) == 3


@pytest.mark.parametrize("schedule,max_norm", [("constant", 10.0),
                                               ("linear", 10.0),
                                               ("linear", 0.3)])
def test_optimizer_matches_optax(schedule, max_norm):
    """Twelve steps of the clipped Adam on seeded gradients against
    optax's chain, with and without the clip, across the linear anneal."""
    cfg = PPOConfig(learning_rate=1e-2, lr_schedule=schedule, n_epochs=1,
                    n_steps=4, batch_size=8, total_iters=5, max_grad_norm=max_norm)
    tx = jax_ppo.make_optimizer(JaxPPOConfig(**dataclasses.asdict(cfg)), 8)
    opt = ppo.make_optimizer(cfg, 8)
    assert opt.total_updates == (20 if schedule == "linear" else None)
    rng = np.random.default_rng(3)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=7).astype(np.float32)}
    jp, js = {k: jnp.asarray(v) for k, v in p0.items()}, None
    js = tx.init(jp)
    tp = [torch.from_numpy(p0["a"].copy()), torch.from_numpy(p0["b"].copy())]
    mu, nu, count = [torch.zeros_like(p) for p in tp], [torch.zeros_like(p) for p in tp], 0
    for _ in range(12):
        g = {k: rng.normal(0, 0.2, v.shape).astype(np.float32) for k, v in p0.items()}
        u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        tg = [torch.from_numpy(g["a"]), torch.from_numpy(g["b"])]
        count = opt.apply_(tp, tg, mu, nu, count, float(ppo.global_norm(tg)))
        # float32 ulps of the norm, the power and the products
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp["a"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tp[1].numpy(), np.asarray(jp["b"]), rtol=0, atol=1e-6)
    assert count == 12
    with pytest.raises(ValueError, match="lr_schedule"):
        ppo.make_optimizer(PPOConfig(lr_schedule="cosine"), 8)


def test_optimizer_state_conversion(narrow):
    """jax_opt_state_to_port maps optax's mu, nu and count like the
    parameters, for every parameter of the policy."""
    model, variables = narrow
    jcfg, _ = _cfg(lr_schedule="linear", max_grad_norm=1e9)   # no clip
    tx = jax_ppo.make_optimizer(jcfg, N_ENVS)
    st = tx.init(variables["params"])
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), variables["params"])
    _, st = tx.update(grads, st, variables["params"])
    got = convert.jax_opt_state_to_port(st)
    policy = ActorCriticPolicy(ModelConfig(**NARROW), device="cpu")
    names = [n for n, _ in policy.named_parameters()]
    assert sorted(got.mu) == sorted(names) and sorted(got.nu) == sorted(names)
    assert got.count == 1
    for n, p in policy.named_parameters():
        assert got.mu[n].shape == p.shape
        np.testing.assert_allclose(got.mu[n].numpy(), 0.05, rtol=1e-6)
        np.testing.assert_allclose(got.nu[n].numpy(), 0.00025, rtol=1e-5)


# ---------------------------------------------------------------------------
# the learner tests of tests/test_ppo.py, on the port alone


class TinyPolicy(torch.nn.Module):
    """Minimal actor-critic over a 4-dim obs, with a BatchNorm so the
    running-stats plumbing is exercised."""

    def __init__(self, gen):
        super().__init__()
        self.fc = torch.nn.Linear(4, 64)
        self.bn = BatchNorm(64, eps=1e-5, momentum=0.1)
        self.pi = torch.nn.Linear(64, spec.NUM_LOGITS)
        self.v = torch.nn.Linear(64, 1)
        with torch.no_grad():
            for lin in (self.fc, self.pi, self.v):
                torch.nn.init.normal_(lin.weight, 0, 1 / lin.in_features ** 0.5,
                                      generator=gen)
                lin.bias.zero_()

    def forward(self, obs):
        h = self.bn(torch.relu(self.fc(obs)))
        return PolicyOutput(logits=self.pi(h), value=self.v(h)[..., 0])


def _bandit(policy, gen, n=512):
    """One-step bandit: reward 1 iff action x-component == target(obs)."""
    targets = torch.randint(0, 4, (n,), generator=gen)
    obs = torch.nn.functional.one_hot(targets, 4).float()
    was = policy.training
    policy.eval()
    with torch.no_grad():
        out = policy(obs)
    policy.train(was)
    actions = pt_dist.sample(out.logits, gen)
    logp = pt_dist.log_prob(out.logits, actions)
    rewards = (actions[:, 0] == targets).float()
    return obs, actions, logp, out.value, rewards - out.value, rewards


def _train_bandit(cfg, iters, seed):
    gen = torch.Generator().manual_seed(seed)
    policy = TinyPolicy(gen)
    opt = ppo.make_optimizer(cfg)
    state = opt.init(policy)
    rewards0 = None
    for _ in range(iters):
        obs, act, logp, val, adv, rew = _bandit(policy, gen)
        rewards0 = float(rew.mean()) if rewards0 is None else rewards0
        state, metrics = ppo.update(policy, opt, cfg, state, obs, act, logp, val,
                                    adv, rew, gen)
    return policy, gen, rewards0, metrics


def test_bandit_learns():
    cfg = PPOConfig(batch_size=128, n_epochs=4, learning_rate=3e-3,
                    target_kl=None, policy_loss_mult=1.0, clip_range_vf=None)
    policy, gen, mean_r0, _ = _train_bandit(cfg, 30, 0)
    final = float(_bandit(policy, gen)[-1].mean())
    assert final > 0.8, f"bandit not learned: {mean_r0} -> {final}"
    assert final > mean_r0 + 0.3


def test_entropy_floor_preserves_entropy():
    """With a hinge entropy floor near the max, repeated updates keep the
    policy's entropy higher than the reference loss does."""
    def run(ent_floor):
        cfg = PPOConfig(batch_size=128, n_epochs=4, learning_rate=3e-3,
                        target_kl=None, policy_loss_mult=1.0, clip_range_vf=None,
                        ent_floor=ent_floor, ent_floor_coef=1.0)
        return -_train_bandit(cfg, 15, 3)[-1].entropy_loss
    ent_free, ent_floored = run(None), run(17.0)   # max entropy ~17.8
    assert ent_floored > ent_free + 0.5, (ent_free, ent_floored)


def test_update_runs_all_minibatches_without_target_kl():
    cfg = PPOConfig(batch_size=64, n_epochs=3, target_kl=None)
    gen = torch.Generator().manual_seed(2)
    policy = TinyPolicy(gen)
    opt = ppo.make_optimizer(cfg)
    obs, act, logp, val, adv, rew = _bandit(policy, gen, n=256)
    _, metrics = ppo.update(policy, opt, cfg, opt.init(policy), obs, act, logp,
                            val, adv, rew, gen)
    assert metrics.n_minibatches_done == 3 * (256 // 64)
    assert np.isfinite(metrics.policy_loss)
    assert np.isfinite(metrics.explained_variance)


class TestApplyModeParity:
    """apply_mode "select" and "cond" give the same update in the JAX
    package; the port takes either (one path: the gated step computes and
    selects) and rejects anything else."""

    def _run(self, apply_mode, target_kl):
        cfg = PPOConfig(batch_size=64, n_epochs=3, learning_rate=1e-3,
                        target_kl=target_kl, policy_loss_mult=10.0,
                        apply_mode=apply_mode)
        gen = torch.Generator().manual_seed(7)
        policy = TinyPolicy(gen)
        opt = ppo.make_optimizer(cfg)
        obs, act, logp, val, adv, rew = _bandit(policy, gen, n=256)
        state, m = ppo.update(policy, opt, cfg, opt.init(policy), obs, act, logp,
                              val, adv, rew, gen)
        return policy.state_dict(), state, m

    @pytest.mark.parametrize("target_kl", [0.5, 1e-5])
    def test_select_and_cond_bitwise_equal(self, target_kl):
        sd_a, st_a, m_a = self._run("select", target_kl)
        sd_b, st_b, m_b = self._run("cond", target_kl)
        for k in sd_a:
            assert torch.equal(sd_a[k], sd_b[k]), k
        for k in st_a.mu:
            assert torch.equal(st_a.mu[k], st_b.mu[k])
            assert torch.equal(st_a.nu[k], st_b.nu[k])
        assert st_a.count == st_b.count and m_a == m_b
        if target_kl == 1e-5:
            assert m_a.n_minibatches_done < 12.0     # it really stopped

    def test_bad_mode_rejected(self):
        with pytest.raises(ValueError, match="apply_mode"):
            self._run("typo", 0.5)
