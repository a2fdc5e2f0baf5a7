"""The plain reference agrees with the program at a tiny size on the CPU,
the harness's runs of both cells come out correct there, and each fault
a cell can have makes ``correct`` false (the tiny cells of ``tiny.py``;
the harness's look for a card is skipped by calling ``run_cell``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import faults, harness
from benchmark.reference import env as ref_env
from benchmark.reference import policy as ref_policy
from benchmark.reference import ppo as ref_ppo
from benchmark.tests import tiny

torch.set_num_threads(1)


def _port_env(cell, zbuf_impl: str = "mxu"):
    from gennbv_tpu_torch.env import ReconEnv
    cfg = cell.config["config"]
    cfg["env"]["renderer"]["zbuf_impl"] = zbuf_impl
    env = cfg["env"]
    tensors = harness.to_device(harness.scene_arrays(env, 4, 0), "cpu")
    port = ReconEnv(harness.port_config(cfg, 1).env,
                    harness.program_scenes(tensors, env))
    return port, ref_env.Env(env, tensors, env["renderer"]["resolution"])


@pytest.mark.parametrize("zbuf_impl", ["mxu", "pallas"])
def test_env_steps_equal_the_programs(zbuf_impl):
    port, ref = _port_env(tiny.tiny_cell("flagship128.train"), zbuf_impl)
    sid = torch.arange(4)
    ps, po = port.reset(4, sid)
    rs, ro = ref.reset(sid)
    g = torch.Generator().manual_seed(0)
    for _ in range(12):
        for name in ("obs", "reward", "done", "time_out", "coverage"):
            assert torch.equal(getattr(po, name), getattr(ro, name)), name
        a = torch.stack([torch.randint(0, n, (4,), generator=g)
                         for n in ref_env.NVEC], -1)
        ps, po = port.step(ps, a)
        rs, ro = ref.step(rs, a)


def _policies(model):
    from gennbv_tpu_torch.config import ModelConfig
    from gennbv_tpu_torch.models.policy import ActorCriticPolicy
    w = harness.weights(model, 5, "cpu")
    port = ActorCriticPolicy(ModelConfig(**model), None, "cpu")
    port.load_state_dict(w)
    ref = ref_policy.Policy(model, "cpu")
    ref.load_state_dict(w)
    return port, ref


def test_policy_equals_the_programs():
    from gennbv_tpu_torch.models import distributions
    model = tiny.tiny_cell("ref400.eval").config["config"]["model"]
    port, ref = _policies(model)
    obs = torch.rand(16, 16792)
    obs[:, 600:8600] = torch.randint(-1, 2, (16, 8000)).float()
    for train in (False, True):
        port.train(train)
        ref.train(train)
        out = port(obs)
        logits, value = ref(obs)
        torch.testing.assert_close(logits, out.logits, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(value, out.value, rtol=1e-5, atol=1e-6)
    actions = distributions.mode(out.logits)
    assert torch.equal(ref_policy.mode(out.logits), actions)
    torch.testing.assert_close(ref_policy.log_prob(out.logits, actions),
                               distributions.log_prob(out.logits, actions))
    torch.testing.assert_close(ref_policy.entropy(out.logits),
                               distributions.entropy(out.logits))


def test_ppo_steps_equal_the_programs():
    from gennbv_tpu_torch.algo import ppo
    cell = tiny.tiny_cell("flagship128.train")
    cfg = cell.config["config"]
    port_cfg = harness.port_config(cfg, 1)
    port, ref = _policies(cfg["model"])
    g = torch.Generator().manual_seed(1)
    m = 16
    data = (torch.rand(m, 16792, generator=g),
            torch.stack([torch.randint(0, n, (m,), generator=g)
                         for n in ref_env.NVEC], -1).int(),
            -17.8 + 0.1 * torch.rand(m, generator=g),
            torch.rand(m, generator=g), torch.randn(m, generator=g),
            torch.randn(m, generator=g))
    rows = torch.stack([torch.randperm(m, generator=g)[:8] for _ in range(3)])
    opt = ppo.make_optimizer(port_cfg.ppo, 4)
    state = opt.init(port)
    learner = ppo.Learner(port, opt, port_cfg.ppo)
    learner.begin(0)
    port.train()
    names = learner.names
    mu = [state.mu[n] for n in names]
    nu = [state.nu[n] for n in names]
    learner.run(data, rows, mu, nu)
    steps = ref_ppo.steps(ref, cfg["ppo"], 4, data, rows)
    assert len(steps) == 3 and all(applied for _, applied, _ in steps)
    for n, p in ref.named_parameters():
        torch.testing.assert_close(p, dict(port.named_parameters())[n],
                                   rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("workload", ["flagship128.train", "ref400.eval"])
def test_tiny_run_is_correct(workload):
    res = tiny.run_tiny(workload)
    assert res["correct"], res["checks"]
    assert res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, d in (("flagship128.train", "train"), ("ref400.eval", "eval"))
    for f in faults.BY_LOOP[d]])
def test_a_fault_makes_the_run_incorrect(workload, fault):
    loop = tiny.tiny_cell(workload).traffic["loop"]
    with faults.BY_LOOP[loop][fault]():
        res = tiny.run_tiny(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.BY_LOOP["train"]))
def test_a_fault_in_the_window_alone_makes_the_run_incorrect(monkeypatch,
                                                             fault):
    """The window's own iteration is held to the reference: a fault
    planted after set-up, for the window alone, is caught."""
    from benchmark.loops import train
    window = train.Loop.window

    def faulty(self, seconds):
        with faults.BY_LOOP["train"][fault]():
            return window(self, seconds)
    monkeypatch.setattr(train.Loop, "window", faulty)
    res = tiny.run_tiny("flagship128.train")
    assert not res["correct"], res["checks"]


def test_the_mix_states_the_programs_eval_env(monkeypatch):
    """The program's eval env is built from the mix's ``eval_env``; a mix
    that leaves a setting of the program's eval protocol unstated is
    refused."""
    from gennbv_tpu_torch import config
    from benchmark.loops import eval as eval_loop
    cell = tiny.tiny_cell("ref400.eval")
    loop = eval_loop.Loop(cell, 1, "cpu")
    port = harness.port_config(cell.config["config"], 1)
    assert loop.program_env_cfg(port).num_envs == 4
    protocol = config.eval_env_config
    monkeypatch.setattr(config, "eval_env_config", lambda env: dataclasses
                        .replace(protocol(env), collision_radius=9.0))
    with pytest.raises(ValueError, match="collision_radius"):
        loop.program_env_cfg(port)


@pytest.mark.parametrize("workload", ["flagship128.train", "ref400.eval"])
def test_the_control_precision_outlasts_the_programs_constructors(
        monkeypatch, workload):
    """TF32 is on when the program starts work: set after the env, policy
    and Runner constructors, which set float32 themselves."""
    from gennbv_tpu_torch.algo import evaluation, runner
    seen = []
    train, evaluate = runner.Runner.train, evaluation.evaluate

    def train_seen(self, *args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return train(self, *args, **kwargs)

    def evaluate_seen(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return evaluate(*args, **kwargs)
    monkeypatch.setattr(runner.Runner, "train", train_seen)
    monkeypatch.setattr(evaluation, "evaluate", evaluate_seen)
    try:
        tiny.run_tiny(workload, precision="tf32")
    finally:
        harness.set_tf32(False)
    assert seen[0] == (True, True)


def test_episode_results_equal_the_programs_protocol():
    from gennbv_tpu_torch.algo import evaluation
    from benchmark.loops.eval import _episode_results
    g = np.random.default_rng(0)
    rewards = g.random((6, 5)).astype(np.float32)
    dones = g.random((6, 5)) < 0.2
    coverage = g.random((6, 5)).astype(np.float32)
    init = g.random(5).astype(np.float32)
    before = evaluation.before_done_mask(dones)
    first = before.sum(0) - 1
    want = _episode_results(rewards, dones, coverage, init)
    np.testing.assert_array_equal(want[:5], coverage[first, np.arange(5)])
    assert want[-3] == float((first + 1).mean())
