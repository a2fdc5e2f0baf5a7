"""The training slice of the port: one whole JAX iteration (collect -> GAE
-> PPO update) replayed through the port, then the port's Runner, its
checkpoints, logger, profiling and the train CLIs on the CPU (the
Runner tests of tests/test_runner.py; its multi-device ones are in
tests/test_torch_mesh.py)."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import config as jax_config
from gennbv_tpu.algo import gae as jax_gae
from gennbv_tpu.algo import ppo as jax_ppo
from gennbv_tpu.algo import rollout as jax_rollout
from gennbv_tpu.algo import runner as jax_runner
from gennbv_tpu.env import ReconEnv as JaxReconEnv
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu.models import init_policy
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch.algo import gae, ppo, repro, rollout, runner
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.models import convert
from gennbv_tpu_torch.models import distributions as pt_dist
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.train import train_eval_gennbv, train_gennbv
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.checkpoint import CheckpointManager

NARROW = dict(pose_mlp_hidden=32, grid_channels=4, fused_dim=32)
N_ENVS, N_STEPS, MAX_LEN = 4, 8, 5


class _Replay(torch.nn.Module):
    """A policy that plays recorded actions and scores them with `policy`."""

    def __init__(self, policy, actions):
        super().__init__()
        self.policy = policy
        self.actions = iter(actions)

    def forward(self, obs):
        return self.policy(obs)

    @torch.no_grad()
    def act(self, obs, generator=None):
        out = self.policy(obs)
        actions = next(self.actions)
        return actions, out.value, pt_dist.log_prob(out.logits, actions)


def _env_cfg(mod):
    return mod.EnvConfig(
        num_envs=N_ENVS, max_episode_length=MAX_LEN,
        camera=mod.CameraConfig(height=16, width=16),
        renderer=mod.RendererConfig(resolution=16),
        scene=mod.SceneConfig(num_scenes=4, seed=2))


def test_iteration_replay_matches_jax():
    """JAX collect -> compute_gae -> ppo.update at 4 envs, a 16x16 camera
    and 8 steps, under the flagship's PPO settings (KL stop armed, value
    clip, linear schedule, 2 minibatch shards); the port replays the JAX
    actions and the JAX minibatch indices.  Advantages and returns agree
    to 1e-5 (the values' float32 tolerance); the updated parameters, BN
    stats, Adam state and metrics within the tolerances of
    tests/test_torch_ppo.py."""
    ppo_kw = dict(n_steps=N_STEPS, batch_size=8, n_epochs=2, learning_rate=3e-4,
                  lr_schedule="linear", total_iters=4, minibatch_shards=2)
    jcfg, pcfg = jax_config.PPOConfig(**ppo_kw), pt_config.PPOConfig(**ppo_kw)
    assert jcfg.target_kl == 0.05 and jcfg.clip_range_vf == 0.2

    env_cfg = _env_cfg(jax_config)
    jenv = JaxReconEnv(env_cfg, jax_scene.generate_procedural(env_cfg.scene, 16))
    model, variables = init_policy(jax_config.ModelConfig(**NARROW),
                                   jax.random.PRNGKey(7))
    tx = jax_ppo.make_optimizer(jcfg, N_ENVS)
    ts = jax_ppo.PPOTrainState(variables["params"], variables["batch_stats"],
                               tx.init(variables["params"]))
    state, out = jenv.reset(N_ENVS)
    _, _, jb, _ = jax_rollout.collect(jenv, model, variables, state, out.obs,
                                      jax.random.PRNGKey(8), N_STEPS, jcfg.gamma)
    jadv, jret = jax_gae.compute_gae(jb.rewards, jb.values,
                                     jb.dones.astype(jnp.float32), jb.last_values,
                                     jcfg.gamma, jcfg.gae_lambda)
    m = N_STEPS * N_ENVS
    flat = lambda x: x.reshape((m,) + x.shape[2:])  # noqa: E731
    upd_rng = jax.random.PRNGKey(9)
    ts2, jm = jax.device_get(jax_ppo.update(
        model, tx, jcfg, ts, flat(jb.obs), flat(jb.actions), flat(jb.log_probs),
        flat(jb.values), flat(jadv), flat(jret), upd_rng, num_envs=N_ENVS))
    jb = jax.device_get(jb)

    pcfg_env = _env_cfg(pt_config)
    penv = ReconEnv(pcfg_env, make_scenes(pcfg_env.scene, 16, "cpu"))
    policy = ActorCriticPolicy(pt_config.ModelConfig(**NARROW), device="cpu")
    policy.load_state_dict(convert.jax_to_state_dict(jax.device_get(variables)))
    replay = _Replay(policy, [torch.from_numpy(np.array(a)) for a in jb.actions])
    pstate, pout = penv.reset(N_ENVS)
    _, _, pb, _ = rollout.collect(penv, replay, pstate, pout.obs, None, N_STEPS,
                                  pcfg.gamma)
    assert pb.dones.any(), "episodes end inside the rollout"
    adv, ret = gae.compute_gae(pb.rewards, pb.values, pb.dones.float(),
                               pb.last_values, pcfg.gamma, pcfg.gae_lambda)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=0, atol=1e-5)

    from test_torch_ppo import _assert_same, _jax_indices
    indices = torch.tensor(_jax_indices(jcfg, m, N_ENVS, upd_rng), dtype=torch.long)
    opt = ppo.make_optimizer(pcfg, N_ENVS)
    pflat = lambda x: x.reshape((m,) + x.shape[2:])  # noqa: E731
    state, pm = ppo.update(
        policy, opt, pcfg, opt.init(policy), pflat(pb.obs), pflat(pb.actions),
        pflat(pb.log_probs), pflat(pb.values), pflat(adv), pflat(ret),
        num_envs=N_ENVS, indices=indices)
    assert pm.n_minibatches_done > 0
    _assert_same(policy, state, pm, ts2, jm)


# ---------------------------------------------------------------------------
# the Runner


def _tiny(**runner_kw):
    """tests/test_runner.py's small config."""
    return pt_config.Config(
        env=pt_config.EnvConfig(
            num_envs=4, camera=pt_config.CameraConfig(height=16, width=16),
            renderer=pt_config.RendererConfig(resolution=16),
            scene=pt_config.SceneConfig(num_scenes=2, seed=0),
            max_episode_length=4),
        ppo=pt_config.PPOConfig(n_steps=4, batch_size=8, n_epochs=1, total_iters=2),
        runner=pt_config.RunnerConfig(**{"seed": 0, "save_freq": 1, **runner_kw}),
    )


def _runner(tmp_path, name, cfg=None, **kw):
    return runner.Runner(cfg or _tiny(), log_dir=str(tmp_path / name),
                         device="cpu", **kw)


def test_two_iterations_metrics_finite(tmp_path):
    r = _runner(tmp_path, "run")
    metrics = r.train(2)
    r.close()
    assert runner._METRIC_KEYS == jax_runner._METRIC_KEYS
    assert set(runner._METRIC_KEYS) <= set(metrics)
    for k, v in metrics.items():
        assert np.isfinite(v), f"{k} is not finite: {v}"
    assert metrics["rollout/num_episodes"] > 0
    assert metrics["train/n_minibatches"] > 0
    assert metrics["train/learning_rate"] == pytest.approx(1e-4)
    for phase in ("rollout", "gae", "update"):
        assert metrics[f"time/{phase}"] > 0
    logged = [json.loads(line) for line in
              open(tmp_path / "run" / "metrics.jsonl")]
    assert [rec["step"] for rec in logged] == [1, 2]
    assert os.path.exists(tmp_path / "run" / "metrics.csv")
    assert json.load(open(tmp_path / "run" / "config.json"))["runner"]["seed"] == 0


def test_checkpoint_roundtrip(tmp_path):
    r = _runner(tmp_path, "ckpt_run")
    r.train(1, log=False)
    cm = CheckpointManager(str(tmp_path / "models"))
    assert cm.latest_step() is None
    cm.save_step(100, r.policy, r.opt_state)
    sd, state, step = cm.restore("rl_model_100_steps")
    assert step == 100 and cm.latest_step() == 100
    assert state.count == r.opt_state.count > 0
    for k, v in r.policy.state_dict().items():
        assert torch.equal(sd[k], v), k
    for k in state.mu:
        assert torch.equal(state.mu[k], r.opt_state.mu[k])
        assert torch.equal(state.nu[k], r.opt_state.nu[k])
    assert sorted(cm.restore_policy("rl_model_100_steps")) == sorted(sd)


def test_resume_from_checkpoint(tmp_path):
    """Train 2 iterations with saves, resume in a fresh runner: policy,
    optimizer state and step restored bit for bit, and num_iterations is
    a total."""
    r1 = _runner(tmp_path, "run")
    r1.train(2)
    r1.close()

    r2 = _runner(tmp_path, "run2")
    step = r2.restore(str(tmp_path / "run" / "models"))
    assert step == 2 * 4 * 4 and r2.global_step == step and r2.iteration == 2
    for k, v in r1.variables().items():
        assert torch.equal(r2.variables()[k], v), k
    assert r2.opt_state.count == r1.opt_state.count
    for k in r1.opt_state.mu:
        assert torch.equal(r2.opt_state.mu[k], r1.opt_state.mu[k])
        assert torch.equal(r2.opt_state.nu[k], r1.opt_state.nu[k])
    m = r2.train(3, log=False)
    assert r2.iteration == 3
    assert m and all(np.isfinite(v) for v in m.values())
    assert r2.train(1, log=False) == {}      # already past the target
    assert r2.iteration == 3

    with pytest.raises(FileNotFoundError, match="rl_model"):
        r2.restore(str(tmp_path / "nope"))
    assert not os.path.exists(tmp_path / "nope")

    # params-only warm start: the policy from a linear-schedule run, a
    # fresh optimizer and step counter
    cfg3 = _tiny()
    cfg3 = dataclasses.replace(cfg3, ppo=dataclasses.replace(cfg3.ppo,
                                                             lr_schedule="linear"))
    r_lin = _runner(tmp_path, "run3", cfg3)
    r_lin.train(1)
    r_lin.close()
    r4 = _runner(tmp_path, "run4")
    assert r4.restore(str(tmp_path / "run3" / "models"), params_only=True) == 0
    assert r4.global_step == 0 and r4.iteration == 0 and r4.opt_state.count == 0
    for k, v in r_lin.variables().items():
        assert torch.equal(r4.variables()[k], v), k
    m = r4.train(1, log=False)
    assert m and all(np.isfinite(v) for v in m.values())


def test_resume_restores_best_trackers(tmp_path):
    """The best-checkpoint trackers and the rolling rewards persist through
    runner_state.json, so a resumed run cannot clobber rl_model_best_*
    with a worse first value."""
    r1 = _runner(tmp_path, "run")
    r1.train(1)
    r1._best_eval = 0.987
    r1._save_runner_state()
    r1.train(2)
    best_before, buf_before = r1._best_metric, list(r1._rew_buffer)
    r1.close()
    models = tmp_path / "run" / "models"
    assert json.load(open(models / "runner_state.json"))["best_eval"] == 0.987
    assert (models / "rl_model_best_episode_reward").exists()

    r2 = _runner(tmp_path, "run2")
    r2.restore(str(models))
    assert r2._best_eval == 0.987
    assert r2._best_metric == best_before
    assert list(r2._rew_buffer) == buf_before

    (models / "runner_state.json").unlink()
    r3 = _runner(tmp_path, "run3")
    r3.restore(str(models))
    assert r3._best_eval == -float("inf")


def test_eval_camera_override(tmp_path):
    """runner.eval_camera evaluates under another camera than training's;
    the eval's checkpoint is the best-by-coverage one."""
    cfg = _tiny(save_freq=0, eval_freq=1, eval_camera=32)
    eval_scenes = make_scenes(pt_config.SceneConfig(num_scenes=2, seed=9), 16, "cpu")
    r = _runner(tmp_path, "run", cfg, eval_scenes=eval_scenes)
    assert r.eval_env.cfg.camera.height == 32
    assert r.env.cfg.camera.height == 16
    assert r.eval_env.cfg.max_episode_length == 30
    m = r.train(1)
    r.close()
    assert np.isfinite(m["eval/final_coverage"]) and m["time/eval_seconds"] > 0
    assert (tmp_path / "run" / "models" / "rl_model_best_eval_coverage").exists()
    assert CheckpointManager(str(tmp_path / "run" / "models")).latest_step() is None


def test_two_runs_at_one_seed_are_bit_equal(tmp_path):
    """One seed fixes the weights, the staggered episode lengths, the
    actions and the minibatches: two CPU runs agree bit for bit."""
    runs = []
    for i in range(2):
        r = _runner(tmp_path, f"run{i}", _tiny(seed=3))
        m = r.train(2, log=False)
        runs.append((m, r.variables(), r.opt_state))
    (ma, va, sa), (mb, vb, sb) = runs
    for k in runner._METRIC_KEYS:
        assert ma[k] == mb[k], k
    for k in va:
        assert torch.equal(va[k], vb[k]), k
    assert sa.count == sb.count
    other = _runner(tmp_path, "other", _tiny(seed=4))
    assert not torch.equal(other.variables()["action_net.weight"],
                           va["action_net.weight"])


def test_single_device_settings_accepted(tmp_path):
    """The single-device settings parse, and runner.pipeline_depth acts:
    iteration k's host work (fetch, log, eval, checkpoints) runs once
    iteration k + depth has been dispatched, and the queue drains at the
    end."""
    for override in ("runner.num_devices=1", "runner.pipeline_depth=4",
                     "runner.obs_dtype=bfloat16"):
        pt_config.apply_overrides(pt_config.Config(), (override,))
    want = {1: ["d1", "d2", "p1", "d3", "p2", "p3"],
            3: ["d1", "d2", "d3", "p1", "p2", "p3"]}
    for depth, order in want.items():
        r = _runner(tmp_path, f"depth{depth}", _tiny(pipeline_depth=depth))
        seen = []
        dispatch, process = r._dispatch, r._process_iter

        def dispatched(*args, _dispatch=dispatch):
            out = _dispatch(*args)
            seen.append(f"d{r.iteration + 1}")
            return out

        def processed(entry, _process=process):
            seen.append(f"p{entry.iteration}")
            return _process(entry)

        r._dispatch, r._process_iter = dispatched, processed
        r.train(3, log=False)
        assert seen == order, depth


def _depth_run(tmp_path, depth: int, iters: int = 4):
    """A Runner at `depth` from seed 5, evaluated and checkpointed every
    iteration; its snapshot (state and logged metrics)."""
    cfg = _tiny(seed=5, eval_freq=1, pipeline_depth=depth)
    eval_scenes = make_scenes(pt_config.SceneConfig(num_scenes=2, seed=9), 16,
                              "cpu")
    r = _runner(tmp_path, f"depth{depth}", cfg, eval_scenes=eval_scenes)
    r.train(iters)
    r.close()
    return r, repro.snapshot(r, repro.read_logged(str(tmp_path / f"depth{depth}")))


def _same_payload(a, b, where: str):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same_payload(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_pipeline_depths_are_bit_equal(tmp_path):
    """runner.pipeline_depth 1, 2 and 3 from one seed, with an eval and a
    checkpoint every iteration: the same parameters, BatchNorm stats,
    Adam state and logged metrics (eval's too) bit for bit, and the same
    checkpoint files (every step's, both best ones, the runner state);
    the last step's checkpoint holds the final policy.  The policy is
    updated in place while iteration k waits for its host work, so each
    eval and checkpoint must read iteration k's snapshot for this to
    hold.  A run resumed from depth 2's checkpoints equals one resumed
    from depth 1's."""
    runs = {depth: _depth_run(tmp_path, depth) for depth in (1, 2, 3)}
    base, snap = runs[1]
    assert [rec["step"] for rec in snap["logged"]] == [1, 2, 3, 4]
    assert all("eval/final_coverage" in rec for rec in snap["logged"])
    models = {d: tmp_path / f"depth{d}" / "models" for d in runs}
    files = sorted(os.listdir(models[1]))
    assert {f"rl_model_{16 * k}_steps" for k in range(1, 5)} <= set(files)
    assert {"rl_model_best_episode_reward", "rl_model_best_eval_coverage",
            "runner_state.json"} <= set(files)
    last = torch.load(models[1] / "rl_model_64_steps", weights_only=True)
    _same_payload(last["policy"], base.variables(), "final policy")
    for depth in (2, 3):
        assert repro.first_difference(snap, runs[depth][1]) is None, depth
        assert sorted(os.listdir(models[depth])) == files
        for name in files:
            if name.endswith(".json"):
                a, b = (json.load(open(models[d] / name)) for d in (1, depth))
            else:
                a, b = (torch.load(models[d] / name, weights_only=True)
                        for d in (1, depth))
            _same_payload(a, b, f"depth {depth} {name}")

    resumed = []
    for depth in (1, 2):
        r = _runner(tmp_path, f"resumed{depth}", _tiny(seed=5))
        assert r.restore(str(models[depth])) == 64
        r.train(5, log=False)
        resumed.append(repro.snapshot(r, []))
    assert repro.first_difference(*resumed) is None


def test_train_iteration_reads_nothing_on_the_host(tmp_path):
    """From the second iteration on, Runner.train_iteration (the rollout,
    GAE, the update, the packed metrics) runs with every host read
    refused; its metrics, read afterwards, equal those of a Runner from
    the same seed left to read."""
    from test_torch_ppo import no_host_reads
    packed = []
    for refused in (False, True):
        r = _runner(tmp_path, f"run{refused}")
        env_state, obs = r.setup()
        env_state, obs, _ = r.train_iteration(env_state, obs)
        with no_host_reads() if refused else contextlib.nullcontext():
            env_state, obs, metrics = r.train_iteration(env_state, obs)
        packed.append(metrics.tolist())
    assert packed[0] == packed[1]
    assert len(packed[0]) == len(runner._METRIC_KEYS)
    assert all(np.isfinite(packed[0]))


def test_bfloat16_observations(tmp_path):
    """runner.obs_dtype=bfloat16 stores the rollout's observations in
    bfloat16; the update reads them as float32."""
    r = _runner(tmp_path, "bf16", _tiny(obs_dtype="bfloat16"))
    assert r.obs_dtype == torch.bfloat16
    m = r.train(1, log=False)
    assert all(np.isfinite(v) for v in m.values())


CLI_ARGS = ["--device", "cpu", "--num_envs", "4", "--max_iterations", "2",
            "--set", "env.camera.height=16", "--set", "env.camera.width=16",
            "--set", "env.renderer.resolution=16", "--set", "env.scene.num_scenes=4",
            "--set", "ppo.n_steps=4", "--set", "ppo.batch_size=8",
            "--set", "runner.save_freq=1"]


def test_train_cli(tmp_path, capsys):
    """train_gennbv at 4 envs for 2 iterations, then --resume to 3."""
    train_gennbv.main(CLI_ARGS + ["--log_dir", str(tmp_path), "--exp_name", "cli"])
    out = capsys.readouterr().out
    assert "final:" in out and "train/approx_kl" in out
    (run,) = os.listdir(tmp_path)
    models = tmp_path / run / "models"
    assert CheckpointManager(str(models)).latest_step() == 2 * 4 * 4
    args = [a if a != "2" else "3" for a in CLI_ARGS]
    train_gennbv.main(args + ["--log_dir", str(tmp_path / "resumed"),
                              "--resume", str(models)])
    out = capsys.readouterr().out
    assert f"resumed from {models} at step 32" in out
    (run2,) = os.listdir(tmp_path / "resumed")
    logged = [json.loads(line)["step"]
              for line in open(tmp_path / "resumed" / run2 / "metrics.jsonl")]
    assert logged == [3]


def test_train_eval_cli(tmp_path, capsys, monkeypatch):
    """train_eval_gennbv: 50 held-out scenes of --eval_seed, evaluated every
    --eval_freq iterations.  Then, with the eval protocol cut to 4 envs x
    5 steps, --eval_dataset on a converted directory: the eval runs on its
    scenes, config.json records it, and post_run's held-out family takes
    it from there."""
    train_eval_gennbv.main(CLI_ARGS + ["--log_dir", str(tmp_path), "--eval_freq", "2"])
    assert "eval/final_coverage" in capsys.readouterr().out
    (run,) = os.listdir(tmp_path)
    logged = [json.loads(line) for line in open(tmp_path / run / "metrics.jsonl")]
    assert "eval/final_coverage" not in logged[0]
    assert np.isfinite(logged[1]["eval/final_coverage"])
    with open(tmp_path / run / "config.json") as f:
        assert "eval_dataset" not in json.load(f)

    from gennbv_tpu_torch import spec
    from gennbv_tpu_torch.tools import convert_dataset, post_run
    monkeypatch.setattr(spec, "EVAL_NUM_ENVS", 4)
    monkeypatch.setattr(spec, "MAX_EPISODE_LENGTH_EVAL", 5)
    meshes, data = tmp_path / "meshes", tmp_path / "eval_data"
    convert_dataset.write_procedural_meshes(str(meshes), 2, seed=100, res=16)
    convert_dataset.convert(str(meshes), str(data), 16, 20, 1.0, verbose=False)
    logs = tmp_path / "ds"
    train_eval_gennbv.main(CLI_ARGS + ["--log_dir", str(logs), "--eval_freq", "2",
                                       "--eval_dataset", str(data)])
    (run,) = os.listdir(logs)
    with open(logs / run / "config.json") as f:
        assert json.load(f)["eval_dataset"] == str(data)
    logged = [json.loads(line) for line in open(logs / run / "metrics.jsonl")]
    assert np.isfinite(logged[1]["eval/final_coverage"])
    report = post_run.main([str(logs / run), "--device", "cpu", "--no-artifacts",
                            "--only", "held_out_houses"])
    assert report["held_out_dataset"] == str(data) and report["eval_cam"] == 0
    assert np.isfinite(report["held_out_houses"]["final_coverage"])


def test_phase_timer_and_trace(tmp_path):
    """Device-timed spans (the phase timer) hand a unit's seconds over
    once; a trace holds the spans of its block."""
    with profiling.span("rollout", "timer-test", "cpu"):
        torch.arange(1000.0).sum()
    with profiling.span("training", "timer-test", "cpu"):
        pass
    m = profiling.phases("timer-test").metrics()
    assert sorted(m) == ["time/rollout", "time/training"]
    assert m["time/rollout"] > 0
    assert profiling.phases("timer-test").metrics() == {}
    with profiling.trace(None):
        pass
    d = tmp_path / "trace"
    with profiling.trace(str(d)):
        with profiling.span("traced/block"):
            torch.ones(8).sum()
    assert (d / "trace.json").exists()
    events = json.load(open(d / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "traced/block" for e in events)
    spans = [json.loads(line) for line in open(d / "spans.jsonl")]
    assert [s["name"] for s in spans] == ["traced/block"]
