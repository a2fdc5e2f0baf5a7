"""Training runner (port of ``gennbv_tpu/algo/runner.py``): the single loop
replacing the reference's SB3 learn() / rsl_rl OnPolicyRunner pair.

Each iteration collects a rollout (128 env steps), computes GAE and runs
the 5-epoch minibatched PPO update, all on the runner's device; then the
rollout's metrics come to the host in one fetch, and the host logs,
evaluates and checkpoints.  The loop is synchronous: the JAX runner
overlaps iteration k+1 with iteration k's host work
(``runner.pipeline_depth``), but the port's update already waits on the
host for each minibatch's KL, so there is no queue to fill.  Eval and
checkpoints see iteration k's parameters, as they do there.  Every random
draw (initial weights, staggered episode lengths, actions, minibatch
permutations) comes from one ``torch.Generator`` on the device, seeded
with ``runner.seed``.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.algo import evaluation, gae, ppo, rollout
from gennbv_tpu_torch.config import (EXTERNAL_DEPTH_MODES, Config,
                                     config_to_dict, eval_env_config,
                                     with_camera)
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.checkpoint import CheckpointManager
from gennbv_tpu_torch.utils.logger import Logger

# fixed order of the per-iteration scalar metrics (the JAX runner's): the
# first nine come from the rollout in one device tensor, fetched once
_METRIC_KEYS = (
    "rollout/rew_surface_coverage",
    "rollout/rew_short_path",
    "rollout/rew_termination",
    "rollout/episode_reward",
    "rollout/episode_length",
    "rollout/final_coverage",
    "rollout/collision_rate",
    "rollout/num_episodes",
    "rollout/mean_reward_per_step",
    "train/policy_gradient_loss",
    "train/value_loss",
    "train/entropy_loss",
    "train/approx_kl",
    "train/clip_fraction",
    "train/n_minibatches",
    "train/explained_variance",
    "train/learning_rate",
)


class Runner:
    def __init__(self, cfg: Config, scenes=None, eval_scenes=None,
                 log_dir: Optional[str] = None,
                 device: torch.device | str = "cuda", depth_source=None,
                 eval_depth_source=None, eval_dataset: Optional[str] = None):
        """depth_source, eval_depth_source: the external depth feeds of
        renderer.mode "replay" / "callback" (env/depth_sources.py) for the
        training and the eval env.  eval_dataset: the directory the eval
        scenes came from, if not the training family's; it is written into
        the run's config.json (``eval_dataset``), where post_run takes its
        held-out family from."""
        self.cfg = cfg
        self.eval_dataset = eval_dataset
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.runner.seed)

        self.scenes = scenes if scenes is not None else make_scenes(
            cfg.env.scene, cfg.env.renderer.resolution, self.device)
        self.env = ReconEnv(cfg.env, self.scenes, depth_source)
        self.eval_env = None
        if eval_scenes is not None:
            ev_cfg = eval_env_config(cfg.env)
            if cfg.runner.eval_camera:
                if cfg.env.renderer.mode in EXTERNAL_DEPTH_MODES:
                    raise ValueError(
                        "runner.eval_camera is incompatible with renderer "
                        f"mode {cfg.env.renderer.mode!r}: the external depth "
                        "feed is recorded at the training camera resolution")
                ev_cfg = with_camera(ev_cfg, cfg.runner.eval_camera)
            self.eval_env = ReconEnv(ev_cfg, eval_scenes, eval_depth_source)

        self.policy = ActorCriticPolicy(cfg.model, self.generator, self.device)
        self.opt = ppo.make_optimizer(cfg.ppo, cfg.env.num_envs)
        self.opt_state = self.opt.init(self.policy)

        self.log_dir = log_dir or os.path.join(
            cfg.runner.log_dir,
            f"{cfg.runner.experiment_name}_{time.strftime('%Y%m%d_%H%M%S')}",
        )
        self.logger: Optional[Logger] = None
        self.ckpt: Optional[CheckpointManager] = None
        self.obs_dtype = (torch.bfloat16 if cfg.runner.obs_dtype == "bfloat16"
                          else torch.float32)
        self.timer = profiling.PhaseTimer()

        # rolling 100-episode stats (env_train_base.py:629-639)
        self._rew_buffer: deque = deque(maxlen=100)
        self._len_buffer: deque = deque(maxlen=100)
        self.global_step = 0
        self.iteration = 0
        self._best_metric = -float("inf")
        self._best_eval = -float("inf")

    # ------------------------------------------------------------------
    def train_iteration(self, env_state, obs):
        """Collect -> GAE -> flatten -> update.  Returns (env_state', obs',
        the nine rollout metrics as one device tensor, the update's eight
        metrics as floats), in ``_METRIC_KEYS`` order; the timer holds the
        seconds of each phase, each fenced on the device."""
        cfg = self.cfg.ppo
        timer, dev = self.timer, self.device
        timer.reset()
        with timer.phase("rollout", dev):
            env_state, obs, batch, stats = rollout.collect(
                self.env, self.policy, env_state, obs, self.generator,
                cfg.n_steps, cfg.gamma, self.obs_dtype)
        with timer.phase("gae", dev):
            adv, ret = gae.compute_gae(
                batch.rewards, batch.values, batch.dones.float(),
                batch.last_values, cfg.gamma, cfg.gae_lambda)
        t, n = batch.rewards.shape

        def flat(x):
            return x.reshape((t * n,) + x.shape[2:])

        with timer.phase("update", dev):
            self.opt_state, upd = ppo.update(
                self.policy, self.opt, cfg, self.opt_state,
                flat(batch.obs), flat(batch.actions), flat(batch.log_probs),
                flat(batch.values), flat(adv), flat(ret), self.generator,
                num_envs=n)

        # rollout metrics (reference extras["episode"] keys)
        n_done = torch.clamp(stats.num_dones.sum(), min=1.0)
        els = spec.EPISODE_LENGTH_S
        packed = torch.stack([
            stats.ep_rew_coverage.sum() / n_done / els,
            stats.ep_rew_short_path.sum() / n_done / els,
            stats.ep_rew_termination.sum() / n_done / els,
            stats.ep_reward.sum() / n_done,
            stats.ep_length.sum() / n_done,
            (stats.coverage * stats.num_dones).sum() / n_done,
            stats.collision.sum() / n_done,
            stats.num_dones.sum(),
            batch.rewards.mean(),
        ]).float()
        # SB3 logs train/learning_rate each update: the schedule at the
        # count of applied updates
        train = [*upd, self.opt.lr(self.opt_state.count)]
        return env_state, obs, packed, train

    # ------------------------------------------------------------------
    def setup(self):
        """Reset env; stagger initial episode lengths like the reference
        (base_class_grid_obs.py:471-475)."""
        n = self.cfg.env.num_envs
        env_state, out = self.env.reset(n)
        staggered = torch.randint(
            1, self.cfg.env.max_episode_length, (n,), generator=self.generator,
            device=self.device, dtype=torch.int32)
        return env_state._replace(episode_len=staggered), out.obs

    def train(self, num_iterations: Optional[int] = None, log: bool = True):
        """Trains until `num_iterations` iterations in all (a TOTAL: a run
        restored at iteration k does the remainder, keeping the lr
        schedule and the iteration-indexed logs aligned); returns the last
        iteration's metrics."""
        cfg = self.cfg
        num_iterations = num_iterations or cfg.ppo.total_iters
        if log and self.logger is None:
            self.logger = Logger(
                self.log_dir, config={
                    **config_to_dict(cfg),
                    **({"eval_dataset": self.eval_dataset}
                       if self.eval_dataset else {})},
                use_wandb=cfg.runner.wandb,
                run_name=cfg.runner.experiment_name,
            )
            self.ckpt = CheckpointManager(os.path.join(self.log_dir, "models"))

        env_state, obs = self.setup()
        steps_per_iter = cfg.ppo.n_steps * cfg.env.num_envs
        last_metrics = {}
        for it in range(max(num_iterations - self.iteration, 0)):
            t0 = time.perf_counter()
            # the 2nd iteration (past the first-call costs) when requested
            with profiling.trace(cfg.runner.profile_dir if it == 1 else None):
                env_state, obs, packed, train = self.train_iteration(
                    env_state, obs)
            self.global_step += steps_per_iter
            self.iteration += 1
            last_metrics = self._process_iter(packed, train, t0)

        self._final_env_state = env_state
        self._final_obs = obs
        return last_metrics

    def _process_iter(self, packed, train, t0):
        """Host-side post-processing of one finished iteration: the single
        packed metric fetch, rolling stats, periodic eval, logging and
        checkpointing."""
        cfg = self.cfg
        iteration, global_step = self.iteration, self.global_step
        metrics = dict(zip(_METRIC_KEYS, packed.tolist() + train))
        dt_iter = time.perf_counter() - t0
        metrics["time/fps"] = cfg.ppo.n_steps * cfg.env.num_envs / dt_iter
        metrics["time/iter_seconds"] = dt_iter
        metrics.update(self.timer.metrics())
        metrics["global_step"] = global_step

        # rolling episode stats for best-ckpt selection
        if metrics["rollout/num_episodes"] > 0:
            self._rew_buffer.append(metrics["rollout/episode_reward"])
            self._len_buffer.append(metrics["rollout/episode_length"])
        if self._rew_buffer:
            metrics["rollout/episode_reward_rolling"] = float(
                np.mean(self._rew_buffer))

        if self.eval_env is not None and cfg.runner.eval_freq > 0 and (
            iteration % cfg.runner.eval_freq == 0
        ):
            t_eval = time.perf_counter()
            res = evaluation.evaluate(self.eval_env, self.policy,
                                      compute_accuracy=cfg.runner.eval_accuracy)
            metrics["time/eval_seconds"] = time.perf_counter() - t_eval
            metrics.update({
                "eval/mean_reward": res.mean_reward,
                "eval/mean_AUC": res.mean_auc,
                "eval/mean_ep_length": res.mean_ep_length,
                "eval/final_coverage": res.mean_final_coverage,
                "eval/init_coverage": res.mean_init_coverage,
                "eval/coverage_curve_AUC": res.mean_curve_auc,
            })
            if np.isfinite(res.mean_accuracy_cm):
                metrics["eval/mean_accuracy"] = res.mean_accuracy_cm
                # the accuracy decomposition (EvalResult)
                metrics["eval/accuracy_scan2gt"] = res.accuracy_scan2gt
                metrics["eval/accuracy_gt2scan"] = res.accuracy_gt2scan
                metrics["eval/accuracy_gt2scan_seen"] = (
                    res.accuracy_gt2scan_seen)
                metrics["eval/gt_unseen_frac"] = res.gt_unseen_frac
                metrics["eval/accuracy_floor_gt_sampling"] = (
                    res.accuracy_floor_gt_sampling)
            # best-by-held-out-eval checkpoint (the reference's
            # EvalCallback best_model, callbacks.py:685-693)
            if self.ckpt is not None and (
                res.mean_final_coverage > self._best_eval
            ):
                self._best_eval = res.mean_final_coverage
                self.ckpt.save_best("eval_coverage", self.policy,
                                    self.opt_state, global_step)
                self._save_runner_state()

        if self.logger is not None:
            self.logger.log(metrics, iteration)
            if iteration % cfg.runner.log_interval == 0:
                self.logger.print_table(metrics, iteration)
        if self.ckpt is not None and cfg.runner.save_freq > 0 and (
            iteration % cfg.runner.save_freq == 0
        ):
            self.ckpt.save_step(global_step, self.policy, self.opt_state)
            self._save_runner_state()
        roll = metrics.get("rollout/episode_reward_rolling", -float("inf"))
        if self.ckpt is not None and roll > self._best_metric:
            self._best_metric = roll
            self.ckpt.save_best(cfg.runner.best_metric, self.policy,
                                self.opt_state, global_step)
            self._save_runner_state()

        return metrics

    # ------------------------------------------------------------------
    def _save_runner_state(self):
        """Persist the best-checkpoint trackers + rolling episode stats next
        to the checkpoints, so a resumed run cannot clobber a better
        rl_model_best_* with its first (worse) post-resume candidate."""
        if self.ckpt is None:
            return
        state = {
            "best_metric": self._best_metric,
            "best_eval": self._best_eval,
            "rew_buffer": list(self._rew_buffer),
            "len_buffer": list(self._len_buffer),
            "global_step": self.global_step,
        }
        os.makedirs(self.ckpt.ckpt_dir, exist_ok=True)
        path = os.path.join(self.ckpt.ckpt_dir, "runner_state.json")
        with open(path + ".tmp", "w") as f:
            json.dump(state, f)
        os.replace(path + ".tmp", path)

    def restore(self, models_dir: str, params_only: bool = False) -> int:
        """Resume the policy (parameters and BatchNorm stats), the optimizer
        state and the step from the latest rl_model_<steps>_steps
        checkpoint in `models_dir` (the reference's --resume +
        get_load_path, helpers.py:108-131).  Returns the restored global
        step.  Env state is not checkpointed: episodes restart, as in the
        reference.

        `params_only=True` warm-starts just the policy and keeps the fresh
        optimizer state and step counter, for fine-tuning under another
        objective or lr schedule (the reference's model.set_parameters,
        train_gennbv.py:218-220)."""
        mgr = CheckpointManager(models_dir)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no rl_model_*_steps checkpoints in {models_dir}")
        name = f"rl_model_{step}_steps"
        if params_only:
            self.policy.load_state_dict(mgr.restore_policy(name, self.device))
            return 0
        state_dict, self.opt_state, _ = mgr.restore(name, self.device)
        self.policy.load_state_dict(state_dict)
        self.global_step = step
        self.iteration = step // (self.cfg.ppo.n_steps * self.cfg.env.num_envs)
        # best trackers and rolling stats (absent: restart them at -inf)
        rs_path = os.path.join(models_dir, "runner_state.json")
        if os.path.exists(rs_path):
            with open(rs_path) as f:
                rs = json.load(f)
            self._best_metric = rs.get("best_metric", -float("inf"))
            self._best_eval = rs.get("best_eval", -float("inf"))
            self._rew_buffer.extend(rs.get("rew_buffer", []))
            self._len_buffer.extend(rs.get("len_buffer", []))
        return step

    def variables(self) -> dict:
        """The policy's state_dict (parameters and BatchNorm stats)."""
        return self.policy.state_dict()

    def close(self):
        if self.logger is not None:
            self.logger.close()
