"""Training runner (port of ``gennbv_tpu/algo/runner.py``): the single loop
replacing the reference's SB3 learn() / rsl_rl OnPolicyRunner pair.

Each iteration collects a rollout (128 env steps), computes GAE and runs
the 5-epoch minibatched PPO update, all on the runner's device, and is
enqueued without a host wait: the update gates its minibatches on the
device (``ppo.Learner``), the rollout lands in buffers the Runner keeps,
the phases are timed by CUDA events (device-timed spans,
``utils/profiling``).  Its 17 metrics (``_METRIC_KEYS``)
leave in one tensor, copied to pinned host memory behind an event.  The
loop is pipelined as the JAX runner's (``gennbv_tpu/algo/runner.py``,
``runner.pipeline_depth``): up to `depth` dispatched iterations wait in
``pending``, and iteration k's metrics are fetched, and its host work
done (logging, eval, checkpoints), only once iteration k + depth has been
dispatched.  The policy is updated in place, so each iteration's
parameters, BatchNorm stats, Adam moments and count are copied at its end
into a ring of depth + 1 device snapshots: iteration k's eval (on an eval
copy of the policy) and checkpoints read its own snapshot.
``time/iter_seconds`` is the spacing of fetch completions (the first
processed iteration: its own span).  Every random draw (initial weights,
staggered episode lengths, actions, minibatch permutations) comes from
one ``torch.Generator`` on the device, seeded with ``runner.seed``, and
only the dispatch draws from it, so every depth gives the same bits.

Inside a ``torch.distributed`` process group the Runner is one rank of
the JAX runner's mesh (``parallel/mesh.py``; ``runner.num_devices``,
``num_slices``, ``model_axis``): it holds its slice of the envs, a replica
of the policy (its Linears sharded over a model axis), and the learning
rate schedule of the global ``num_envs``.  Every draw is made at the full
env width and each rank keeps its rows, so W ranks compute the
one-process run split by rows.  The rollout metrics are summed over the
env axis before they are divided.  Rank 0 logs, evaluates (the eval env
is unsharded, as in the JAX runner) and writes the checkpoints, which
hold whole tensors: a checkpoint restores into any mesh or none.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.algo import evaluation, gae, ppo, rollout
from gennbv_tpu_torch.config import (EXTERNAL_DEPTH_MODES, Config,
                                     config_to_dict, eval_env_config,
                                     with_camera)
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.parallel import mesh as mesh_lib
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.checkpoint import CheckpointManager
from gennbv_tpu_torch.utils.logger import Logger

# fixed order of the per-iteration scalar metrics (the JAX runner's),
# packed into one device tensor by train_iteration and fetched once
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
        # the mesh first, as the JAX runner builds it; None for one process
        self.mesh = mesh_lib.mesh_for(cfg.runner, self.device)
        self.rank = 0 if self.mesh is None else self.mesh.rank
        self.rows = mesh_lib.env_rows(cfg.env.num_envs, self.mesh)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.runner.seed)

        self.scenes = scenes if scenes is not None else make_scenes(
            cfg.env.scene, cfg.env.renderer.resolution, self.device)
        self.env = ReconEnv(cfg.env, self.scenes, depth_source)
        self.eval_env = None
        self.evaluates = eval_scenes is not None
        if eval_scenes is not None and self.rank == 0:
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
        mesh_lib.check_replicas(self.policy, self.mesh)
        mesh_lib.shard_policy(self.policy, self.mesh)
        self.opt = ppo.make_optimizer(cfg.ppo, cfg.env.num_envs)
        self.opt_state = self.opt.init(self.policy)
        self.learner = ppo.Learner(self.policy, self.opt, cfg.ppo, self.mesh)
        # the rollout and its advantages and returns, kept in place for
        # the learner's captured step (made by the first iteration)
        self._rollout: Optional[rollout.RolloutBuffers] = None
        self._gae: Optional[tuple] = None
        # the pipelined loop's ring: per slot an iteration's state
        # snapshot, its pinned metrics and the event after their copy
        self._ring: list = []
        self._eval_copy: Optional[ActorCriticPolicy] = None
        self._last_fetch: Optional[float] = None

        self.log_dir = log_dir or os.path.join(
            cfg.runner.log_dir,
            f"{cfg.runner.experiment_name}_{time.strftime('%Y%m%d_%H%M%S')}",
        )
        self.logger: Optional[Logger] = None
        self.ckpt: Optional[CheckpointManager] = None
        self.obs_dtype = (torch.bfloat16 if cfg.runner.obs_dtype == "bfloat16"
                          else torch.float32)

        # rolling 100-episode stats (env_train_base.py:629-639)
        self._rew_buffer: deque = deque(maxlen=100)
        self._len_buffer: deque = deque(maxlen=100)
        self.global_step = 0
        self.iteration = 0
        self._best_metric = -float("inf")
        self._best_eval = -float("inf")

    # ------------------------------------------------------------------
    def train_iteration(self, env_state, obs):
        """Collect -> GAE -> flatten -> update, enqueued on the device
        without a host wait (the first call also captures the update's
        step).  Returns (env_state', obs', the metrics of ``_METRIC_KEYS``
        as one float32 device tensor).  Its phases are device-timed spans
        of unit ``iteration + 1``, which ``profiling.phases`` hands over
        (CUDA events; on the CPU their seconds)."""
        cfg = self.cfg.ppo
        dev, unit = self.device, self.iteration + 1
        profiling.phases(unit)      # what an earlier call left untaken
        with profiling.span("rollout", unit, dev):
            env_state, obs, batch, stats = rollout.collect(
                self.env, self.policy, env_state, obs, self.generator,
                cfg.n_steps, cfg.gamma, self.obs_dtype, **self._place(),
                out=self._rollout)
        with profiling.span("gae", unit, dev):
            adv, ret = gae.compute_gae(
                batch.rewards, batch.values, batch.dones.float(),
                batch.last_values, cfg.gamma, cfg.gae_lambda, out=self._gae)
        self._rollout = rollout.RolloutBuffers.of(batch)
        self._gae = (adv, ret)
        t, n = batch.rewards.shape

        def flat(x):
            return x.reshape((t * n,) + x.shape[2:])

        with profiling.span("update", unit, dev):
            self.opt_state, upd = ppo.update(
                self.policy, self.opt, cfg, self.opt_state,
                flat(batch.obs), flat(batch.actions), flat(batch.log_probs),
                flat(batch.values), flat(adv), flat(ret), self.generator,
                num_envs=self.cfg.env.num_envs, mesh=self.mesh,
                learner=self.learner)

        # rollout metrics (reference extras["episode"] keys): sums over the
        # env axis, then divided
        sums = torch.stack([
            stats.ep_rew_coverage.sum(), stats.ep_rew_short_path.sum(),
            stats.ep_rew_termination.sum(), stats.ep_reward.sum(),
            stats.ep_length.sum(), (stats.coverage * stats.num_dones).sum(),
            stats.collision.sum(), stats.num_dones.sum(), batch.rewards.sum(),
        ]).float()
        if self.mesh is not None:
            self.mesh.all_reduce_(sums)
        n_done = torch.clamp(sums[7], min=1.0)
        # SB3 logs train/learning_rate each update: the schedule at the
        # count of applied updates
        lr = self.learner.tables.at(self.opt_state.count)[0]
        packed = torch.cat([sums[:3] / n_done / spec.EPISODE_LENGTH_S,
                            sums[3:7] / n_done, sums[7:8],
                            sums[8:] / (t * self.cfg.env.num_envs),
                            torch.stack(list(upd)), lr.reshape(1)])
        return env_state, obs, packed

    # ------------------------------------------------------------------
    def _place(self) -> dict:
        """This rank's rows of the full env width, for draws made in full
        (empty for one process)."""
        if self.mesh is None:
            return {}
        return {"rows": self.rows, "width": self.cfg.env.num_envs}

    def setup(self):
        """Reset env; stagger initial episode lengths like the reference
        (base_class_grid_obs.py:471-475).  A rank resets its rows of the
        envs, each on the scene of its global index."""
        n = self.cfg.env.num_envs
        scene_id = torch.arange(n, device=self.device)[self.rows]
        env_state, out = self.env.reset(
            scene_id.numel(), scene_id % self.scenes.num_scenes)
        staggered = torch.randint(
            1, self.cfg.env.max_episode_length, (n,), generator=self.generator,
            device=self.device, dtype=torch.int32)[self.rows]
        return env_state._replace(episode_len=staggered), out.obs

    def train(self, num_iterations: Optional[int] = None, log: bool = True):
        """Trains until `num_iterations` iterations in all (a TOTAL: a run
        restored at iteration k does the remainder, keeping the lr
        schedule and the iteration-indexed logs aligned); returns the last
        iteration's metrics."""
        cfg = self.cfg
        num_iterations = num_iterations or cfg.ppo.total_iters
        if log and self.ckpt is None:
            # every rank saves (a gather under tensor parallelism); rank 0
            # writes the files
            self.ckpt = CheckpointManager(os.path.join(self.log_dir, "models"))
        if log and self.logger is None and self.rank == 0:
            self.logger = Logger(
                self.log_dir, config={
                    **config_to_dict(cfg),
                    **({"eval_dataset": self.eval_dataset}
                       if self.eval_dataset else {})},
                use_wandb=cfg.runner.wandb,
                run_name=cfg.runner.experiment_name,
            )

        env_state, obs = self.setup()
        steps_per_iter = cfg.ppo.n_steps * cfg.env.num_envs
        depth = max(1, cfg.runner.pipeline_depth)
        last_metrics = {}
        # dispatched iterations whose metrics are not fetched yet
        pending: deque = deque()
        self._last_fetch = None
        for it in range(max(num_iterations - self.iteration, 0)):
            t0 = time.perf_counter()
            # the 2nd iteration (past the first-call costs) when requested,
            # fetched inside the trace so its device work lands there
            profiling_this = (bool(cfg.runner.profile_dir) and it == 1
                              and self.rank == 0)
            with profiling.trace(cfg.runner.profile_dir
                                 if profiling_this else None):
                env_state, obs, slot = self._dispatch(
                    self.iteration % (depth + 1), env_state, obs)
                if profiling_this and slot.done is not None:
                    slot.done.synchronize()
            self.global_step += steps_per_iter
            self.iteration += 1
            profiling.count("runner/iterations")
            pending.append(_Pending(slot, profiling.phases(self.iteration),
                                    self.iteration, self.global_step, t0))
            if len(pending) > depth:
                last_metrics = self._process_iter(pending.popleft())
        while pending:
            last_metrics = self._process_iter(pending.popleft())

        self._final_env_state = env_state
        self._final_obs = obs
        return last_metrics

    def _dispatch(self, i: int, env_state, obs):
        """``train_iteration``, then ``_keep`` into ring slot `i`: all an
        iteration enqueues, the span ``runner/dispatch`` of unit
        ``iteration + 1``.  Returns (env_state', obs', the slot)."""
        with profiling.span("runner/dispatch", self.iteration + 1):
            env_state, obs, packed = self.train_iteration(env_state, obs)
            with profiling.span("runner/keep"):
                return env_state, obs, self._keep(i, packed)

    def _keep(self, i: int, packed: torch.Tensor) -> "_Slot":
        """Copies the iteration just dispatched into slot `i` of the ring
        of depth + 1 (made at the first call): its parameters and
        BatchNorm stats, Adam moments and count on the device, and its
        packed metrics to pinned host memory (on the CPU: a copy), with
        an event after the copy.  Slot i is free: the iteration that held
        it was processed before this one was dispatched."""
        state = self.opt_state
        tensors = [*self.policy.state_dict().values(), *state.mu.values(),
                   *state.nu.values(), state.count]
        on_card = packed.is_cuda
        while len(self._ring) <= i:
            self._ring.append(_Slot(
                [t.detach().clone() for t in tensors],
                torch.empty(packed.shape, dtype=packed.dtype,
                            pin_memory=on_card),
                torch.cuda.Event() if on_card else None))
        slot = self._ring[i]
        torch._foreach_copy_(mesh_lib.local(slot.tensors),
                             mesh_lib.local(tensors))
        slot.metrics.copy_(packed, non_blocking=on_card)
        if on_card:
            slot.done.record()
        return slot

    def _snapshot(self, slot: "_Slot") -> tuple[dict, ppo.AdamState]:
        """(state_dict, AdamState) of the iteration held in `slot`."""
        keys = list(self.policy.state_dict())
        names = list(self.opt_state.mu)
        t = iter(slot.tensors)
        variables = {k: next(t) for k in keys}
        mu = {k: next(t) for k in names}
        nu = {k: next(t) for k in names}
        return variables, ppo.AdamState(mu, nu, next(t))

    def _process_iter(self, entry: "_Pending"):
        """Host-side post-processing of one finished iteration: the single
        packed metric fetch (the one wait for the device), rolling stats,
        periodic eval, logging and checkpointing, on its snapshot.  Runs
        while the next dispatched iterations execute on the device: the
        spans ``runner/fetch`` (the wait) and ``runner/process``."""
        with profiling.span("runner/fetch", entry.iteration):
            if entry.slot.done is not None:
                entry.slot.done.synchronize()
        with profiling.span("runner/process", entry.iteration):
            return self._processed(entry)

    def _processed(self, entry: "_Pending") -> dict:
        cfg = self.cfg
        iteration, global_step = entry.iteration, entry.global_step
        slot = entry.slot
        metrics = dict(zip(_METRIC_KEYS, slot.metrics.tolist()))
        # the spacing of fetch completions (the t0 span would count the
        # whole queue); the first processed iteration takes its own span
        now = time.perf_counter()
        dt_iter = now - (self._last_fetch if self._last_fetch is not None
                         else entry.t0)
        self._last_fetch = now
        metrics["time/fps"] = cfg.ppo.n_steps * cfg.env.num_envs / dt_iter
        metrics["time/iter_seconds"] = dt_iter
        metrics.update(entry.phases.metrics())
        metrics["global_step"] = global_step
        variables, opt_state = self._snapshot(slot)

        # rolling episode stats for best-ckpt selection
        if metrics["rollout/num_episodes"] > 0:
            self._rew_buffer.append(metrics["rollout/episode_reward"])
            self._len_buffer.append(metrics["rollout/episode_length"])
        if self._rew_buffer:
            metrics["rollout/episode_reward_rolling"] = float(
                np.mean(self._rew_buffer))

        if self.evaluates and cfg.runner.eval_freq > 0 and (
            iteration % cfg.runner.eval_freq == 0
        ):
            policy = self._eval_policy(variables)
            better = False
            if self.eval_env is not None:
                t_eval = time.perf_counter()
                res = evaluation.evaluate(
                    self.eval_env, policy,
                    compute_accuracy=cfg.runner.eval_accuracy)
                metrics["time/eval_seconds"] = time.perf_counter() - t_eval
                metrics.update(_eval_metrics(res))
                better = res.mean_final_coverage > self._best_eval
                if better:
                    self._best_eval = res.mean_final_coverage
            # best-by-held-out-eval checkpoint (the reference's
            # EvalCallback best_model, callbacks.py:685-693): rank 0's call
            if self.ckpt is not None and self._from_rank0(better):
                self.ckpt.save_best("eval_coverage", variables, opt_state,
                                    global_step)
                self._save_runner_state(global_step)

        if self.logger is not None:
            self.logger.log(metrics, iteration)
            if iteration % cfg.runner.log_interval == 0:
                self.logger.print_table(metrics, iteration)
        if self.ckpt is not None and cfg.runner.save_freq > 0 and (
            iteration % cfg.runner.save_freq == 0
        ):
            self.ckpt.save_step(global_step, variables, opt_state)
            self._save_runner_state(global_step)
        roll = metrics.get("rollout/episode_reward_rolling", -float("inf"))
        if self.ckpt is not None and roll > self._best_metric:
            self._best_metric = roll
            self.ckpt.save_best(cfg.runner.best_metric, variables, opt_state,
                                global_step)
            self._save_runner_state(global_step)

        return metrics

    def _from_rank0(self, flag: bool) -> bool:
        """Rank 0's `flag`, on every rank."""
        if self.mesh is None:
            return flag
        return bool(self.mesh.broadcast_(
            torch.tensor([flag], device=self.device)).item())

    def _eval_policy(self, variables: dict) -> torch.nn.Module:
        """The policy the eval runs: an unsharded copy of the Runner's
        (made once) holding `variables`, a snapshot's state_dict (gathered
        under tensor parallelism, where every rank must call this)."""
        if self._eval_copy is None:
            self._eval_copy = ActorCriticPolicy(self.cfg.model, None,
                                                self.device)
        self._eval_copy.load_state_dict(
            {k: mesh_lib.full(v) for k, v in variables.items()})
        return self._eval_copy

    # ------------------------------------------------------------------
    def _save_runner_state(self, global_step: Optional[int] = None):
        """Persist the best-checkpoint trackers + rolling episode stats next
        to the checkpoints, so a resumed run cannot clobber a better
        rl_model_best_* with its first (worse) post-resume candidate;
        `global_step` is the processed iteration's (default: the last
        dispatched)."""
        if self.ckpt is None or self.rank != 0:
            return
        state = {
            "best_metric": self._best_metric,
            "best_eval": self._best_eval,
            "rew_buffer": list(self._rew_buffer),
            "len_buffer": list(self._len_buffer),
            "global_step": (self.global_step if global_step is None
                            else global_step),
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
            mesh_lib.load_state(self.policy,
                                mgr.restore_policy(name, self.device))
            return 0
        state_dict, opt_state, _ = mgr.restore(name, self.device)
        mesh_lib.load_state(self.policy, state_dict)
        # into the moments in place: the learner's captured step reads them
        params = dict(self.policy.named_parameters())
        for mine, saved in ((self.opt_state.mu, opt_state.mu),
                            (self.opt_state.nu, opt_state.nu)):
            for k, v in saved.items():
                mesh_lib.local([mine[k]])[0].copy_(
                    mesh_lib.local([mesh_lib.like(v, params[k])])[0])
        self.opt_state = ppo.AdamState(self.opt_state.mu, self.opt_state.nu,
                                       opt_state.count)
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
        """The policy's state_dict (parameters and BatchNorm stats), whole
        tensors: gathered under tensor parallelism, where every rank must
        call this."""
        return {k: mesh_lib.full(v) for k, v in self.policy.state_dict().items()}

    def close(self):
        if self.logger is not None:
            self.logger.close()


class _Slot(NamedTuple):
    """A ring slot of the pipelined loop: an iteration's state tensors
    (state_dict values, Adam mu, nu, count), its metrics on the host and
    the event after their copy (None on the CPU)."""
    tensors: list
    metrics: torch.Tensor
    done: Optional[torch.cuda.Event]


class _Pending(NamedTuple):
    """A dispatched iteration awaiting its fetch: its slot, its
    device-timed phases, and its iteration, global step and dispatch
    start."""
    slot: _Slot
    phases: profiling.Phases
    iteration: int
    global_step: int
    t0: float


def _eval_metrics(res: evaluation.EvalResult) -> dict:
    out = {
        "eval/mean_reward": res.mean_reward,
        "eval/mean_AUC": res.mean_auc,
        "eval/mean_ep_length": res.mean_ep_length,
        "eval/final_coverage": res.mean_final_coverage,
        "eval/init_coverage": res.mean_init_coverage,
        "eval/coverage_curve_AUC": res.mean_curve_auc,
    }
    if np.isfinite(res.mean_accuracy_cm):
        out["eval/mean_accuracy"] = res.mean_accuracy_cm
        # the accuracy decomposition (EvalResult)
        out["eval/accuracy_scan2gt"] = res.accuracy_scan2gt
        out["eval/accuracy_gt2scan"] = res.accuracy_gt2scan
        out["eval/accuracy_gt2scan_seen"] = res.accuracy_gt2scan_seen
        out["eval/gt_unseen_frac"] = res.gt_unseen_frac
        out["eval/accuracy_floor_gt_sampling"] = res.accuracy_floor_gt_sampling
    return out
