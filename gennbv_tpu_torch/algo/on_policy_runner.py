"""rsl_rl-style on-policy runner for the continuous/Gaussian family (port of
``gennbv_tpu/algo/on_policy_runner.py``; rsl_rl/runners/on_policy_runner.py).

Each iteration: a rollout of num_steps_per_env steps, the timeout
bootstrap, GAE, whole-batch advantage normalization and the adaptive-KL
PPO update (``algo/ppo_continuous.py``), all on the env's device; the
iteration's metrics come to the host in one fetch.  Save/load of {params,
opt_state, iter}; ``get_inference_policy`` returns the deterministic
actor.  Every random draw (initial weights, env resets, actions, the
minibatch permutation) comes from one ``torch.Generator`` on the device,
seeded once with `seed`.

Works over any env with the contract of env/synthetic.py or a robot env:
``reset(num_envs, rng)``, ``step(state, actions)``, outputs with
``.obs/.reward/.done/.time_out``, and a ``device``.
"""
from __future__ import annotations

import copy
import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from gennbv_tpu_torch.algo import gae as gae_lib
from gennbv_tpu_torch.algo import ppo_continuous as ppoc
from gennbv_tpu_torch.models import gaussian
from gennbv_tpu_torch.models.actor_critic import GaussianActorCritic
from gennbv_tpu_torch.utils import profiling

# the metrics of an iteration, in the JAX runner's names and order
METRIC_KEYS = ("mean_reward", "surrogate_loss", "value_loss", "entropy",
               "mean_kl", "learning_rate", "mean_episode_length")


@dataclass(frozen=True)
class OnPolicyRunnerConfig:
    num_steps_per_env: int = 24     # legged_robot_config.py runner section
    save_interval: int = 50
    log_interval: int = 1


class OnPolicyRunner:
    def __init__(self, env, alg_cfg: ppoc.ContinuousPPOConfig,
                 runner_cfg: OnPolicyRunnerConfig, num_envs: int,
                 log_dir: Optional[str] = None, seed: int = 1,
                 actor_hidden=(256, 256, 256), critic_hidden=(256, 256, 256)):
        self.env = env
        self.alg_cfg = alg_cfg
        self.cfg = runner_cfg
        self.num_envs = num_envs
        self.log_dir = log_dir
        self.device = torch.device(env.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.model = GaussianActorCritic(
            env.obs_dim, env.num_actions, actor_hidden=tuple(actor_hidden),
            critic_hidden=tuple(critic_hidden), generator=self.generator,
            device=self.device)
        self.opt = ppoc.make_optimizer(alg_cfg)
        self.opt_state = self.opt.init(self.model)
        self.iteration = 0
        # the last iteration's device-timed phases
        self.phases = profiling.Phases({})

    def variables(self) -> dict:
        """The model's parameters by name (what a checkpoint holds)."""
        return self.model.state_dict()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _rollout(self, env_state, obs):
        cfg = self.alg_cfg
        rec = {k: [] for k in ("obs", "actions", "rewards", "dones", "values",
                               "log_probs", "means", "time_outs")}
        for _ in range(self.cfg.num_steps_per_env):
            out = self.model(obs)
            actions = gaussian.sample(out.mean, out.log_std, self.generator)
            logp = gaussian.log_prob(out.mean, out.log_std, actions)
            env_state, step_out = self.env.step(env_state, actions)
            for k, v in (("obs", obs), ("actions", actions),
                         ("rewards", step_out.reward), ("dones", step_out.done),
                         ("values", out.value), ("log_probs", logp),
                         ("means", out.mean), ("time_outs", step_out.time_out)):
                rec[k].append(v)
            obs = step_out.obs
        batch = {k: torch.stack(v) for k, v in rec.items()}
        last = self.model(obs)
        # timeout bootstrap with V(s_t) -- rsl_rl semantics (ppo.py:109-121).
        # (The discrete path bootstraps with V(obs_{t+1}) instead, valid
        # there because ReconEnv returns the PRE-reset obs at terminal
        # steps; generic envs auto-reset their obs, so V(s_t) stands in
        # for the unavailable terminal-state value.)
        batch["rewards"] = batch["rewards"] + cfg.gamma * batch["values"] * \
            batch["time_outs"].float()
        return env_state, obs, batch, last

    def _train_iteration(self, env_state, obs):
        """One iteration; returns (env_state, obs, metrics [7] on the
        device, in METRIC_KEYS order)."""
        cfg = self.alg_cfg
        dev, unit = self.device, self.iteration + 1
        profiling.phases(unit)      # what an earlier call left untaken
        with profiling.span("rollout", unit, dev):
            env_state, obs, b, last = self._rollout(env_state, obs)
            adv, ret = gae_lib.compute_gae(b["rewards"], b["values"],
                                           b["dones"], last.value, cfg.gamma,
                                           cfg.lam)
            # whole-batch advantage normalization (rollout_storage.py:141-143),
            # with the population std as jnp.std's
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        t, n = b["rewards"].shape
        m = t * n

        def flat(x):
            return x.reshape((m,) + x.shape[2:])

        with profiling.span("update", unit, dev):
            self.opt_state, um = ppoc.update(
                self.model, self.opt, cfg, self.opt_state,
                flat(b["obs"]), None, flat(b["actions"]), flat(b["log_probs"]),
                flat(b["values"]), flat(b["means"]), last.log_std.detach().clone(),
                flat(adv), flat(ret), self.generator)
        metrics = torch.stack([
            b["rewards"].mean(), um.surrogate_loss, um.value_loss, um.entropy,
            um.mean_kl, um.learning_rate,
            1.0 / torch.clamp(b["dones"].float().mean(), min=1e-6)])
        return env_state, obs, metrics

    # ------------------------------------------------------------------
    def learn(self, num_iterations: int, log: bool = False) -> dict:
        """num_iterations iterations from a fresh reset of the envs (as the
        JAX runner does at every call).  With `log`, prints every
        log_interval-th iteration and, with a log_dir, appends each
        iteration's metrics and phase seconds to log_dir/metrics.jsonl.
        Returns the last iteration's metrics."""
        env_state, out = self.env.reset(self.num_envs, self.generator)
        obs = out.obs
        metrics = {}
        for _ in range(num_iterations):
            t0 = time.perf_counter()
            env_state, obs, dev_metrics = self._train_iteration(env_state, obs)
            metrics = dict(zip(METRIC_KEYS, dev_metrics.tolist()))
            secs = time.perf_counter() - t0
            self.iteration += 1
            self.phases = profiling.phases(self.iteration)
            if log:
                self._log(metrics, secs)
            if self.log_dir and self.cfg.save_interval > 0 and (
                    self.iteration % self.cfg.save_interval == 0):
                self.save(os.path.join(self.log_dir,
                                       f"model_{self.iteration}.pt"))
        return metrics

    def _log(self, metrics: dict, secs: float) -> None:
        steps = self.cfg.num_steps_per_env * self.num_envs
        rec = {"step": self.iteration, **metrics, **self.phases.metrics(),
               "time/iter_seconds": secs, "time/fps": steps / secs}
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            with open(os.path.join(self.log_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.iteration % self.cfg.log_interval == 0:
            print(f"it {self.iteration:5d} | rew {metrics['mean_reward']:+.4f} | "
                  f"kl {metrics['mean_kl']:.4f} | "
                  f"lr {metrics['learning_rate']:.2e} | "
                  f"{rec['time/fps']:,.0f} steps/s", flush=True)

    # ------------------------------------------------------------------
    def save(self, path: str):
        """{params, opt_state, iter} like rsl_rl (on_policy_runner.py:
        228-236), one ``torch.save`` file of host tensors, written beside
        its name and then renamed."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        st = self.opt_state

        def host(d):
            return {k: v.detach().cpu() for k, v in d.items()}

        payload = {
            "params": host(self.model.state_dict()),
            "opt_state": {"mu": host(st.mu), "nu": host(st.nu),
                          "count": st.count,
                          "learning_rate": st.learning_rate.cpu()},
            "iter": self.iteration,
        }
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)

    def load(self, path: str, load_optimizer: bool = True):
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(payload["params"])
        if load_optimizer:
            o = payload["opt_state"]
            self.opt_state = ppoc.ContinuousOptState(
                o["mu"], o["nu"], o["count"], o["learning_rate"])
        self.iteration = payload["iter"]

    def get_inference_policy(self):
        """The deterministic actor (the mean action) of the parameters as
        they are now."""
        model = copy.deepcopy(self.model)

        @torch.no_grad()
        def policy(obs):
            return model(obs).mean

        return policy
