"""The "eval" traffic: held-out eval episodes back to back, each one
``algo.evaluation.evaluate(env, policy, compute_accuracy=False)`` as the
in-training eval, ``train/play.py`` and ``tools/post_run.py`` run it.

Set-up builds the eval env (``config.eval_env_config`` of the
configuration with the mix's ``eval_env`` set on it, which has to leave
it as the reference runs it, on the benchmark's eval scenes) and the
policy with the
benchmark's weights, and runs two episodes, the second timed; the window
runs episodes back to back for ``--seconds``.  In two of them, drawn
from the seed among those the warm pace says will run, a forward
hook copies each policy call's observation and logits to pinned host
memory; the reference replays those episodes after the window.
"""
from __future__ import annotations

import dataclasses
import json
import random
import sys
import time

import numpy as np
import torch

from benchmark import compare, harness, trace
from benchmark.compare import NO_READING
from benchmark.reference import env as ref_env
from benchmark.reference import policy as ref_policy
from benchmark.work import flops as work_flops


WARMUP_EPISODES = 2      # the first builds and warms up, the second is timed
CHECKED_EPISODES = 2     # drawn from the seed, replayed by the reference
PROFILED_EPISODES = 2
PERCENTILE = 90          # eval_episode_p90_s: ten or more episodes beyond it


class Loop:
    def __init__(self, cell: harness.Cell, seed: int, device: str = "cuda",
                 precision: str = "float32"):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.precision = precision
        self.cfg = cell.config["config"]
        self.traffic = cell.traffic
        self.records: dict = {}

    def eval_env_cfg(self) -> dict:
        """The configuration's env section under the mix's eval protocol."""
        env = dict(self.cfg["env"])
        ev = self.traffic["eval_env"]
        env.update({k: v for k, v in ev.items() if k != "reward"})
        env["reward"] = dict(env["reward"], **ev["reward"])
        return env

    def program_env_cfg(self, cfg):
        """The program's eval EnvConfig: ``eval_env_config`` of `cfg`'s
        env with the mix's ``eval_env`` set on it.  Raises where it is not
        the env the reference runs (``eval_env_cfg``)."""
        from gennbv_tpu_torch.config import (apply_overrides, config_to_dict,
                                             eval_env_config)
        cfg = apply_overrides(
            dataclasses.replace(cfg, env=eval_env_config(cfg.env)),
            tuple(harness.flat_overrides({"env": self.traffic["eval_env"]})))
        program = json.loads(json.dumps(config_to_dict(cfg.env)))
        stated = self.eval_env_cfg()
        if program != stated:
            differ = sorted(k for k in program.keys() | stated.keys()
                            if program.get(k) != stated.get(k))
            raise ValueError(f"the program's eval env differs from the "
                             f"mix's in {differ}: state them in its eval_env")
        return cfg.env

    def setup(self, seconds: float) -> None:
        from gennbv_tpu_torch.algo import evaluation
        from gennbv_tpu_torch.env import ReconEnv
        from gennbv_tpu_torch.models.policy import ActorCriticPolicy
        env = self.cfg["env"]
        scenes = self.traffic["eval_scenes"]
        self.arrays = harness.scene_arrays(
            env, scenes["count"], env["scene"]["seed"] + scenes["seed_offset"])
        self.weights = harness.weights(self.cfg["model"], self.seed,
                                       self.device)
        cfg = harness.port_config(self.cfg, self.seed)
        self.env = ReconEnv(self.program_env_cfg(cfg), harness.program_scenes(
            harness.to_device(self.arrays, self.device), env))
        self.policy = ActorCriticPolicy(cfg.model, None, self.device)
        self.policy.load_state_dict(self.weights)
        if self.precision == "tf32":
            # after the constructors' float32 setter, before any work
            harness.set_tf32(True)
        self.evaluate = evaluation.evaluate
        for _ in range(WARMUP_EPISODES):
            t0 = time.perf_counter()
            self._episode()
            self.episode_s = time.perf_counter() - t0
        self.env_steps = (self.env.cfg.num_envs
                          * self.env.cfg.max_episode_length)

    def _episode(self):
        return self.evaluate(self.env, self.policy, compute_accuracy=False)

    def window(self, seconds: float) -> tuple[dict, int]:
        """Episodes back to back until `seconds` have passed and the
        checked ones (drawn from the episodes the warm pace says will run)
        have run."""
        expected = max(1, round(seconds / self.episode_s))
        picks = set(random.Random(self.seed).sample(
            range(expected), min(CHECKED_EPISODES, expected)))
        # each checked episode's observations and logits go to pinned host
        # memory by copies on the stream, which neither wait for the
        # device nor add to its memory
        cfg = self.env.cfg
        pinned = self.device.type == "cuda"
        self.checked = [(torch.empty(cfg.max_episode_length, cfg.num_envs,
                                     self.env.obs_dim, pin_memory=pinned),
                         torch.empty(cfg.max_episode_length, cfg.num_envs,
                                     sum(ref_policy.NVEC), pin_memory=pinned),
                         [0], None) for _ in picks]
        slots = dict(zip(sorted(picks), range(len(picks))))
        times = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or len(times) <= max(picks):
            i = len(times)
            hook = None
            if i in slots:
                hook = self.policy.register_forward_hook(
                    _keeper(*self.checked[slots[i]][:3]))
            ts = time.perf_counter()
            result = self._episode()
            times.append(time.perf_counter() - ts)
            if hook is not None:
                hook.remove()
                obs, logits, count, _ = self.checked[slots[i]]
                self.checked[slots[i]] = (obs, logits, count, result)
        wall = time.perf_counter() - t0
        self.records["unit_seconds"] = times
        n = len(times)
        half = n // 2
        print(f"eval window: {n} episodes in {wall:.3f} s; episode seconds "
              f"min {min(times):.4f}, deciles "
              f"{np.percentile(times, range(10, 100, 10)).round(4).tolist()}, "
              f"max {max(times):.4f}; mean of the first and second half "
              f"{np.mean(times[:max(half, 1)]):.4f}, "
              f"{np.mean(times[half:]):.4f}; warm {self.episode_s:.4f}",
              file=sys.stderr)
        return {"eval_env_steps_per_s": n * self.env_steps / wall,
                f"eval_episode_p{PERCENTILE}_s":
                    float(np.percentile(times, PERCENTILE))}, n

    def trace(self) -> None:
        self.records["profile"] = trace.profiled(
            lambda: [self._episode() for _ in range(PROFILED_EPISODES)])
        self.records["host_profile"] = trace.profiled(self._episode, host=True)

    def release(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        del self.env, self.policy
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The numbers compared: the reference's episode over the actions
        the program's logits chose (their mode), held to each checked
        episode's observations, logits and per-env results."""
        harness.set_tf32(False)
        dev = self.device
        env_cfg = self.eval_env_cfg()
        scenes = harness.to_device(self.arrays, dev)
        env = ref_env.Env(env_cfg, scenes, env_cfg["renderer"]["resolution"])
        pol = ref_policy.Policy(self.cfg["model"], dev)
        pol.load_state_dict(self.weights)
        pol.eval()
        n, t_max = env_cfg["num_envs"], env_cfg["max_episode_length"]
        mismatched, logit_gap = 0, 0.0
        self.n_valid = None
        for obs_got, logits_got, count, result in self.checked:
            if count[0] != t_max:
                return {"env_mismatches": NO_READING,
                        "logit_gap": NO_READING}
            state, out = env.reset(torch.arange(n, device=dev)
                                   % scenes["surf_pts"].shape[0])
            n_valid = [int(out.n_valid.sum())]
            rewards, dones, coverage = [], [], []
            init_cov = out.coverage
            with torch.no_grad():
                for t in range(t_max):
                    mismatched += compare.mismatches(obs_got[t], out.obs)
                    logits = pol(out.obs)[0]
                    logit_gap = max(logit_gap, compare.max_gap(
                        logits_got[t], logits, float(logits.abs().max())))
                    state, out = env.step(
                        state, ref_policy.mode(logits_got[t].to(dev)))
                    n_valid.append(int(out.n_valid.sum()))
                    rewards.append(out.reward)
                    dones.append(out.done)
                    coverage.append(out.coverage)
            want = _episode_results(torch.stack(rewards).cpu().numpy(),
                                    torch.stack(dones).cpu().numpy(),
                                    torch.stack(coverage).cpu().numpy(),
                                    init_cov.cpu().numpy())
            got = np.concatenate([result.per_env_coverage, result.per_env_auc,
                                  [result.mean_reward, result.mean_ep_length,
                                   result.mean_init_coverage,
                                   result.mean_curve_auc]])
            mismatched += int((got != want).sum())
            self.n_valid = n_valid
        return {"env_mismatches": mismatched, "logit_gap": logit_gap}

    def layer_records(self, kind: str) -> dict:
        """What the metric readers read, with the benchmark's own counts:
        the reference policy's forward FLOPs an episode and the splat
        calls' valid points (the reference episode's poses)."""
        env_cfg, rec = self.eval_env_cfg(), self.records
        n, t_max = env_cfg["num_envs"], env_cfg["max_episode_length"]
        pol = ref_policy.Policy(self.cfg["model"], self.device).eval()
        pol.load_state_dict(self.weights)
        obs = torch.zeros(n, env_cfg["pose_buf_len"] * 6 + 8000
                          + env_cfg["rgb_k"] * env_cfg["rgb_h"]
                          * env_cfg["rgb_w"], device=self.device)
        with work_flops.FlopCounter() as c:
            pol(obs)
        out = {"unit_seconds": rec["unit_seconds"],
               "unit_flops": [t_max * c.flops] * len(rec["unit_seconds"]),
               "peaks": harness.peaks(kind)}
        prof = rec.get("profile")
        if prof is not None:
            episodes = PROFILED_EPISODES
            q = self.arrays["surf_pts"].shape[1]
            h, w = env_cfg["camera"]["height"], env_cfg["camera"]["width"]
            out.update(spans=prof.spans, window_ns=prof.window[1] - prof.window[0],
                       env_steps=episodes * (t_max + 1),
                       zbuf_calls=None if self.n_valid is None else
                       [(n, q, v, h, w) for v in self.n_valid] * episodes)
        return out


def _keeper(obs, logits, count):
    """A forward hook copying the policy's k-th call's observation and
    logits into row k of `obs` and `logits`; `count` [1] counts the
    calls."""
    def hook(module, inputs, out):
        k = count[0]
        if k < obs.shape[0]:
            obs[k].copy_(inputs[0], non_blocking=True)
            logits[k].copy_(out.logits, non_blocking=True)
        count[0] += 1
    return hook


def _episode_results(rewards, dones, coverage, init_cov) -> np.ndarray:
    """Per-env final coverage and reward AUC, then the mean reward, mean
    episode length, mean init coverage and mean coverage-curve AUC, as the
    reference's eval protocol defines them (stable_baselines3
    evaluation.py:136-378): each env's one episode ends at its first done;
    the AUC weights a step's gain by the steps that remain and counts the
    done step's as zero; the curve starts at the init view and holds the
    final coverage after the done step."""
    t_max, n = rewards.shape
    first_done = np.where(dones.any(0), dones.argmax(0), t_max - 1)
    before = np.arange(t_max)[:, None] <= first_done[None, :]
    strictly = np.arange(t_max)[:, None] < first_done[None, :]
    final = coverage[first_done, np.arange(n)]
    weights = (t_max - np.arange(t_max)) / t_max
    auc = (rewards * strictly * weights[:, None]).sum(0)
    curve = np.concatenate([init_cov[None], np.where(before, coverage,
                                                     final[None])])
    return np.concatenate([final, auc, [
        float((rewards * before).sum(0).mean()), float((first_done + 1).mean()),
        float(init_cov.mean()), float(curve.mean(0).mean())]])
