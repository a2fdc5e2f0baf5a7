"""The "train" traffic: ``Runner.train`` as users call it.

Set-up builds one Runner on the configuration (the benchmark's scenes
and weights, the runner seeded by the run's seed, logging into a
directory under TMPDIR), trains its first iteration, then one more,
timed: the window runs as many iterations as fill ``--seconds`` at that
pace, in one ``Runner.train`` call (its env reset and its pipeline drain
included).  The same Runner serves all three.

Two iterations are held to the reference: set-up's first, from the
env's reset, the benchmark's weights and a zero Adam state, and the
window's last, the pipelined loop's steady state, from the env state,
parameters and Adam state the program had at its start.  While each
runs, wrappers keep references to what the program produced (its env
state at the start, each env step's reward, done and timeout) and split
its update's call into the first three minibatches' graph replays, the
learner's state copied after each, and the rest; once its
``Runner.train`` call has returned, its rollout, advantages, returns and
its starting state (the Runner's ring slot of the iteration before) are
copied to the host.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import torch

from benchmark import compare, harness, trace
from benchmark.compare import NO_READING
from benchmark.reference import env as ref_env
from benchmark.reference import policy as ref_policy
from benchmark.reference import ppo as ref_ppo
from benchmark.work import flops as work_flops

POSE_LAST = slice(99 * 6, 100 * 6)   # the newest pose in an observation
CHECKED_MINIBATCHES = 3              # the steps the reference follows
# readings printed but not compared: a ReLU unit within rounding of its
# kink flips a gradient by as much as a TF32 update does (PERF.md)
UNCOMPARED = ("grad_gap", "step_gap")
TRACED_ITERATIONS = 3                # a profiled call; its second is read


class Loop:
    def __init__(self, cell: harness.Cell, seed: int, device: str = "cuda",
                 precision: str = "float32"):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.precision = precision
        self.cfg = cell.config["config"]
        self.records: dict = {}

    # -- set-up ---------------------------------------------------------------
    def setup(self, seconds: float) -> None:
        from gennbv_tpu_torch.algo.runner import Runner
        env = self.cfg["env"]
        self.arrays = harness.scene_arrays(env, env["scene"]["num_scenes"],
                                           env["scene"]["seed"])
        self.weights = harness.weights(self.cfg["model"], self.seed,
                                       self.device)
        self.log_dir = tempfile.mkdtemp(prefix="benchmark_train_")
        runner = Runner(harness.port_config(self.cfg, self.seed),
                        scenes=harness.program_scenes(
                            harness.to_device(self.arrays, self.device), env),
                        log_dir=self.log_dir, device=self.device)
        runner.policy.load_state_dict(self.weights)
        if self.precision == "tf32":
            # after the constructors' float32 setter, before any work
            harness.set_tf32(True)
        self.runner = runner
        self.first = self._kept(runner, 1, reset=True)
        t0 = time.perf_counter()
        runner.train(runner.iteration + 1)
        self.iteration_s = time.perf_counter() - t0
        self.steps_per_iteration = (self.cfg["ppo"]["n_steps"]
                                    * env["num_envs"])

    def _kept(self, runner, last: int, reset: bool = False) -> dict:
        """Trains the Runner to iteration `last` in one ``Runner.train``
        call and returns, on the host, what the program produced in that
        iteration: its env state at the start, each env step's reward,
        done and timeout (with `reset`, the call's reset's too), the
        rollout, its advantages and returns, the first minibatches' rows
        and the learner's state after each, and the parameters, BatchNorm
        stats and Adam state it started from."""
        k = CHECKED_MINIBATCHES
        got: dict = {"steps": [], "after": []}
        learner, env = runner.learner, runner.env
        train_iteration, setup = runner.train_iteration, runner.setup
        step, run = env.step, learner.run
        into: list = [None]   # where env steps' outputs go, or None

        def step_kept(state, actions):
            state, out = step(state, actions)
            if into[0] is not None:
                into[0].append((out.reward, out.done, out.time_out))
            return state, out

        def setup_kept():
            into[0] = got.setdefault("reset", [])
            try:
                return setup()
            finally:
                into[0] = None

        def iteration_kept(env_state, obs):
            if runner.iteration + 1 != last:
                return train_iteration(env_state, obs)
            got["env_state"] = env_state
            into[0] = got["steps"]
            learner.run = run_kept
            try:
                return train_iteration(env_state, obs)
            finally:
                into[0] = None
                del learner.run

        def run_kept(data, rows, mu, nu, gathered=False):
            got["rows"] = rows[:k].clone()
            for i in range(k):
                run(data, rows[i:i + 1], mu, nu, gathered)
                after = {"sums": learner.sums.clone()}
                if i == 0:
                    after["mu"] = {n: m.clone()
                                   for n, m in zip(learner.names, mu)}
                if i == k - 1:
                    after["params"] = {n: p.detach().clone() for n, p in
                                       zip(learner.names, learner.params)}
                got["after"].append(after)
            run(data, rows[k:], mu, nu, gathered)

        runner.train_iteration, env.step = iteration_kept, step_kept
        if reset:
            runner.setup = setup_kept
        try:
            t0 = time.perf_counter()
            runner.train(last)
            seconds = time.perf_counter() - t0
        finally:
            del runner.train_iteration, env.step
            if reset:
                del runner.setup
        if last == 1:
            start = {"state_dict": self.weights, "mu": None, "nu": None,
                     "count": 0}
        else:
            depth = max(1, self.cfg["runner"]["pipeline_depth"])
            variables, adam = runner._snapshot(
                runner._ring[(last - 2) % (depth + 1)])
            start = {"state_dict": variables, "mu": adam.mu, "nu": adam.nu,
                     "count": int(adam.count)}
        buf, (adv, ret) = runner._rollout, runner._gae

        def stacked(outs):
            return torch.stack([torch.stack([r, d.float(), t.float()])
                                for r, d, t in outs])

        def cpu(x):
            # copies (on the CPU .cpu() would alias the buffers the next
            # iteration overwrites)
            if isinstance(x, (dict, list)):
                return ({n: cpu(v) for n, v in x.items()}
                        if isinstance(x, dict) else [cpu(v) for v in x])
            return x.to("cpu", copy=True) if isinstance(x, torch.Tensor) else x

        host = {"obs": buf.obs, "actions": buf.actions, "values": buf.values,
                "log_probs": buf.log_probs, "adv": adv, "ret": ret,
                "env": stacked(got["steps"]), "rows": got["rows"],
                "env_state": {f: getattr(got["env_state"], f)
                              for f in ref_env.State._fields},
                "after": got["after"], "start": start}
        if reset:
            host["reset"] = stacked(got["reset"])[0]
        return {**cpu(host), "seconds": seconds}

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> tuple[dict, int]:
        runner = self.runner
        n = max(1, round(seconds / self.iteration_s))
        start = runner.iteration
        self.last = self._kept(runner, start + n)
        wall = self.last["seconds"]
        with open(os.path.join(self.log_dir, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        self.records["phases"] = [r for r in logged if r["step"] > start]
        print(f"train window: {n} iterations in {wall:.3f} s (warm "
              f"{self.iteration_s:.3f} s); fetch spacing "
              f"{[round(r['time/iter_seconds'], 4) for r in self.records['phases']]}",
              file=sys.stderr)
        return {"train_env_steps_per_s": n * self.steps_per_iteration / wall}, n

    # -- the traced run ---------------------------------------------------------
    def trace(self) -> None:
        """Profiles a ``Runner.train`` call of TRACED_ITERATIONS
        iterations with the device's records only, and reads its second
        iteration alone: the pipelined loop's steady state, without the
        call's reset and drain.  Then, for the breakdown, a call of two
        with the host's records too (which take longer to read), read
        from the second's dispatch to the end of its device work.  Keeps
        the read iteration's splat poses."""
        self.records["profile"], self.records["poses"] = self._profiled(
            TRACED_ITERATIONS)
        self.records["host_profile"] = self._profiled(2, host=True)[0]

    def _profiled(self, iterations: int, host: bool = False):
        """(the profile of one call of `iterations` cut to its second
        iteration, from a CUDA event recorded at its dispatch to one at
        the next's, or in a call of two to one behind its work, and the
        poses of that iteration's env steps [T, N, 6])."""
        runner = self.runner
        train_iteration = runner.train_iteration
        starts, ends, poses = [], [], []

        def marked():
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event

        def iteration_marked(env_state, obs):
            starts.append(marked())
            env_state, obs, packed = train_iteration(env_state, obs)
            ends.append(marked())
            # each step renders at the pose its next observation holds
            poses.append(torch.cat([runner._rollout.obs[1:, :, POSE_LAST],
                                    obs[None, :, POSE_LAST]]))
            return env_state, obs, packed

        runner.train_iteration = iteration_marked
        t0 = time.perf_counter()
        try:
            prof = trace.profiled(
                lambda: runner.train(runner.iteration + iterations),
                host=host)
        finally:
            del runner.train_iteration
        print(f"train trace: {iterations} iterations profiled and read in "
              f"{time.perf_counter() - t0:.1f} s ({len(prof.spans)} device, "
              f"{len(prof.host)} host records)", file=sys.stderr)
        end = starts[2] if len(starts) > 2 else ends[1]
        return trace.cut(prof, starts[1], end), poses[1].cpu()

    def release(self) -> None:
        self.runner.close()
        del self.runner
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.log_dir, ignore_errors=True)

    # -- the reference ------------------------------------------------------------
    def check(self) -> dict:
        """The numbers compared (``compare.py``), each the worse of the
        two kept iterations' (UNCOMPARED ones printed only)."""
        harness.set_tf32(False)
        env_cfg = self.cfg["env"]
        scenes = harness.to_device(self.arrays, self.device)
        env = ref_env.Env(env_cfg, scenes, env_cfg["renderer"]["resolution"])
        numbers: dict = {}
        for name, got in (("first", self.first), ("last", self.last)):
            mine = self._check_iteration(env, got)
            print(f"train check, {name} iteration: {mine}", file=sys.stderr)
            for k, v in mine.items():
                if k not in UNCOMPARED:
                    numbers[k] = max(numbers.get(k, v), v)
        return numbers

    def _check_iteration(self, env, got: dict) -> dict:
        """The reference's rollout over the program's actions (from its
        own reset with the program's staggered episode lengths, or from
        the program's env state and observation at the iteration's
        start), its GAE, and its first minibatch steps over the program's
        rows from the iteration's starting parameters and Adam state."""
        dev, ppo = self.device, self.cfg["ppo"]
        start = got["start"]
        pol = ref_policy.Policy(self.cfg["model"], dev)
        pol.load_state_dict(start["state_dict"])
        pol.eval()
        t_steps = ppo["n_steps"]
        state = ref_env.State(**{f: v.to(dev)
                                 for f, v in got["env_state"].items()})
        mismatched = 0
        if "reset" in got:
            n = state.episode_len.shape[0]
            reset, out = env.reset(torch.arange(n, device=dev)
                                   % self.cfg["env"]["scene"]["num_scenes"])
            state = reset._replace(episode_len=state.episode_len)
            mismatched += compare.mismatches(got["reset"], torch.stack([
                out.reward, out.done.float(), out.time_out.float()]))
            obs = out.obs
        else:
            obs = got["obs"][0].to(dev)
        obs_seq, values, logps, env_out = [], [], [], []
        with torch.no_grad():
            for t in range(t_steps):
                mismatched += compare.mismatches(got["obs"][t], obs)
                logits, value = pol(obs)
                actions = got["actions"][t].to(dev)
                obs_seq.append(obs)
                values.append(value)
                logps.append(ref_policy.log_prob(logits, actions))
                state, out = env.step(state, actions)
                step = torch.stack([out.reward, out.done.float(),
                                    out.time_out.float()])
                mismatched += compare.mismatches(got["env"][t], step)
                env_out.append(step)
                obs = out.obs
            last_values = pol(obs)[1]
        values, logps = torch.stack(values), torch.stack(logps)
        reward, done, time_out = torch.stack(env_out).unbind(1)
        next_values = torch.cat([values[1:], last_values[None]])
        rewards = reward + ppo["gamma"] * next_values * time_out
        adv, ret = ref_ppo.gae(rewards, values, done, last_values, ppo["gamma"],
                               ppo["gae_lambda"])
        numbers = {"env_mismatches": mismatched}
        # the log-probs are not compared: near -17.85 an ulp is 1.9e-6,
        # and the TF32 control moves them by no more than two (PERF.md)
        numbers["value_gap"] = compare.max_gap(
            got["values"], values, float(values.abs().max()))
        numbers["adv_gap"] = compare.max_gap(
            got["adv"], adv, float(adv.std()))

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        data = (flat(torch.stack(obs_seq)), flat(got["actions"].to(dev)),
                flat(logps), flat(values), flat(adv), flat(ret))
        del obs_seq
        adam = {k: None if start[k] is None else
                {n: v.to(dev) for n, v in start[k].items()}
                for k in ("mu", "nu")}
        before = {n: p.detach().clone() for n, p in pol.named_parameters()}
        rows = got["rows"].to(dev)
        after = got["after"]
        if self.precision == "tf32":
            after = self._update_in_tf32(got, adam, rows)
        steps = ref_ppo.steps(pol, ppo, self.cfg["env"]["num_envs"], data,
                              rows, adam["mu"], adam["nu"], start["count"])
        numbers.update(self._steps_numbers(steps, after, before, pol,
                                           adam["mu"]))
        return numbers

    def _update_in_tf32(self, got: dict, adam: dict, rows) -> list:
        """The lower-precision control of the update, which the program
        runs in float32 whatever the setting: the reference's minibatch
        steps in TF32, put in the program's place (its rollout, its rows,
        its starting state), as the learner's states after each step."""
        dev, ppo = self.device, self.cfg["ppo"]
        pol = ref_policy.Policy(self.cfg["model"], dev)
        pol.load_state_dict(got["start"]["state_dict"])
        data = tuple(x.to(dev).reshape((-1,) + x.shape[2:]) for x in (
            got["obs"], got["actions"], got["log_probs"], got["values"],
            got["adv"], got["ret"]))
        harness.set_tf32(True)
        try:
            steps = ref_ppo.steps(pol, ppo, self.cfg["env"]["num_envs"],
                                  data, rows, adam["mu"], adam["nu"],
                                  got["start"]["count"])
        finally:
            harness.set_tf32(False)
        sums, after = torch.zeros(6), []
        for terms, applied, mu in steps:
            if applied:
                sums = sums + torch.tensor([float(x) for x in terms] + [1.0])
            after.append({"sums": sums, "mu": mu})
        after[-1]["params"] = {n: p.detach() for n, p in pol.named_parameters()}
        return after

    def _steps_numbers(self, steps, after: list, before: dict, pol,
                       mu0) -> dict:
        """loss_gap, grad_gap and step_gap between the reference's steps
        and the program's learner states `after` them (``after[0]["mu"]``,
        ``after[-1]["params"]``), from the parameters `before` and the
        first moment `mu0` (None: zero)."""
        ppo = self.cfg["ppo"]
        if len(steps) < len(after):
            return {"loss_gap": NO_READING, "grad_gap": NO_READING,
                    "step_gap": NO_READING}

        def loss(terms):
            pl, vl, el = (float(x) for x in terms[:3])
            return (ppo["policy_loss_mult"] * pl + ppo["ent_coef"] * el
                    + ppo["vf_coef"] * vl)

        prev = torch.zeros(6)
        loss_gap = 0.0
        for (terms, applied, _), mine in zip(steps, after):
            step_sums = mine["sums"].cpu() - prev
            prev = mine["sums"].cpu()
            want = loss(terms) if applied else 0.0
            loss_gap = max(loss_gap, abs(loss(step_sums) - want)
                           / max(abs(loss(terms)), 1e-12))
        # the first gradient as Adam got it, from its first moment before
        # and after the step
        b1, dev = 0.9, self.device

        def first_grads(mu1) -> dict:
            return {n: float(((m.to(dev).double() - (
                0.0 if mu0 is None else b1 * mu0[n].double())) / (1 - b1)
                ).norm()) for n, m in mu1.items()}

        grad_want = first_grads(steps[0][2])
        grad_got = first_grads(after[0]["mu"])
        keep = compare.moving_leaves(grad_want)
        delta_want = {n: float((p.detach() - before[n]).double().norm())
                      for n, p in pol.named_parameters()}
        delta_got = {n: float((p.to(dev) - before[n]).double().norm())
                     for n, p in after[-1]["params"].items()}
        return {"loss_gap": loss_gap,
                "grad_gap": compare.leaf_gap(grad_got, grad_want, keep),
                "step_gap": compare.leaf_gap(delta_got, delta_want, keep)}

    # -- the per-layer records ----------------------------------------------------
    def layer_records(self, kind: str) -> dict:
        """What the metric readers read, with the counts the benchmark
        makes itself: the reference policy's FLOPs an iteration (its
        rollout's forwards and the applied minibatches' forward and
        backward) and the splat calls' valid points at the profiled
        steps' poses."""
        cfg, rec = self.cfg, self.records
        env_cfg, ppo = cfg["env"], cfg["ppo"]
        dev = self.device
        n, t_steps = env_cfg["num_envs"], ppo["n_steps"]
        batch = ppo["batch_size"]
        per_update = ppo["n_epochs"] * (n * t_steps // batch)
        pol = ref_policy.Policy(cfg["model"], dev)
        pol.load_state_dict(self.weights)
        obs_n = torch.zeros(n, env_cfg["pose_buf_len"] * 6 + 8000
                            + env_cfg["rgb_k"] * env_cfg["rgb_h"]
                            * env_cfg["rgb_w"], device=dev)
        fwd_n = _count(lambda: pol.eval()(obs_n))
        pol.train()
        mb = obs_n[:1].expand(batch, -1).contiguous()
        fwd_b = _count(lambda: pol(mb))
        fwd_bwd = _count(lambda: sum(x.sum() for x in pol(mb)).backward())
        flops = []
        for p in rec["phases"]:
            applied = int(p["train/n_minibatches"])
            flops.append((t_steps + 1) * fwd_n + applied * fwd_bwd
                         + (fwd_b if applied < per_update else 0))
        out = {"phases": rec["phases"], "unit_flops": flops,
               "unit_seconds": [p["time/iter_seconds"] for p in rec["phases"]],
               "peaks": harness.peaks(kind)}
        prof = rec.get("profile")
        if prof is not None:
            out.update(spans=prof.spans, window_ns=prof.window[1] - prof.window[0],
                       zbuf_calls=self._zbuf_calls(rec["poses"]))
        return out

    def _zbuf_calls(self, poses) -> list | None:
        """(n, q, valid points, h, w) of each splat call of the profiled
        iteration (one an env step), the valid points counted by
        the reference's projection at the poses the observations hold."""
        env_cfg, dev = self.cfg["env"], self.device
        scenes = harness.to_device(self.arrays, dev)
        env = ref_env.Env(env_cfg, scenes, env_cfg["renderer"]["resolution"])
        if env.cache is not None:
            return None
        n = poses.shape[1]
        sid = torch.arange(n, device=dev) % env_cfg["scene"]["num_scenes"]
        pts, mask = scenes["surf_pts"][sid], scenes["surf_mask"][sid]
        calls = []
        for p in poses.to(dev):
            r, t = ref_env.pose_to_c2w(p, env_cfg["camera"]["z_offset"])
            ok = ref_env.project(pts, env.k, r, t, env.h, env.w, 1e-3)[3] & mask
            calls.append((n, pts.shape[1], int(ok.sum()), env.h, env.w))
        return calls


def _count(fn) -> float:
    with work_flops.FlopCounter() as c:
        fn()
    return c.flops

