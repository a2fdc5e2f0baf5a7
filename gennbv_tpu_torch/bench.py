"""End-to-end PPO throughput benchmark at the reference training scale, on
one card (port of the root ``bench.py``, function for function).

    python -m gennbv_tpu_torch.bench                    # on the card
    python -m gennbv_tpu_torch.bench --smoke --device cpu
    python -m gennbv_tpu_torch.bench --mesh 2           # gloo ranks, CPU

Measures env-steps/sec of the full training iteration
(``Runner.train_iteration``: 128 env steps of render, map, reward and
policy, GAE, and the 5-epoch minibatched PPO update) at 256 envs with the
128x128 camera, then at the reference's own 400x400 training camera.
Prints the JAX bench's JSON line:

    {"metric": ..., "value": N, "unit": "env_steps_per_sec",
     "vs_baseline": N, "phases": {...}, "camera400": {...}}

``value`` is iterations x 128 steps x 256 envs over the host-clock window
of back-to-back ``train_iteration`` calls after one warm-up iteration
(which builds the kernels and captures the update's CUDA graph), ended by
``torch.cuda.synchronize()``.  Beside it, ``iter_spacing_seconds`` gives
the median and min-max spacing of CUDA events recorded at each
iteration's end (no host wait in the loop), so one run shows its own
spread.  ``setup_seconds`` times the runner (scenes, policy), the reset
(whose env step builds the kernels with nvcc at their first use) and the
warm-up iteration.  ``kernel_launches`` counts each hand-written
kernel's launches in the timed window, from the wrappers' own counters.
``device`` is the card's name and power limit (``nvidia-smi``).

The roofline fields (``mfu``, ``hbm_util``, ``tflops_per_iter``,
``gbytes_per_iter``, ``bound``) come from ``utils.work.WorkCounter`` in
place of XLA's cost analysis: matmul and convolution FLOPs, bytes as every
op's inputs and outputs, and each hand kernel's ``work(...)`` added at its
launch.  The update's minibatch step replays a CUDA graph, invisible to
dispatch: one step is counted eagerly and scaled by the minibatches the
update replayed, n_epochs x n_minibatches (every one runs on the device,
those after a KL stop too, whose results the selects discard;
``minibatches_applied_per_iter`` says how many were kept).  Counting runs
in a pass of its own after each timed window, never inside one: a
rollout and an update, the iteration but for the packing of its metrics
(a few small ops).  ``mfu`` is read against the card's peak for the type
the matmuls and convolutions run in: the port keeps TF32 off
(``ops/fp32.py``) and the policy in float32, so on an H100 that is the
float32 peak without tensor cores, 67 TFLOP/s (the JAX bench reads
against bf16 because its MXU runs bf16); the counter raises on any other
type.  ``peak`` says which.  ``hbm_util`` is an estimate, not a floor:
its bytes are every op's inputs and outputs with no L2 reuse, and a
program of many small ops finds much of its data in the 50 MB L2, so it
can read high; ``bound`` names the nearer wall by these two estimates.
A measurement of DRAM bytes (a hardware counter) is what would settle it.
On the CPU (``--smoke --device cpu``) there is no peak, and the
utilizations are null: a CPU run gives no device metric.

The phases split the iteration at its one real boundary, as the JAX
bench does: ``rollout`` (collect + GAE into the Runner's own buffers),
``update`` (``ppo.update`` with the Runner's Learner on those buffers, so
the graph's addresses hold), and the standalone ``env_step`` with the
fixed action [40, 40, 25, 0, 6, 6]; each with its seconds and roofline.

``--mesh N`` runs one iteration on N gloo ranks on the CPU at the JAX
bench's reduced config and reports every ``torch.distributed`` call it
made, by kind, with the payload each moved (the result's bytes, as the
JAX report counts a collective), in place of the JAX bench's static HLO
count.

The reference publishes no steps/sec figure; the baseline constant is the
JAX bench's engineering estimate of the reference pipeline at the same
scale (order 200 env-steps/s on an A100-class GPU).
"""
from __future__ import annotations

import argparse
import copy
import functools
import gc
import json
import signal
import statistics
import sys
import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from gennbv_tpu_torch.algo import gae, ppo, rollout
from gennbv_tpu_torch.algo.runner import _METRIC_KEYS, Runner
from gennbv_tpu_torch.config import (CameraConfig, Config, EnvConfig,
                                     PPOConfig, RendererConfig, RunnerConfig,
                                     SceneConfig)
from gennbv_tpu_torch.ops import kernels
from gennbv_tpu_torch.parallel import mesh as mesh_lib
from gennbv_tpu_torch.utils.device import card
from gennbv_tpu_torch.utils.work import WorkCounter

REFERENCE_EST_STEPS_PER_SEC = 200.0

# minimum remaining wall-clock (s) worth starting the 400^2 leg with; below
# this the leg is skipped outright
MIN_400_BUDGET = 60.0


class Peaks(NamedTuple):
    """A card's dense peaks at its full power: TFLOP/s by the type a
    matmul or convolution computes in, and HBM GB/s.  The bench reads
    float32's (the only type the port computes in, ``utils.work``)."""
    tflops: dict
    hbm_gbps: float


# by the first key the card's name contains (NVIDIA's data sheets)
_PEAKS = {
    "H100 PCIe": Peaks({"float32": 51.0, "tf32": 378.0, "bfloat16": 756.0,
                        "float16": 756.0}, 2000.0),
    "H100": Peaks({"float32": 67.0, "tf32": 494.7, "bfloat16": 989.4,
                   "float16": 989.4}, 3350.0),     # SXM
}

# the fixed action of the standalone env step (the JAX bench's)
ENV_STEP_ACTION = (40, 40, 25, 0, 6, 6)
# the metric sums that ride at the end of each minibatch's gradient bucket
# (policy, value and entropy loss, KL, clip fraction: ppo.reduce_step)
_BUCKET_METRICS = 5
_MINIBATCHES = _METRIC_KEYS.index("train/n_minibatches")


def card_peaks(name: str) -> Optional[Peaks]:
    """The peaks of the card called `name`, or None for a card the table
    lacks."""
    for key, peaks in _PEAKS.items():
        if key in name:
            return peaks
    return None


def roofline(flops: float, nbytes: float, calls_per_sec: float,
             peaks: Optional[tuple]) -> dict:
    """MFU and HBM-utilization fields of a program doing `flops` and
    moving `nbytes` a call, `calls_per_sec` times a second, against
    `peaks` = (TFLOP/s, HBM GB/s), the JAX bench's fields under its names.
    ``mfu`` is the counted FLOPs' share of the peak; ``hbm_util`` the
    counted bytes' share of the HBM rate, an estimate rather than a bound
    (``utils.work`` counts every op's bytes with no cache reuse, so it can
    read high); ``bound`` names the nearer roofline wall by the two, or
    "latency" when both are under 5%.  Without peaks (the CPU) the
    utilizations and ``bound`` are None."""
    out = {"mfu": None, "hbm_util": None,
           "tflops_per_iter": round(flops / 1e12, 4),
           "gbytes_per_iter": round(nbytes / 1e9, 4), "bound": None}
    if peaks is None:
        return out
    peak_tflops, peak_gbps = peaks
    mfu = flops * calls_per_sec / (peak_tflops * 1e12)
    hbm_util = nbytes * calls_per_sec / (peak_gbps * 1e9)
    if max(mfu, hbm_util) < 0.05:
        bound = "latency"
    elif hbm_util > mfu:
        bound = "bandwidth"
    else:
        bound = "compute"
    out.update(mfu=round(mfu, 4), hbm_util=round(hbm_util, 4), bound=bound)
    return out


class Work(NamedTuple):
    """Counted work: float32 operations, and bytes."""
    flops: float
    nbytes: float

    @classmethod
    def of(cls, fn) -> "Work":
        """The work of ``fn()``, counted in a pass of its own."""
        with WorkCounter() as w:
            fn()
        return cls(w.flops, w.bytes)

    def plus(self, other: "Work", times: float = 1.0) -> "Work":
        return Work(self.flops + times * other.flops,
                    self.nbytes + times * other.nbytes)


def _roofline(work: Work, calls_per_sec: float,
              peaks: Optional[Peaks]) -> dict:
    """``roofline`` of counted work against the float32 peak, and that
    peak."""
    if peaks is None:
        return {**roofline(work.flops, work.nbytes, calls_per_sec, None),
                "peak": None}
    tflops = peaks.tflops["float32"]
    return {**roofline(work.flops, work.nbytes, calls_per_sec,
                       (tflops, peaks.hbm_gbps)),
            "peak": {"tflops": tflops, "hbm_gbps": peaks.hbm_gbps,
                     "type": "float32"}}


def _make_runner(camera: int, num_envs: int = 256, num_devices: int = 0,
                 resolution: int = 64, n_steps: int = 128,
                 batch_size: int = 128,
                 device: torch.device | str = "cuda") -> Runner:
    cfg = Config(
        env=EnvConfig(
            num_envs=num_envs,
            camera=CameraConfig(height=camera, width=camera),
            renderer=RendererConfig(resolution=resolution),
            scene=SceneConfig(num_scenes=num_envs, seed=0),
        ),
        ppo=PPOConfig(n_steps=n_steps, batch_size=batch_size, n_epochs=5),
        runner=RunnerConfig(seed=0, save_freq=0, num_devices=num_devices),
    )
    return Runner(cfg, device=device)


def _phase_fns(runner: Runner):
    """The training iteration split at its one real phase boundary, as
    ``Runner.train_iteration`` runs it: ``rollout(env_state, obs)``
    (collect + GAE into the Runner's buffers; returns env_state', obs')
    and ``update()`` (the PPO update on those buffers with the Runner's
    Learner; returns the minibatches it applied, a device scalar).  Call
    ``train_iteration`` once first: it makes the buffers."""
    cfg = runner.cfg.ppo

    def rollout_phase(env_state, obs):
        env_state, obs, batch, _ = rollout.collect(
            runner.env, runner.policy, env_state, obs, runner.generator,
            cfg.n_steps, cfg.gamma, runner.obs_dtype, **runner._place(),
            out=runner._rollout)
        gae.compute_gae(batch.rewards, batch.values, batch.dones.float(),
                        batch.last_values, cfg.gamma, cfg.gae_lambda,
                        out=runner._gae)
        return env_state, obs

    def update_phase():
        buf, (adv, ret) = runner._rollout, runner._gae
        t, n = adv.shape

        def flat(x):
            return x.reshape((t * n,) + x.shape[2:])

        runner.opt_state, upd = ppo.update(
            runner.policy, runner.opt, cfg, runner.opt_state, flat(buf.obs),
            flat(buf.actions), flat(buf.log_probs), flat(buf.values),
            flat(adv), flat(ret), runner.generator,
            num_envs=runner.cfg.env.num_envs, mesh=runner.mesh,
            learner=runner.learner)
        return upd.n_minibatches_done

    return rollout_phase, update_phase


def _minibatch_step_work(runner: Runner) -> tuple[Work, int]:
    """One minibatch step of the update (what a replay of the Learner's
    graph runs), counted eagerly on copies of the policy and the Adam
    moments, the rows drawn from a generator of its own; and the steps an
    update replays (n_epochs x n_minibatches: all of them, a KL stop or
    not)."""
    cfg, n = runner.cfg.ppo, runner.cfg.env.num_envs
    policy = copy.deepcopy(runner.policy).train()
    learner = ppo.Learner(policy, runner.opt, cfg)
    adv, ret = runner._gae
    m = adv.numel()
    buf = runner._rollout
    data = tuple(x.reshape((m,) + x.shape[2:]) for x in (
        buf.obs, buf.actions, buf.log_probs, buf.values, adv, ret))
    gen = torch.Generator(runner.device).manual_seed(0)
    rows = ppo.flat_rows(ppo.minibatch_indices(cfg, m, n, gen), m, n)
    mu = [runner.opt_state.mu[k].clone() for k in learner.names]
    nu = [runner.opt_state.nu[k].clone() for k in learner.names]
    learner.begin(runner.opt_state.count)
    return Work.of(lambda: learner.step(data, rows[0], mu, nu)), rows.shape[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(device: torch.device):
    """A point in the device's stream: a CUDA event, recorded without a
    host wait; on the CPU, which runs each op as it is called, the host
    clock."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _spacing(marks: list) -> list:
    """Seconds between consecutive marks (read once the device ran them)."""
    if marks and isinstance(marks[0], float):
        return [b - a for a, b in zip(marks, marks[1:])]
    return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]


def _spread(seconds: list) -> dict:
    return {"median": round(statistics.median(seconds), 4),
            "min": round(min(seconds), 4), "max": round(max(seconds), 4),
            "n": len(seconds)}


class Window(NamedTuple):
    """A timed window of back-to-back iterations: its host-clock seconds,
    the spacing of the iterations' ends, each kernel's launches in it and
    the minibatches each iteration's update applied."""
    seconds: float
    spacing: list
    launches: dict
    applied: list


def _run(loop):
    """The default window: the loop, untraced."""
    return loop()


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bench: --device cuda, but torch.cuda.is_available() is False "
            "(the bench never falls back to the CPU; --device cpu runs the "
            "--smoke check of the harness)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"bench: no path for device {dev}")
    return dev


def _device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return card()
    return {"name": "cpu", "power_limit": None}


def _timed(fn, calls: int, device: torch.device) -> tuple[float, list]:
    """Seconds a call of ``fn()`` over `calls` back-to-back calls, ended by
    a synchronize (the warm-up iteration built and captured everything
    they run); and the calls' results."""
    _sync(device)
    t0 = time.perf_counter()
    out = [fn() for _ in range(calls)]
    _sync(device)
    return (time.perf_counter() - t0) / calls, out


def bench_config(camera: int, iters: int, phases: bool = True,
                 device: torch.device | str = "cuda", window=_run,
                 **runner_kw) -> dict:
    """Full-iteration steps/sec at the given square camera, with optional
    per-phase breakdown.  Every timing loop chains the device state (each
    call consumes the previous call's output) after the warm-up iteration.
    `window(loop)` runs the timed loop (``loop()`` returns a ``Window``;
    it may be run more than once) and returns its ``Window``:
    ``chip_smoke.py`` passes one that profiles it."""
    dev = _device(device)
    peaks = (card_peaks(torch.cuda.get_device_name(dev))
             if dev.type == "cuda" else None)
    t0 = time.perf_counter()
    runner = _make_runner(camera, device=dev, **runner_kw)
    _sync(dev)
    t_runner = time.perf_counter()
    env_state, obs = runner.setup()
    _sync(dev)
    t_reset = time.perf_counter()
    # warm-up: builds the kernels and captures the update's CUDA graph
    env_state, obs, _ = runner.train_iteration(env_state, obs)
    _sync(dev)
    t_warm = time.perf_counter()
    num_envs, n_steps = runner.cfg.env.num_envs, runner.cfg.ppo.n_steps
    state = [env_state, obs]

    def loop() -> Window:
        before = kernels.launches()
        marks, packed = [_mark(dev)], []
        s0 = time.perf_counter()
        for _ in range(iters):
            state[0], state[1], metrics = runner.train_iteration(*state)
            packed.append(metrics)
            marks.append(_mark(dev))
        _sync(dev)
        seconds = time.perf_counter() - s0
        after = kernels.launches()
        return Window(seconds, _spacing(marks),
                      {k: after[k] - before[k] for k in after},
                      [float(p[_MINIBATCHES]) for p in packed])

    win = window(loop)
    applied = statistics.mean(win.applied)

    # the counting pass, after the window: a rollout and an update under
    # the counter (the iteration but for its packing of the metrics), and
    # where the update replays a CUDA graph, invisible to the counter, one
    # minibatch step counted eagerly for each minibatch it replays
    rollout_phase, update_phase = _phase_fns(runner)

    def roll():
        state[0], state[1] = rollout_phase(*state)

    roll_work = Work.of(roll)
    upd_work = Work.of(update_phase)
    if runner.learner.captures:
        upd_work = upd_work.plus(*_minibatch_step_work(runner))
    iteration = roll_work.plus(upd_work)
    _sync(dev)

    out = {
        "value": round(iters * n_steps * num_envs / win.seconds, 2),
        "camera": camera,
        "iter_seconds": round(win.seconds / iters, 4),
        "iter_spacing_seconds": _spread(win.spacing),
        **_roofline(iteration, iters / win.seconds, peaks),
        "minibatches_applied_per_iter": applied,
        "kernel_launches": win.launches,
        "setup_seconds": {"runner": round(t_runner - t0, 3),
                          "reset": round(t_reset - t_runner, 3),
                          "first_iteration": round(t_warm - t_reset, 3),
                          "total": round(t_warm - t0, 3)},
        "device": _device_info(dev),
    }
    if not phases:
        return out

    # ---- per-phase: rollout+GAE vs PPO update ----
    dt_roll, _ = _timed(roll, iters, dev)
    dt_upd, done = _timed(update_phase, iters, dev)
    upd_applied = statistics.mean(float(d) for d in done)

    # ---- env.step standalone (the op the rollout serializes 128x) ----
    actions = torch.tensor([ENV_STEP_ACTION], dtype=torch.int32,
                           device=dev).repeat(num_envs, 1)
    stepped = [state[0]]

    def env_step():
        stepped[0], _ = runner.env.step(stepped[0], actions)

    dt_step, _ = _timed(env_step, 4 * iters, dev)
    step_work = Work.of(env_step)
    _sync(dev)
    out["phases"] = {
        "rollout": {"seconds": round(dt_roll, 4),
                    **_roofline(roll_work, 1.0 / dt_roll, peaks)},
        "update": {"seconds": round(dt_upd, 4),
                   "minibatches_applied": upd_applied,
                   **_roofline(upd_work, 1.0 / dt_upd, peaks)},
        "env_step": {"seconds": round(dt_step, 5),
                     **_roofline(step_work, 1.0 / dt_step, peaks)},
    }
    return out


# torch.distributed's collectives, by the JAX report's names for them
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_gather": "all-gather",
    "all_gather_into_tensor": "all-gather", "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter", "all_to_all": "all-to-all",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}


def _payload(first) -> int:
    """A collective's payload: the bytes of its first argument, the tensor
    it reduces or broadcasts in place or the output (list) it fills."""
    if isinstance(first, torch.Tensor):
        return first.nbytes
    return sum(t.nbytes for t in first)


def _site() -> str:
    """The port's function that made the collective being recorded: the
    innermost frame of the package outside ``parallel/mesh.py`` and this
    module, as ``algo.ppo.reduce_step``."""
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename.replace("\\", "/")
        if "/gennbv_tpu_torch/" in path and not path.endswith(
                ("/parallel/mesh.py", "/gennbv_tpu_torch/bench.py")):
            module = path.rsplit("/gennbv_tpu_torch/", 1)[1][:-3]
            return f"{module.replace('/', '.')}.{frame.f_code.co_qualname}"
        frame = frame.f_back
    return "other"


class CollectiveRecorder:
    """While active, records every ``torch.distributed`` collective as
    (kind, payload bytes, site): the kind under the JAX report's name, the
    payload the result's bytes (as the JAX report counts a collective),
    the site the port's function that made it (``_site``)."""

    def __enter__(self):
        self.calls: list = []
        self.saved = {name: getattr(dist, name) for name in _COLLECTIVES}
        for name, fn in self.saved.items():
            setattr(dist, name, functools.partial(self._record, name, fn))
        return self

    def _record(self, name, fn, first, *args, **kwargs):
        self.calls.append((_COLLECTIVES[name], _payload(first), _site()))
        return fn(first, *args, **kwargs)

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def _mesh_rank(device, n_devices: int) -> dict:
    """One rank of ``mesh_report``: one training iteration at the reduced
    config, its collectives recorded."""
    runner = _make_runner(camera=64, num_envs=4 * n_devices, resolution=32,
                          n_steps=8, batch_size=2 * n_devices,
                          num_devices=n_devices, device=device)
    env_state, obs = runner.setup()
    with CollectiveRecorder() as rec:
        runner.train_iteration(env_state, obs)
    return {"calls": rec.calls,
            "params_bytes": sum(p.numel() * p.element_size()
                                for p in runner.policy.parameters())}


def mesh_report(n_devices: int) -> dict:
    """One training iteration on `n_devices` gloo ranks on the CPU (an
    env-sharded mesh, ``parallel/mesh.py``) at the JAX bench's reduced
    config, and the collectives it made.

    The dominant collective, the gradient all-reduce of each minibatch (one
    bucket of the gradients and the step's metric sums,
    ``ppo.reduce_step``), is model-sized (params bytes x minibatches),
    independent of env count and camera, so the traffic transfers to the
    production config up to the small per-iteration metric sums."""
    ranks = mesh_lib.launch(_mesh_rank, n_devices, n_devices, device="cpu")
    calls, params_bytes = ranks[0]["calls"], ranks[0]["params_bytes"]
    coll: dict = {}
    sites: dict = {}
    for kind, nbytes, site in calls:
        for table, key in ((coll, kind), (sites, site)):
            entry = table.setdefault(key, {"count": 0, "bytes": 0})
            entry["count"] += 1
            entry["bytes"] += nbytes
    buckets = [nbytes for kind, nbytes, site in calls
               if site == "algo.ppo.reduce_step"]
    # float32: the bucket's tail of metric sums is not gradient
    grad_bytes = buckets[0] - 4 * _BUCKET_METRICS if buckets else 0
    return {
        "metric": f"collective traffic of one training iteration, "
                  f"{n_devices}-rank env-sharded mesh (gloo, CPU)",
        "n_devices": n_devices,
        "collectives": coll,
        "collective_bytes_static": sum(v["bytes"] for v in coll.values()),
        "by_site": sites,
        "minibatches_per_iter": len(buckets),
        "params_bytes": params_bytes,
        "grad_allreduce_bytes_per_minibatch": grad_bytes,
        "est_grad_allreduce_bytes_per_iter": params_bytes * len(buckets),
        "note": "every collective one iteration made, each counted at its "
                "payload (the result's bytes); collective_bytes_static "
                "keeps the JAX report's key for their sum",
    }


def _settle() -> None:
    """Lets a leg's device work finish and frees its tensors (a leg cut
    by the alarm leaves both behind)."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def emit(bench_fn, args, out=None):
    """Measure and print, timeout-proof, as the JAX bench's ``emit``.

    The headline 128^2 JSON line is printed and flushed the moment it is
    measured, before the 400^2 leg starts, so a wall-clock kill during
    that leg cannot lose it; when the 400^2 leg completes, the merged line
    is printed as a second line.  The 400^2 leg runs under an internal
    time budget (SIGALRM): past it the leg becomes {"skipped": ...}, and a
    leg that raises becomes {"error": ...}.  A signal handler runs only
    between bytecodes, so the alarm can land an iteration late; after an
    abort the device's queue is drained and the leg's tensors freed before
    the line is printed."""
    out = out or sys.stdout
    t_start = time.perf_counter()
    res = bench_fn(camera=128, iters=args.iters)
    line = {
        "metric": "PPO end-to-end env-steps/sec, 256 envs (render+map+update)",
        "value": res.pop("value"),
        "unit": "env_steps_per_sec",
    }
    line["vs_baseline"] = round(line["value"] / REFERENCE_EST_STEPS_PER_SEC, 3)
    line.update(res)
    print(json.dumps(line), file=out, flush=True)  # headline: safe on disk
    _settle()

    if args.skip_400:
        return

    budget = args.budget_400 - (time.perf_counter() - t_start)
    if budget < MIN_400_BUDGET:
        line["camera400"] = {"skipped": f"time budget ({budget:.0f}s left)"}
        print(json.dumps(line), file=out, flush=True)
        return

    class _Timeout(Exception):
        pass

    def _alarm(signum, frame):
        raise _Timeout()

    use_alarm = hasattr(signal, "SIGALRM")
    if use_alarm:
        prev = signal.signal(signal.SIGALRM, _alarm)
        signal.alarm(max(1, int(budget)))  # alarm(0) would disarm
    try:
        r400 = bench_fn(camera=400, iters=2, phases=True)
        r400["vs_baseline"] = round(
            r400["value"] / REFERENCE_EST_STEPS_PER_SEC, 3)
        line["camera400"] = r400
    except _Timeout:
        line["camera400"] = {"skipped": f"time budget ({args.budget_400}s)"}
    except Exception as e:  # noqa: BLE001 -- the headline must survive
        line["camera400"] = {"error": repr(e)}
    finally:
        if use_alarm:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, prev)
    _settle()
    print(json.dumps(line), file=out, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(with --smoke)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run one iteration on N gloo ranks on the CPU and "
                         "report its collectives instead of timing")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--skip-400", action="store_true",
                    help="skip the secondary 400x400 measurement")
    ap.add_argument("--budget-400", type=float, default=1500.0,
                    help="total wall-clock budget (s) by which the 400x400 "
                         "leg must finish; the leg is skipped or aborted "
                         "past it")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes on the given device (a check of the "
                         "bench harness itself, not a measurement)")
    args = ap.parse_args(argv)

    if args.smoke:
        res = bench_config(camera=16, iters=2, phases=True, device=args.device,
                           num_envs=8, resolution=16, n_steps=4, batch_size=16)
        print(json.dumps({"metric": "smoke", **res}))
        return

    if args.mesh:
        print(json.dumps(mesh_report(args.mesh)))
        return

    emit(functools.partial(bench_config, device=args.device), args)


if __name__ == "__main__":
    # the importable module's main: the ranks --mesh spawns find its
    # functions by name
    from gennbv_tpu_torch.bench import main as _main
    _main()
