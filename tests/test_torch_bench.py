"""The port's bench (``gennbv_tpu_torch/bench.py``) against the JAX bench
(the root ``bench.py``) on the CPU: the roofline fields, the work counter's
FLOPs against XLA's cost analysis, the --mesh report's gradient traffic
against the JAX runner's parameters, the timeout-proof ``emit`` (the
cases of tests/test_bench_utils.py), the --smoke CLI, and each kernel's
``work`` against its hand formula at the eval's and the rollout's shapes."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from gennbv_tpu_torch import bench, spec
from gennbv_tpu_torch.models.encoder import HybridEncoder
from gennbv_tpu_torch.config import ModelConfig
from gennbv_tpu_torch.ops import fused_splat, gather, scatter, zbuf_scatter
from gennbv_tpu_torch.utils import device as device_lib
from gennbv_tpu_torch.utils.work import WorkCounter, count_kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = bench.card_peaks("NVIDIA H100 80GB HBM3")
F32_PEAKS = (H100.tflops["float32"], H100.hbm_gbps)
G = spec.GRID_SIZE


# ---- roofline ------------------------------------------------------------

@pytest.mark.parametrize("flops, nbytes, rate", [
    (1e12, 5e10, 0.25),          # the flagship iteration's order: latency
    (1e9, 1e9, 1.0),
    (1e9, 1e9, 100000.0),        # bandwidth
    (1e12, 1e6, 10.0),           # compute
    (0.0, 0.0, 3.0),
])
def test_roofline_matches_jax(monkeypatch, flops, nbytes, rate):
    """The port's fields and bound label equal the JAX bench's for the same
    flops, bytes, rate and peaks (the H100's float32 peak substituted into
    the JAX bench's device table)."""
    class Compiled:
        def cost_analysis(self):
            return {"flops": flops, "bytes accessed": nbytes}

    monkeypatch.setattr(jax_bench, "_device_peaks", lambda dev: F32_PEAKS)
    want = jax_bench.roofline(Compiled(), rate, None)
    assert bench.roofline(flops, nbytes, rate, F32_PEAKS) == want


def test_roofline_without_peaks_has_no_device_metric():
    out = bench.roofline(2e12, 3e9, 1.0, None)
    assert out == {"mfu": None, "hbm_util": None, "tflops_per_iter": 2.0,
                   "gbytes_per_iter": 3.0, "bound": None}


@pytest.mark.parametrize("name, tflops", [
    ("NVIDIA H100 80GB HBM3", 67.0), ("NVIDIA H100 PCIe", 51.0),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_card_peaks(name, tflops):
    peaks = bench.card_peaks(name)
    assert (None if peaks is None else peaks.tflops["float32"]) == tflops


def test_roofline_reads_the_float32_peak():
    """Counted work is read against the card's float32 peak, named in the
    line."""
    out = bench._roofline(bench.Work(67e12, 3350e9), 0.5, H100)
    assert out["mfu"] == 0.5 and out["hbm_util"] == 0.5
    assert out["peak"] == {"tflops": 67.0, "hbm_gbps": 3350.0,
                           "type": "float32"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_counter_raises_on_a_matmul_in_another_type(dtype):
    """A matmul outside float32 would be read against the wrong peak: the
    counter refuses it."""
    x = torch.zeros(4, 4, dtype=dtype)
    with pytest.raises(ValueError, match="float32 peak"):
        with WorkCounter():
            x @ x


# ---- the work counter ----------------------------------------------------

def _xla_flops(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return float(cost["flops"])


def _conv(stride):
    return lambda x, w: jax.lax.conv_general_dilated(
        x, w, (stride,) * 3, "VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


@pytest.mark.parametrize("layer", ["pose_fc1", "grid_conv1", "grid_conv2",
                                   "grid_fc"])
def test_counter_flops_equal_xla(layer):
    """One lone Linear or Conv3d of the encoder at its full width, a
    minibatch of 128 rows: the counter's FLOPs equal XLA's cost analysis
    of the same op in JAX exactly (a dot is 2mnk to both, a VALID
    convolution 2 x outputs x taps x input channels)."""
    enc = HybridEncoder(ModelConfig(), device="cpu")
    mod = getattr(enc, layer)
    b = 128
    if isinstance(mod, torch.nn.Linear):
        x = torch.zeros(b, mod.in_features)
        want = _xla_flops(lambda a, w: a @ w, jnp.zeros((b, mod.in_features)),
                          jnp.zeros((mod.in_features, mod.out_features)))
    else:
        side = G if layer == "grid_conv1" else (G - 3) // 2 + 1
        cin, cout = mod.in_channels, mod.out_channels
        x = torch.zeros(b, cin, side, side, side)
        want = _xla_flops(_conv(2), jnp.zeros((b, side, side, side, cin)),
                          jnp.zeros((3, 3, 3, cin, cout)))
    with WorkCounter() as w:
        mod(x)
    assert w.flops == want


def test_counter_bytes_are_inputs_and_outputs():
    """An op's bytes are its inputs' and outputs'; views and empty
    allocations move none."""
    x, y = torch.zeros(64, 32), torch.zeros(64, 32)
    with WorkCounter() as w:
        x.view(-1)
        x[:, :3]
        x.t()
        torch.empty(1000)
        x + y
    assert w.bytes == 3 * x.nbytes
    assert w.flops == 0.0


def _xla_unfused_bytes(fn, *args) -> float:
    """XLA's bytes accessed of `fn`'s HLO before fusion (fused, a gather
    counts its whole table: the fusion's operand)."""
    return float(jax.jit(fn).lower(*args).cost_analysis()["bytes accessed"])


def test_counter_gather_and_scatter_bytes_equal_xla():
    """Rows gathered from a large table (the update's minibatch from the
    rollout) and rows scattered into it count what XLA's cost analysis
    counts for a lone gather and scatter (twice the output and three times
    the updates, and the indices), not the whole table: within 1%, the
    share of XLA's own ops that wrap negative indices."""
    table = np.zeros((4096, 600), np.float32)
    rows = np.arange(0, 4096, 32, dtype=np.int32)
    upd = np.ones((len(rows), 600), np.float32)
    t, r = torch.from_numpy(table), torch.from_numpy(rows).long()
    with WorkCounter() as w:
        t[r]
    assert w.bytes == 2 * upd.nbytes + r.nbytes
    assert w.bytes == pytest.approx(
        _xla_unfused_bytes(lambda a, i: a[i], table, rows), rel=1e-2)
    with WorkCounter() as w:
        t.index_put_((r,), torch.from_numpy(upd))
    assert w.bytes == 3 * upd.nbytes + r.nbytes
    assert w.bytes == pytest.approx(_xla_unfused_bytes(
        lambda a, i, u: a.at[i].set(u), table, rows, upd), rel=1e-2)


def test_count_kernel_adds_work_outside_the_count():
    """A kernel's work() enters the counter once, and its own ops (the
    gather's unique) are not counted as the program's."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((2, 8, 8), dtype=np.float32))
    vi = torch.from_numpy(rng.integers(0, 8, (2, 16), dtype=np.int32))
    ui = torch.from_numpy(rng.integers(0, 8, (2, 16), dtype=np.int32))
    with WorkCounter() as w:
        count_kernel(gather.work, img, vi, ui)
    nbytes, ops = gather.work(img, vi, ui)
    assert w.bytes == nbytes
    assert w.flops == ops
    count_kernel(gather.work, img, vi, ui)     # no counter: nothing happens


def test_minibatch_step_work_is_one_replay():
    """One minibatch step counted eagerly (what the update's CUDA graph
    replays on the card) times the minibatches the update replays equals
    the matmul and convolution FLOPs of the CPU's eager update, and
    counting it leaves the runner's policy as it was."""
    runner = bench._make_runner(camera=16, num_envs=8, resolution=16,
                                n_steps=4, batch_size=16, device="cpu")
    env_state, obs = runner.setup()
    runner.train_iteration(env_state, obs)
    before = {k: v.clone() for k, v in runner.policy.state_dict().items()}
    step, replays = bench._minibatch_step_work(runner)
    for k, v in runner.policy.state_dict().items():
        assert torch.equal(v, before[k]), k
    _, update = bench._phase_fns(runner)
    upd = bench.Work.of(update)
    cfg = runner.cfg
    k_mb = cfg.ppo.n_epochs * cfg.ppo.n_steps * cfg.env.num_envs \
        // cfg.ppo.batch_size
    assert replays == k_mb
    assert upd.flops == pytest.approx(k_mb * step.flops, rel=1e-12)
    assert upd.nbytes > k_mb * step.nbytes


# ---- each kernel's work(...) against its hand formula --------------------

def _step(n: int, q: int, hw: int, seed: int):
    """Random step inputs: pixels, depths, a validity mask (70% valid),
    voxel cells, the pooled z-buffer and the carve's G^3 pixels."""
    rng = np.random.default_rng(seed)
    pix = lambda *s: torch.from_numpy(  # noqa: E731
        rng.integers(0, hw, s, dtype=np.int32))
    ok = torch.from_numpy(rng.random((n, q)) < 0.7)
    return {"vic": pix(n, q), "uic": pix(n, q),
            "z": torch.from_numpy(rng.random((n, q), dtype=np.float32)),
            "ok": ok, "veps": torch.full((n,), 0.1),
            "idx": torch.from_numpy(rng.integers(0, G, (n, q, 3),
                                                 dtype=np.int32)),
            "img": torch.from_numpy(rng.random((n, hw, hw), dtype=np.float32)),
            "cvi": pix(n, G ** 3), "cui": pix(n, G ** 3)}


@pytest.mark.parametrize("n, q, hw", [
    (spec.EVAL_NUM_ENVS, 9216, 400),     # the held-out eval at 400^2
    (256, 11264, 128),                   # the flagship rollout at 128^2
], ids=["eval", "rollout"])
@pytest.mark.parametrize("kernel", ["gather_image", "scatter_cells_any",
                                    "zbuf_visible", "zbuf_scatter_min"])
def test_work_equals_hand_formula(kernel, n, q, hw):
    """chip_smoke.py phase 3's bound formulas, written out by hand."""
    s = _step(n, q, hw, seed=q)
    nvalid = int(s["ok"].numpy().sum())
    if kernel == "gather_image":
        flat = (s["cvi"].numpy().astype(np.int64) * hw + s["cui"].numpy()
                + np.arange(n)[:, None] * hw * hw)
        m = G ** 3
        want = (4 * len(np.unique(flat)) + 12 * n * m, 2 * n * m)
        got = gather.work(s["img"], s["cvi"], s["cui"])
    elif kernel == "scatter_cells_any":
        want = (n * q + 12 * nvalid + 4 * n * G ** 3, 5 * nvalid)
        got = scatter.work(s["idx"], s["ok"], G)
    elif kernel == "zbuf_visible":
        want = (2 * n * q + 12 * nvalid + 4 * n + 4 * n * hw * hw,
                19 * nvalid + 16 * n * hw * hw)
        got = fused_splat.work(s["vic"], s["uic"], s["z"], s["ok"],
                               s["veps"], hw, hw)
    else:
        flat = s["vic"] * hw + s["uic"]
        want = (8 * n * q + 4 * n * hw * hw, 2 * n * q + n * hw * hw)
        got = zbuf_scatter.work(flat, s["z"], hw, hw)
    assert got == want


# ---- the --mesh report ---------------------------------------------------

def test_mesh_report_gradient_bytes_equal_jax_params():
    """--mesh 2 on two gloo ranks: the all-reduced gradient bytes of a
    minibatch equal the JAX runner's params bytes at the same reduced
    config (read from its train_state, no mesh compiled), and so do the
    minibatches an iteration."""
    rep = bench.mesh_report(2)
    runner = jax_bench._make_runner(camera=64, num_envs=8, resolution=32,
                                    n_steps=8, batch_size=4)
    params_bytes = sum(x.size * x.dtype.itemsize
                       for x in jax.tree.leaves(runner.train_state.params))
    cfg = runner.cfg
    n_mb = cfg.ppo.n_epochs * (cfg.ppo.n_steps * cfg.env.num_envs
                               // cfg.ppo.batch_size)
    assert rep["grad_allreduce_bytes_per_minibatch"] == params_bytes
    assert rep["params_bytes"] == params_bytes
    assert rep["minibatches_per_iter"] == n_mb
    assert rep["est_grad_allreduce_bytes_per_iter"] == params_bytes * n_mb
    assert rep["by_site"]["algo.ppo.reduce_step"]["count"] == n_mb
    assert rep["collective_bytes_static"] == sum(
        v["bytes"] for v in rep["collectives"].values())
    # the JAX report's keys
    assert set(rep) >= {"metric", "n_devices", "collectives",
                        "collective_bytes_static", "minibatches_per_iter",
                        "params_bytes", "est_grad_allreduce_bytes_per_iter",
                        "note"}


# ---- emit: tests/test_bench_utils.py's cases on the port ------------------

class _Recorder:
    """File-like stream that logs writes and flushes into a shared event
    log, so a test can order prints against bench legs."""

    def __init__(self, events):
        self.events = events
        self.lines = []

    def write(self, s):
        if s.strip():
            self.events.append(("print", s.strip()))
            self.lines.append(s.strip())

    def flush(self):
        self.events.append(("flush", None))


def _args(**kw):
    base = dict(iters=1, skip_400=False, budget_400=1500.0)
    base.update(kw)
    return argparse.Namespace(**base)


def _fake_bench(events, on_400=None):
    def fn(camera, iters, phases=True):
        events.append(("bench", camera))
        if camera == 400 and on_400 is not None:
            return on_400()
        return {"value": 1000.0 + camera, "camera": camera}
    return fn


def test_emit_headline_flushed_before_400_leg_starts():
    events = []
    out = _Recorder(events)
    bench.emit(_fake_bench(events), _args(), out=out)
    first_print = events.index(("print", out.lines[0]))
    leg_400 = events.index(("bench", 400))
    assert first_print < leg_400, "headline must be printed first"
    assert ("flush", None) in events[first_print:leg_400]
    assert len(out.lines) == 2
    head = json.loads(out.lines[0])
    assert head["value"] == 1128.0 and "camera400" not in head
    merged = json.loads(out.lines[1])
    assert merged["camera400"]["value"] == 1400.0
    assert merged["value"] == 1128.0


def test_emit_400_exception_degrades_to_error_field():
    events = []
    out = _Recorder(events)

    def boom():
        raise RuntimeError("card lost")

    bench.emit(_fake_bench(events, on_400=boom), _args(), out=out)
    assert json.loads(out.lines[0])["value"] == 1128.0
    assert "card lost" in json.loads(out.lines[1])["camera400"]["error"]


def test_emit_exhausted_budget_skips_400_leg():
    events = []
    out = _Recorder(events)
    bench.emit(_fake_bench(events), _args(budget_400=0.0), out=out)
    assert ("bench", 400) not in events
    assert "skipped" in json.loads(out.lines[1])["camera400"]


def test_emit_sigalrm_aborts_overlong_400_leg(monkeypatch):
    events = []
    out = _Recorder(events)

    def slow():
        time.sleep(30)  # would blow the budget; the alarm must cut it
        return {"value": -1.0}

    # lower the start-worthiness floor so the 1 s budget reaches the
    # alarm path instead of the early skip
    monkeypatch.setattr(bench, "MIN_400_BUDGET", 0.0)
    t0 = time.perf_counter()
    bench.emit(_fake_bench(events, on_400=slow), _args(budget_400=1.0),
               out=out)
    assert time.perf_counter() - t0 < 10, "alarm did not fire"
    assert ("bench", 400) in events
    assert json.loads(out.lines[0])["value"] == 1128.0
    assert "skipped" in json.loads(out.lines[1])["camera400"]


def test_emit_skip_400_prints_single_headline():
    events = []
    out = _Recorder(events)
    bench.emit(_fake_bench(events), _args(skip_400=True), out=out)
    assert len(out.lines) == 1
    assert json.loads(out.lines[0])["value"] == 1128.0


# ---- the CLI ---------------------------------------------------------------

# the JAX --smoke line's keys (bench.py's bench_config and main)
JAX_SMOKE_KEYS = {"metric", "value", "camera", "iter_seconds", "mfu",
                  "hbm_util", "tflops_per_iter", "gbytes_per_iter", "bound",
                  "phases"}
PORT_KEYS = {"iter_spacing_seconds", "peak", "minibatches_applied_per_iter",
             "kernel_launches", "setup_seconds", "device"}
KERNELS = {"gather_image", "scatter_cells_any", "zbuf_visible",
           "zbuf_scatter_min", "conv3d_wgrad", "raymarch"}


def test_smoke_cli_on_the_cpu():
    """``python -m gennbv_tpu_torch.bench --smoke --device cpu``: one JSON
    line with the JAX --smoke line's keys and the port's additions, the
    CPU's utilizations null (no device metric from a CPU run)."""
    res = subprocess.run(
        [sys.executable, "-m", "gennbv_tpu_torch.bench", "--smoke",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(line) == JAX_SMOKE_KEYS | PORT_KEYS
    assert line["metric"] == "smoke" and line["camera"] == 16
    assert line["value"] > 0
    assert line["mfu"] is None and line["hbm_util"] is None
    assert line["tflops_per_iter"] > 0 and line["gbytes_per_iter"] > 0
    assert set(line["phases"]) == {"rollout", "update", "env_step"}
    for phase in line["phases"].values():
        assert phase["seconds"] > 0 and phase["gbytes_per_iter"] > 0
    assert line["kernel_launches"] == dict.fromkeys(KERNELS, 0)
    assert line["device"] == {"name": "cpu", "power_limit": None}
    spread = line["iter_spacing_seconds"]
    assert spread["n"] == 2 and spread["min"] <= spread["median"] \
        <= spread["max"]


def test_cuda_without_a_card_raises():
    """--device cuda never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        bench.bench_config(camera=16, iters=1)


def test_card_splits_nvidia_smi_line(monkeypatch):
    monkeypatch.setattr(device_lib, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert device_lib.card() == {"name": "NVIDIA H100 80GB HBM3",
                                 "power_limit": "700.00 W"}
