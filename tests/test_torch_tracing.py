"""The port's tracer (``gennbv_tpu_torch/utils/profiling.py``) on the CPU:
spans off by default and free of the profiler, nested with their parents
and units when on, on the profiler's clock; the Runner's, the rollout's,
the env step's and the eval's spans and counters; the kernels' launch
counts in the one counter store."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib
import json
import os
import time
from collections import deque

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch.algo import evaluation, runner
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.ops import kernels
from gennbv_tpu_torch.utils import profiling

NARROW = dict(pose_mlp_hidden=32, grid_channels=4, fused_dim=32)


def _since(t0: int, name: str | None = None) -> list:
    return [s for s in profiling.spans()
            if s.start_ns >= t0 and (name is None or s.name == name)]


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with tracing off")


def test_off_records_nothing_and_never_enters_record_function(monkeypatch):
    monkeypatch.setattr(profiling._profiler, "record_function", _raise)
    before = profiling.spans()
    off = profiling.span("off/a", unit=3)
    assert off is profiling.span("off/b")          # one shared no-op
    with off:
        with profiling.span("off/b"):
            pass
    # device-timed spans still time, and record no span either
    with profiling.span("off/timed", "off-unit", "cpu"):
        pass
    assert profiling.phases("off-unit").metrics()["time/off/timed"] >= 0
    assert profiling.spans() == before


def test_on_spans_nest_with_parents_and_units():
    t0 = time.time_ns()
    with profiling.tracing():
        with profiling.span("outer", unit=7):
            with profiling.span("mid"):
                with profiling.span("inner"):
                    pass
            with profiling.span("sibling", unit=9):
                pass
        with profiling.span("alone"):
            pass
    got = {s.name: s for s in _since(t0)}
    assert set(got) == {"outer", "mid", "inner", "sibling", "alone"}
    assert got["outer"].parent is None and got["alone"].parent is None
    assert got["mid"].parent == got["outer"].id
    assert got["inner"].parent == got["mid"].id
    assert got["sibling"].parent == got["outer"].id
    assert [got[n].unit for n in ("outer", "mid", "inner", "sibling")] == \
        [7, 7, 7, 9]
    assert got["alone"].unit is None
    for s in got.values():
        assert s.start_ns <= s.end_ns
    assert got["outer"].start_ns <= got["mid"].start_ns <= \
        got["inner"].end_ns <= got["mid"].end_ns <= got["outer"].end_ns


def test_ring_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", deque(maxlen=3))
    before = profiling.dropped()
    with profiling.tracing():
        for i in range(5):
            with profiling.span(f"ring/{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["ring/2", "ring/3",
                                                   "ring/4"]
    assert profiling.dropped() == before + 2


def test_a_span_lies_on_the_profilers_clock():
    """Under a CPU profile the span enters ``record_function``: its host
    record and the span's own stamps agree within 100 us (after a first
    span, which pays the profiler's set-up)."""
    t0 = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("clock/first"):
            pass
        with profiling.span("clock/check", unit="clock"):
            torch.randn(256, 256) @ torch.randn(256, 256)
    (mine,) = _since(t0, "clock/check")
    (record,) = [e for e in prof.profiler.kineto_results.events()
                 if e.name() == "clock/check"
                 and e.device_type() == DeviceType.CPU]
    assert abs(record.start_ns() - mine.start_ns) < 100_000
    assert abs(record.end_ns() - mine.end_ns) < 100_000
    assert mine.end_ns - mine.start_ns > 0


def test_kernel_launches_live_in_the_counter_store():
    kernels.reset_launches()
    assert kernels.launches() == dict.fromkeys(kernels.WRAPPERS, 0)
    profiling.count("kernel/gather_image/launches")
    profiling.count("kernel/zbuf_visible/launches", 2)
    assert kernels.launches() == {"gather_image": 1, "scatter_cells_any": 0,
                                  "zbuf_visible": 2, "zbuf_scatter_min": 0,
                                  "conv3d_wgrad": 0, "raymarch": 0,
                                  "bresenham": 0, "nn_min": 0}
    assert profiling.counters("kernel/")["kernel/zbuf_visible/launches"] == 2
    kernels.reset_launches()
    assert set(kernels.launches().values()) == {0}
    assert not any(hasattr(fn, "launches") for fn in kernels.WRAPPERS.values())


def _tiny_cfg(**runner_kw):
    return pt_config.Config(
        env=pt_config.EnvConfig(
            num_envs=4, camera=pt_config.CameraConfig(height=16, width=16),
            renderer=pt_config.RendererConfig(resolution=16),
            scene=pt_config.SceneConfig(num_scenes=2, seed=0),
            max_episode_length=4),
        model=pt_config.ModelConfig(**NARROW),
        ppo=pt_config.PPOConfig(n_steps=4, batch_size=8, n_epochs=1,
                                total_iters=2),
        runner=pt_config.RunnerConfig(**{"seed": 0, "save_freq": 0,
                                         **runner_kw}))


def test_runner_spans_counters_and_phases(tmp_path):
    cfg = _tiny_cfg()
    r = runner.Runner(cfg, log_dir=str(tmp_path / "run"), device="cpu")
    counts = profiling.counters()
    t0 = time.time_ns()
    with profiling.tracing():
        r.train(2)
    r.close()
    after = profiling.counters()
    n_steps = cfg.ppo.n_steps
    spans = _since(t0)
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == "env/step"]
    in_rollout = [s for s in steps if s.parent in by_id
                  and by_id[s.parent].name == "rollout/step"]
    assert len(in_rollout) == 2 * n_steps
    assert {s.unit for s in in_rollout} == {1, 2}
    # the call's reset is an env step of no iteration
    assert [s.unit for s in steps if s not in in_rollout] == [None]
    assert after["env/steps"] - counts.get("env/steps", 0) == len(steps)
    assert after["env/env_steps"] - counts.get("env/env_steps", 0) == \
        4 * len(steps)
    assert after["runner/iterations"] - counts.get("runner/iterations", 0) == 2
    for unit in (1, 2):
        names = {s.name for s in spans if s.unit == unit}
        assert {"runner/dispatch", "rollout", "gae", "update", "runner/keep",
                "runner/fetch", "runner/process", "rollout/step",
                "policy/act", "policy/forward", "env/step", "env/render",
                "env/map", "env/reward", "rollout/last_value"} <= names
        dispatch = [s for s in spans if s.unit == unit
                    and s.name == "runner/dispatch"]
        assert len(dispatch) == 1 and dispatch[0].parent is None
        for phase in ("rollout", "gae", "update", "runner/keep"):
            (s,) = [s for s in spans if s.unit == unit and s.name == phase]
            assert s.parent == dispatch[0].id
    # the update's minibatches: eager steps on the CPU, one forward each
    replays = after["update/replays"] - counts.get("update/replays", 0)
    assert replays > 0
    forwards = after["policy/forwards"] - counts.get("policy/forwards", 0)
    assert forwards == 2 * (n_steps + 1) + replays
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert len(logged) == 2
    for rec in logged:
        keys = [k for k in rec if k in ("time/rollout", "time/gae",
                                        "time/update")]
        assert keys == ["time/rollout", "time/gae", "time/update"]
        assert all(rec[k] > 0 for k in keys)


def test_runner_untraced_records_no_span_and_keeps_its_phases(tmp_path):
    r = runner.Runner(_tiny_cfg(), log_dir=str(tmp_path / "run"),
                      device="cpu")
    t0 = time.time_ns()
    metrics = r.train(2)
    r.close()
    assert _since(t0) == []
    for phase in ("rollout", "gae", "update"):
        assert metrics[f"time/{phase}"] > 0
    assert profiling.phases(1).metrics() == {}
    assert profiling.phases(2).metrics() == {}


def test_profile_dir_trace_holds_the_spans(tmp_path):
    d = tmp_path / "profile"
    r = runner.Runner(_tiny_cfg(profile_dir=str(d)),
                      log_dir=str(tmp_path / "run"), device="cpu")
    r.train(2)
    r.close()
    names = {e.get("name") for e in
             json.load(open(d / "trace.json"))["traceEvents"]}
    assert {"runner/dispatch", "rollout", "env/step", "env/render",
            "policy/forward"} <= names
    spans = [json.loads(line) for line in open(d / "spans.jsonl")]
    assert {s["unit"] for s in spans if s["name"] == "runner/dispatch"} == {2}


@pytest.mark.parametrize("episodes", [1, 2])
def test_eval_spans_per_episode(episodes):
    max_len = 3
    cfg = pt_config.EnvConfig(
        num_envs=3, max_episode_length=max_len,
        camera=pt_config.CameraConfig(height=16, width=16),
        renderer=pt_config.RendererConfig(resolution=16),
        scene=pt_config.SceneConfig(num_scenes=3, seed=1))
    env = ReconEnv(cfg, make_scenes(cfg.scene, 16, "cpu"))
    policy = ActorCriticPolicy(pt_config.ModelConfig(**NARROW), None, "cpu")
    counts = profiling.counters()
    t0 = time.time_ns()
    with profiling.tracing():
        for _ in range(episodes):
            evaluation.evaluate(env, policy, compute_accuracy=False)
    after = profiling.counters()
    spans = _since(t0)
    tops = [s for s in spans if s.name == "eval/episode"]
    assert len(tops) == episodes and len({s.unit for s in tops}) == episodes
    assert after["eval/episodes"] - counts.get("eval/episodes", 0) == episodes
    for top in tops:
        mine = [s for s in spans if s.unit == top.unit]
        names = [s.name for s in mine]
        assert names.count("env/step") == 1 + max_len
        assert names.count("policy/forward") == max_len
        assert names.count("eval/step") == max_len
        for one in ("eval/reset", "eval/fetch", "eval/results"):
            (s,) = [s for s in mine if s.name == one]
            assert s.parent == top.id
        assert all(top.start_ns <= s.start_ns and s.end_ns <= top.end_ns
                   for s in mine)
    assert after["env/steps"] - counts.get("env/steps", 0) == \
        episodes * (1 + max_len)
    assert after["policy/forwards"] - counts.get("policy/forwards", 0) == \
        episodes * max_len


def test_spans_write_out_only_when_asked(tmp_path):
    t0 = time.time_ns()
    with profiling.tracing():
        with profiling.span("write/me", unit=1):
            pass
    path = os.path.join(tmp_path, "spans.jsonl")
    profiling.write_spans(path, t0)
    (line,) = [json.loads(x) for x in open(path)]
    assert line["name"] == "write/me" and line["unit"] == 1


# --- the march's and the carve's spans and counters ----------------------

def test_a_count_made_on_the_device_is_summed_there_until_read():
    """``count`` of a tensor adds it to a sum held on its device, which
    ``counters`` reads once and folds into the host's count; a reset
    drops what was not read."""
    profiling.reset_counters("t/dev")
    profiling.count("t/dev/a", 2)
    profiling.count("t/dev/a", torch.tensor(3))
    profiling.count("t/dev/a", torch.tensor([True, False, True]).sum())
    assert isinstance(profiling._on_device["t/dev/a"], torch.Tensor)
    assert profiling.counters("t/dev") == {"t/dev/a": 7}
    assert "t/dev/a" not in profiling._on_device
    assert profiling.counters("t/dev") == {"t/dev/a": 7}
    profiling.count("t/dev/a", torch.tensor(5))
    profiling.reset_counters("t/dev")
    assert profiling.counters("t/dev") == {"t/dev/a": 0}


NEW_COUNTERS = ("raymarch/voxel_reads", "carve/bresenham_rays")


def _env(mode: str, carve_mode: str) -> ReconEnv:
    cfg = pt_config.EnvConfig(
        num_envs=3, max_episode_length=4, carve_mode=carve_mode,
        camera=pt_config.CameraConfig(height=16, width=16),
        renderer=pt_config.RendererConfig(mode=mode, resolution=16),
        scene=pt_config.SceneConfig(num_scenes=3, seed=1))
    return ReconEnv(cfg, make_scenes(cfg.scene, 16, "cpu"))


@pytest.mark.parametrize("mode,carve_mode", [
    ("dda", "bresenham"), ("dda", "ztest"), ("splat", "ztest")])
def test_an_env_step_names_its_march_and_its_carve(mode, carve_mode):
    """A traced step records ``env/map/carve`` inside ``env/map`` on every
    path and, on the "dda" path, ``env/render/raymarch`` inside
    ``env/render``, each with its seconds on the device (the host's on
    the CPU); off, neither records, and the spans are the shared no-op."""
    env = _env(mode, carve_mode)
    state = env.init_state(3)
    actions = env.init_action.expand(3, 6)
    t0 = time.time_ns()
    with profiling.tracing():
        env.step(state, actions)
    spans = _since(t0)
    by_id = {s.id: s for s in spans}
    want = {"env/map/carve": "env/map"}
    if mode == "dda":
        want["env/render/raymarch"] = "env/render"
    else:
        assert not [s for s in spans if s.name == "env/render/raymarch"]
    for name, parent in want.items():
        (s,) = [s for s in spans if s.name == name]
        assert by_id[s.parent].name == parent
        took = profiling.device_seconds(s)
        assert isinstance(took, float) and 0 < took <= \
            (s.end_ns - s.start_ns) / 1e9 + 1e-3
    assert profiling.device_seconds(by_id[s.parent]) is None
    t1 = time.time_ns()
    counts = profiling.counters()
    env.step(state, actions)
    assert _since(t1) == []
    assert {k: profiling.counters().get(k) for k in NEW_COUNTERS} == \
        {k: counts.get(k) for k in NEW_COUNTERS}
    assert profiling.device_span("off/a", "cpu") is profiling.span("off/b")


def _splat_env(zbuf_impl: str, max_episode_length: int = 4) -> ReconEnv:
    cfg = pt_config.EnvConfig(
        num_envs=3, max_episode_length=max_episode_length,
        camera=pt_config.CameraConfig(height=16, width=16),
        renderer=pt_config.RendererConfig(resolution=16, zbuf_impl=zbuf_impl),
        scene=pt_config.SceneConfig(num_scenes=3, seed=1))
    return ReconEnv(cfg, make_scenes(cfg.scene, 16, "cpu"))


@pytest.mark.parametrize("zbuf_impl", ["mxu", "pallas", "scatter"])
def test_the_exact_zbuffer_names_its_span(zbuf_impl):
    """A traced splat step records ``env/render/zbuf`` inside
    ``env/render`` under ``zbuf_impl="scatter"`` alone, with its seconds
    on the device (the host's on the CPU); the two-digit z-buffer never
    records it; untraced, no step records it."""
    env = _splat_env(zbuf_impl)
    state = env.init_state(3)
    actions = env.init_action.expand(3, 6)
    t0 = time.time_ns()
    with profiling.tracing():
        env.step(state, actions)
    spans = _since(t0)
    mine = [s for s in spans if s.name == "env/render/zbuf"]
    if zbuf_impl != "scatter":
        assert mine == []
    else:
        (s,) = mine
        assert {p.name for p in spans if p.id == s.parent} == {"env/render"}
        took = profiling.device_seconds(s)
        assert isinstance(took, float) and 0 < took <= \
            (s.end_ns - s.start_ns) / 1e9 + 1e-3
    t1 = time.time_ns()
    env.step(state, actions)
    assert _since(t1) == []


def _emulated_scatter_min(monkeypatch):
    """Sends the CPU's scatter-min calls through the card's wrapper
    (``zbuf_scatter.launch``: its counter and work count), with the
    kernel's launch emulated on the host: the minimum of the fill and the
    depths written through the output's pointer."""
    import ctypes
    from gennbv_tpu_torch.ops import _cuda, zbuf_scatter

    def launch(index, fn, flat_p, zz_p, out_p, n, q, hw, band_pixels, bands,
               ctas, fill):
        def at(p, ctype, count):
            return np.ctypeslib.as_array((ctype * count).from_address(p))
        img = np.full((n, hw), fill, np.float32)
        np.minimum.at(img, (np.repeat(np.arange(n), q),
                            at(flat_p, ctypes.c_int32, n * q)),
                      at(zz_p, ctypes.c_float, n * q))
        at(out_p, ctypes.c_float, n * hw)[:] = img.reshape(-1)
        return 0

    monkeypatch.setattr(_cuda, "launch", launch)
    monkeypatch.setattr(zbuf_scatter, "_launcher", lambda: None)
    monkeypatch.setattr(
        zbuf_scatter, "zbuf_scatter_min_ref",
        lambda flat, zz, h, w, fill: zbuf_scatter.launch(
            flat, zz, h, w, fill, zbuf_scatter.Geometry(h, 1, flat.shape[0])))


@pytest.mark.parametrize("zbuf_impl,want", [("mxu", 0), ("scatter", 31)])
def test_the_scatter_min_counts_a_launch_an_env_step(monkeypatch, zbuf_impl,
                                                     want):
    """``kernel/zbuf_scatter_min/launches`` counts one launch a batched env
    step under ``zbuf_impl="scatter"``, 31 an ``evaluate`` call at the
    eval's 30 steps (the reset's step included), and none on the
    two-digit path; the emulated launches give the plain version's
    episode."""
    env = _splat_env(zbuf_impl, max_episode_length=30)
    policy = ActorCriticPolicy(pt_config.ModelConfig(**NARROW), None, "cpu")
    plain = evaluation.evaluate(env, policy, compute_accuracy=False)
    _emulated_scatter_min(monkeypatch)
    kernels.reset_launches()
    got = evaluation.evaluate(env, policy, compute_accuracy=False)
    assert kernels.launches()["zbuf_scatter_min"] == want
    np.testing.assert_array_equal(got.per_env_coverage,
                                  plain.per_env_coverage)
    np.testing.assert_array_equal(got.per_env_auc, plain.per_env_auc)


def test_the_march_and_carve_counters_count_what_the_call_did():
    """``raymarch/voxel_reads``: the voxels the rays read, the
    benchmark's own march's count itself, kept on the device (the case's
    rays all end before the cap, so the loop exits early);
    ``carve/bresenham_rays``: the hit voxels, one ray each.  Off, they
    count nothing, and the CPU's loop launches no kernel."""
    from benchmark.reference import env_exact
    from gennbv_tpu_torch.ops import carve, render
    g = torch.Generator().manual_seed(3)
    r, cap = 16, 48
    occ = (torch.rand(2, r ** 3, generator=g) < 0.02).to(torch.uint8)
    lo, hi = torch.zeros(2, 3), torch.full((2, 3), 8.0)
    origin = torch.tensor([[-1.0, 4.0, 4.0], [4.0, 4.0, 9.0]])
    dirs = torch.randn(2, 300, 3, generator=g)
    _, _, reads = env_exact.march(occ, lo, hi, origin, dirs, r, cap, 50.0)
    most = int(reads.max())
    iterations = min(cap, 16 * -(-most // 16))
    hit = (torch.rand(2, 20, 20, 20, generator=g) < 0.01).float()
    src = torch.tensor([[-3, 5, 25], [10, 10, 10]], dtype=torch.int32)

    def call():
        render.raymarch(occ, lo, hi, origin, dirs, r, cap, 50.0)
        carve.carve_bresenham(hit, src, 20)

    before = profiling.counters()
    launched = kernels.launches()["raymarch"]
    with profiling.tracing():
        call()
    # the carve's and the march's reads stay sums on the device until
    # counters reads them
    assert "carve/bresenham_rays" in profiling._on_device
    assert "raymarch/voxel_reads" in profiling._on_device
    after = profiling.counters()
    assert {k: after[k] - before.get(k, 0) for k in NEW_COUNTERS} == {
        "raymarch/voxel_reads": int(reads.sum()),
        "carve/bresenham_rays": int(hit.sum())}
    assert 0 < iterations < cap and int(hit.sum()) > 0
    call()
    assert profiling.counters() == after
    assert kernels.launches()["raymarch"] == launched


@pytest.mark.parametrize("traced", [False, True])
def test_the_cpu_march_is_the_plain_loop(traced):
    """On the CPU ``raymarch`` is ``raymarch_ref``, bit for bit, and never
    counts a launch of the march's kernel, traced or not; the kernel's
    wrapper refuses a CPU tensor."""
    from gennbv_tpu_torch.ops import raymarch as march_kernel
    from gennbv_tpu_torch.ops import render
    g = torch.Generator().manual_seed(5)
    r = 8
    occ = (torch.rand(3, r ** 3, generator=g) < 0.05).to(torch.uint8)
    lo, hi = torch.zeros(3, 3), torch.full((3, 3), 4.0)
    origin = torch.tensor([[2.0, 2.0, 6.0], [-1.0, 1.0, 1.0], [2.0, 2.0, 2.0]])
    dirs = torch.randn(3, 50, 3, generator=g)
    args = (occ, lo, hi, origin, dirs, r, 3 * r, 20.0)
    before = kernels.launches()["raymarch"]
    with profiling.tracing() if traced else contextlib.nullcontext():
        depth, hit = render.raymarch(*args)
    want = render.raymarch_ref(*args)
    assert torch.equal(depth, want[0]) and torch.equal(hit, want[1])
    assert kernels.launches()["raymarch"] == before
    with pytest.raises(ValueError, match="CUDA"):
        march_kernel.raymarch(*args)


def test_the_march_kernels_work_count():
    """``ops/raymarch.work``: each grid once, 17 bytes a ray, 8 operations
    a voxel read; ``utils/work.counting`` is true only inside a
    WorkCounter, where the wrapper asks its kernel for the reads."""
    from gennbv_tpu_torch.ops import raymarch as march_kernel
    from gennbv_tpu_torch.utils import work
    occ = torch.zeros(3, 8 ** 3, dtype=torch.uint8)
    dirs = torch.zeros(3, 50, 3)
    assert march_kernel.work(occ, dirs, torch.tensor(1000)) == (
        3 * 512 + 17 * 150, 8 * 1000)
    assert not work.counting()
    with work.WorkCounter():
        assert work.counting()
    assert not work.counting()


# --- the report's accuracy path -------------------------------------------

def _report_env(max_len: int):
    cfg = pt_config.EnvConfig(
        num_envs=3, max_episode_length=max_len,
        camera=pt_config.CameraConfig(height=16, width=16),
        renderer=pt_config.RendererConfig(resolution=16),
        scene=pt_config.SceneConfig(num_scenes=3, seed=1))
    env = ReconEnv(cfg, make_scenes(cfg.scene, 16, "cpu"))
    torch.manual_seed(0)
    return env, ActorCriticPolicy(pt_config.ModelConfig(**NARROW), None,
                                  "cpu")


def test_the_report_names_its_scan_dedupe_and_passes(monkeypatch):
    """A traced ``evaluate(..., compute_accuracy=True)`` records
    ``eval/scan`` a view (the reset's and each step's), device-timed, and
    ``eval/accuracy`` inside ``eval/results`` around
    ``eval/accuracy/dedupe`` and the device-timed ``eval/accuracy/nn``;
    ``accuracy/scan_points`` counts the deduped points and
    ``accuracy/nn_pairs`` the pairs whose distances the passes
    computed."""
    from gennbv_tpu_torch.ops import chamfer
    max_len = 3
    env, policy = _report_env(max_len)
    scans, pairs = [], []
    dedupe, sq = evaluation.episode_scans, chamfer._sq_dists
    monkeypatch.setattr(evaluation, "episode_scans", lambda *a: (
        scans.append(dedupe(*a)), scans[-1])[1])
    monkeypatch.setattr(chamfer, "_sq_dists", lambda a, b: (
        pairs.append(sq(a, b)), pairs[-1])[1])
    counts = profiling.counters("accuracy/")
    t0 = time.time_ns()
    with profiling.tracing():
        evaluation.evaluate(env, policy, point_stride=2)
    after = profiling.counters("accuracy/")
    got = {}
    for s in _since(t0):
        got.setdefault(s.name, []).append(s)
    assert len(got["eval/scan"]) == 1 + max_len
    assert all(isinstance(s.took, float) for s in got["eval/scan"])
    (results,) = got["eval/results"]
    (acc,) = got["eval/accuracy"]
    (dedupe_span,) = got["eval/accuracy/dedupe"]
    (nn,) = got["eval/accuracy/nn"]
    assert acc.parent == results.id
    assert dedupe_span.parent == nn.parent == acc.id
    assert isinstance(nn.took, float) and dedupe_span.took is None
    assert {s.unit for ss in got.values() for s in ss} == {results.unit}
    (deduped,) = scans
    assert after["accuracy/scan_points"] - counts.get(
        "accuracy/scan_points", 0) == sum(map(len, deduped)) > 0
    assert after["accuracy/nn_pairs"] - counts.get(
        "accuracy/nn_pairs", 0) == sum(d.numel() for d in pairs) > 0


def test_the_report_untraced_records_nothing_and_gives_the_same_result():
    """Off, the report's spans record nothing; its result is bit for bit
    the traced one's."""
    env, policy = _report_env(3)
    before = profiling.spans()
    off = evaluation.evaluate(env, policy, point_stride=2)
    assert profiling.spans() == before
    with profiling.tracing():
        on = evaluation.evaluate(env, policy, point_stride=2)
    for name in off._fields:
        np.testing.assert_array_equal(getattr(on, name), getattr(off, name),
                                      err_msg=name)
    assert np.isfinite(off.mean_accuracy_cm)
