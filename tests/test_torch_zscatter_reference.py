"""The benchmark's exact z-buffer reference env
(``benchmark/reference/env_zscatter.py``: the splat renderer's scatter-min
of the unquantized depths, its min-pool and the bf16 visibility in plain
PyTorch) against the port's splat env under ``zbuf_impl="scatter"`` on the
CPU, at a small size (4 envs, a 24x24 camera, R = 16, procedural houses,
the configuration's trained weights and random ones from a seed); the
cell's loop (``benchmark/loops/eval_zscatter.py``) and its faults
(``benchmark/faults_zscatter.py``); the frozen count of the scatter-min's
work (``benchmark/work/zbuf_scatter.py``); and the readers of the new
per-layer metrics on synthetic spans and records.

Tolerances: observations, rewards, done flags, coverage and each
episode's AUC are exact, since both sides project with the same float32
operations and the min, the pool and the bf16 read are exact.  The
reference policy's logits are held to the tiny cells' 1e-4 of the
largest logit (the cell on the card holds them to 2e-5)."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import collections

import pytest
import torch

from benchmark import faults, harness, run, trace, trained
from benchmark import faults_zscatter  # noqa: F401  (registers its faults)
from benchmark.reference import env as ref_env
from benchmark.reference import env_zscatter
from benchmark.tests import tiny
from benchmark.work import zbuf_scatter as work_zbuf_scatter
from gennbv_tpu_torch.utils import profiling

N, HW, RES = 4, 24, 16
WORKLOAD = "exact400.eval"


def _env_cfg(max_episode_length: int = 6) -> dict:
    cfg = tiny.tiny_cell(WORKLOAD).config["config"]
    env = cfg["env"]
    env.update(num_envs=N, max_episode_length=max_episode_length)
    env["camera"].update(height=HW, width=HW)
    env["renderer"]["resolution"] = RES
    return cfg


def _envs(max_episode_length: int = 6):
    """(the port's ReconEnv, the exact z-buffer reference Env) on the same
    four scenes of the cell's configuration, cut to the small size."""
    from gennbv_tpu_torch.env import ReconEnv
    cfg = _env_cfg(max_episode_length)
    env = cfg["env"]
    tensors = harness.to_device(harness.scene_arrays(env, N, 5), "cpu")
    port = ReconEnv(harness.port_config(cfg, 1).env,
                    harness.program_scenes(tensors, env))
    return port, env_zscatter.Env(env, tensors, RES)


def _actions(g: torch.Generator) -> torch.Tensor:
    return torch.stack([torch.randint(0, n, (N,), generator=g)
                        for n in ref_env.NVEC], -1)


def _ref_state(state) -> ref_env.State:
    """The port's env state as the reference's."""
    return ref_env.State(
        pose_buf=state.pose_buf, rgb_buf=state.rgb_buf,
        prob_grid=state.prob_grid, scanned_gt=state.scanned_gt,
        coverage=state.coverage, episode_len=state.episode_len,
        scene_id=state.scene_id, ep_reward=state.ep_reward)


def _assert_equal(po, ro):
    for name in ("obs", "reward", "done", "time_out", "coverage"):
        assert torch.equal(getattr(po, name), getattr(ro, name)), name


@pytest.mark.parametrize("start", ["fresh", "mid_episode"])
def test_env_steps_equal_the_programs(start):
    """From a reset, or from the port's own state four steps into an
    episode, every step's outputs are bit-equal (done envs auto-reset
    within the run: episodes of 6 steps); the program takes no init-view
    cache on this path, and neither does the reference."""
    port, ref = _envs()
    assert port._init_cache is None and ref.cache is None
    g = torch.Generator().manual_seed(7)
    sid = torch.arange(N)
    ps, po = port.reset(N, sid)
    if start == "fresh":
        rs, ro = ref.reset(sid)
        _assert_equal(po, ro)
    else:
        for _ in range(4):
            ps, po = port.step(ps, _actions(g))
        rs = _ref_state(ps)
    splatted, seen = 0, 0
    for _ in range(8):
        a = _actions(g)
        ps, po = port.step(ps, a)
        rs, ro = ref.step(rs, a)
        _assert_equal(po, ro)
        splatted += int(ro.n_valid.sum())
        seen += int((po.obs[:, 600:8600] > 0).sum())
    assert splatted > 0 and seen > 0   # points landed, voxels were marked


def test_the_exact_zbuffer_is_not_the_two_digit_one():
    """At the same poses the exact reference and the two-digit one
    (``env.py``) give other observations: the comparison would catch a
    program that ran the wrong z-buffer."""
    cfg = _env_cfg()["env"]
    tensors = harness.to_device(harness.scene_arrays(cfg, N, 5), "cpu")
    exact = env_zscatter.Env(cfg, tensors, RES)
    digits = ref_env.Env(dict(cfg, renderer=dict(cfg["renderer"],
                                                 zbuf_impl="mxu")),
                         tensors, RES)
    g = torch.Generator().manual_seed(3)
    sid = torch.arange(N)
    (es, eo), (ds, do) = exact.reset(sid), digits.reset(sid)
    differ = int((eo.obs != do.obs).sum())
    for _ in range(3):
        a = _actions(g)
        (es, eo), (ds, do) = exact.step(es, a), digits.step(ds, a)
        differ += int((eo.obs != do.obs).sum())
    assert differ > 0


@pytest.mark.parametrize("zbuf_impl", ["mxu", "pallas"])
def test_the_reference_refuses_the_two_digit_zbuffer(zbuf_impl):
    cell = harness.find_cell(harness.load_spec(), "ref400.eval")
    env = cell.config["config"]["env"]
    env = dict(env, renderer=dict(env["renderer"], zbuf_impl=zbuf_impl,
                                  resolution=RES))
    tensors = harness.to_device(harness.scene_arrays(env, 2, 0), "cpu")
    with pytest.raises(ValueError, match="scatter-min"):
        env_zscatter.Env(env, tensors, RES)
    scatter = dict(env, renderer=dict(env["renderer"], zbuf_impl="scatter"))
    for wrong in (dict(scatter, carve_mode="bresenham"),
                  dict(scatter, renderer=dict(scatter["renderer"],
                                              mode="dda"))):
        with pytest.raises(ValueError, match="scatter-min"):
            env_zscatter.Env(wrong, tensors, RES)


def _tiny_cell(camera: int = 16, grid_res: int = 16):
    cell = tiny.tiny_cell(WORKLOAD)
    env = cell.config["config"]["env"]
    env["camera"].update(height=camera, width=camera)
    env["renderer"]["resolution"] = grid_res
    cell.traffic["eval_env"].update(num_envs=N, max_episode_length=5)
    cell.traffic["eval_scenes"]["count"] = N
    return cell


@pytest.fixture
def random_weights(monkeypatch):
    """The trained weights file read as random weights from a seed."""
    def drawn(path, device):
        model = harness.find_cell(harness.load_spec(), WORKLOAD).config[
            "config"]["model"]
        return harness.weights(model, 11, device)
    monkeypatch.setattr(trained, "load", drawn)


@pytest.mark.parametrize("weights", ["trained", "random"])
def test_tiny_run_is_correct(request, weights):
    """The cell's loop on the CPU: ``evaluate``'s episodes held to the
    exact z-buffer reference (observations, per-env coverage and AUC, the
    means exact; logits), on the committed policy and on random weights."""
    if weights == "random":
        request.getfixturevalue("random_weights")
    res = run.run_cell(_tiny_cell(), 3, 0.05, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["checks"]["env_mismatches"]["value"] == 0
    assert res["checks"]["logit_gap"]["value"] < 1e-4
    assert res["metrics"] == {}        # no profile on the CPU: no reading


def test_the_loop_runs_the_exact_zbuffer_with_the_trained_policy():
    """The loop's env runs ``zbuf_impl="scatter"`` and its policy holds the
    committed weights, the same for every seed; its records give the
    scatter-min's shapes for each profiled env step, and no fused splat
    calls."""
    from benchmark.loops import eval_zscatter
    cell = _tiny_cell()
    want = trained.load(cell.config["weights"], "cpu")
    loop = eval_zscatter.Loop(cell, 3, "cpu")
    loop.setup(0.05)
    assert loop.env.cfg.renderer.zbuf_impl == "scatter"
    got = loop.policy.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    loop.window(0.05)
    loop.release()
    assert loop.check()["env_mismatches"] == 0
    loop.records["profile"] = trace.Profile(
        None, [trace.Span("k", 0, 1)], (0, 1), [], None)
    rec = loop.layer_records("cpu")
    assert "zbuf_calls" not in rec
    assert rec["zscatter_calls"] == [(N, loop.arrays["surf_pts"].shape[1],
                                      16, 16)] * (2 * 6)


@pytest.mark.parametrize("fault", sorted(faults.BY_LOOP["eval_zscatter"]))
def test_a_fault_makes_the_run_incorrect(fault):
    """Each fault is refused at a 200x200 camera over R = 64 scenes: there
    the trained policy's views put surface in the last tenth of the rows,
    and points within a bf16 rounding of the visibility's threshold (at
    16x16 over R = 16 those two faults move nothing; at the cell's size
    every fault is refused on every seed, PERF.md)."""
    cell = _tiny_cell(camera=200, grid_res=64)
    assert run.run_cell(cell, 3, 0.05, False, device="cpu")["correct"]
    with faults.BY_LOOP["eval_zscatter"][fault]():
        res = run.run_cell(cell, 3, 0.05, False, device="cpu")
    assert not res["correct"], res["checks"]


def test_the_limits_file_holds_the_cells_numbers():
    limits = harness.find_cell(harness.load_spec(), WORKLOAD).limits
    assert limits == {"env_mismatches": 0, "logit_gap": 2e-5}


# --- the scatter-min's work ----------------------------------------------

@pytest.mark.parametrize("n,q,h,w", [(50, 9216, 400, 400), (256, 11264, 128, 128),
                                     (3, 40, 16, 16)])
def test_the_work_count_equals_the_kernels_formula(n, q, h, w):
    """The frozen count equals the port's ``ops/zbuf_scatter.work``."""
    from gennbv_tpu_torch.ops import zbuf_scatter
    flat = torch.zeros(n, q, dtype=torch.int32)
    zz = torch.zeros(n, q)
    assert work_zbuf_scatter.work(n, q, h, w) == zbuf_scatter.work(
        flat, zz, h, w)


def test_the_roofline_share_lies_below_the_whole():
    """At the cell's shape the least time is the image's write and the
    points' read at the HBM peak: ~10.7 us, under the kernel's ~15 us."""
    least = work_zbuf_scatter.least_seconds(50, 9216, 400, 400, 67e12,
                                            3.35e12)
    assert least == pytest.approx((8 * 50 * 9216 + 4 * 50 * 160000) / 3.35e12)
    assert 1.0e-5 < least < 1.1e-5


# --- the readers of the new per-layer metrics ---------------------------

T = 1_700_000_000_000_000_000            # a Unix-epoch instant, ns
MS = 1_000_000


def _rec_and_spans():
    """A profiled window of 100 ms holding two scatter-min records (20 and
    30 us) and another kernel, and two eval episodes' spans of 0.2 and 0.4
    ms device time; a span of the same name outside the window (a later
    session) is not read."""
    rec = {"spans": [trace.Span("k", T, T + 100 * MS),
                     trace.Span("zbuf_scatter_min_kernel(int const*)",
                                T + MS, T + MS + 20_000),
                     trace.Span("zbuf_scatter_min_kernel(int const*)",
                                T + 50 * MS, T + 50 * MS + 30_000)],
           "window_ns": 100 * MS,
           "peaks": {"float32_flops": 8e9, "hbm_bytes_per_s": 1e9},
           "zscatter_calls": [(2, 100, 10, 10), (2, 100, 10, 10)]}

    def span(name, unit, start, took):
        return profiling.Span(0, name, None, unit, T + start * MS,
                              T + (start + 1) * MS, took)
    spans = [span("env/render/zbuf", 1, 1, 0.0002),
             span("env/render/zbuf", 2, 50, 0.0004),
             span("env/render/zbuf", 3, 60_000, 9.0),
             span("env/step", 1, 0, None)]
    return rec, spans


@pytest.mark.parametrize("name,want", [
    ("zscatter_ms.eval", 0.3),
    # least time a call: max(bytes 8 * 200 + 4 * 200 / 1e9, ops (400 +
    # 200) / 8e9) = 2.4e-6 s; two calls over the records' 50 us
    ("zscatter_roofline.eval", 100.0 * 2 * 2.4e-6 / 50e-6)])
def test_readers_read_the_spans_and_records(monkeypatch, name, want):
    rec, spans = _rec_and_spans()
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    got = harness.metric_reader(name).read(rec)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["zscatter_ms.eval",
                                  "zscatter_roofline.eval"])
def test_readers_give_nothing_where_the_program_has_nothing(monkeypatch,
                                                            name):
    """A program whose spans keep no device time or that records none, a
    profile without the kernel's records (another path), and a run
    without a profile read nothing."""
    rec, spans = _rec_and_spans()
    reader = harness.metric_reader(name)
    untimed = collections.namedtuple(      # a span without device time
        "Span", "id name parent unit start_ns end_ns")
    monkeypatch.setattr(profiling, "spans",
                        lambda: [untimed(*s[:6]) for s in spans])
    if name == "zscatter_ms.eval":
        assert reader.read(rec) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    if name == "zscatter_ms.eval":
        assert reader.read(rec) is None
    else:
        assert reader.read(dict(rec, spans=rec["spans"][:1])) is None
        assert reader.read(dict(rec, zscatter_calls=None)) is None
    assert reader.read({}) is None
