"""The benchmark's exact reference env (``benchmark/reference/env_exact.py``:
the DDA ray march, the back-projected hits and the Bresenham or z-test
carve in plain PyTorch) against the port's "dda" env path on the CPU, at a
small size (4 envs, a 24x24 camera, R = 16, procedural houses, the
configuration's trained weights); the cell's loop
(``benchmark/loops/eval_exact.py``), its trained policy's file
(``benchmark/trained.py``) and its faults; the frozen count of the march's work
(``benchmark/work/raymarch.py``); and the readers of the new per-layer
metrics on synthetic spans.

Tolerances: observations, rewards, done flags, coverage and each
episode's AUC are exact, since the march, the hits and Bresenham are
integer or explicitly rounded and both sides run the same float32
operations at those points.  The reference policy's logits on the same
observations are held to 1e-5 of the largest logit: its layers are the
port's as plain modules, whose matmuls may sum in another order, the
float32 rounding of a 256-wide dot product (the cell on the card holds
them to 2e-5)."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import collections
import math

import numpy as np
import pytest
import torch

from benchmark import faults, harness, run
from benchmark import faults_exact  # noqa: F401  (registers its faults)
from benchmark.reference import env_exact
from benchmark.reference import env as ref_env
from benchmark.reference import policy as ref_policy
from benchmark.tests import tiny
from benchmark.work import raymarch as work_raymarch
from gennbv_tpu_torch.utils import profiling

N, HW, RES = 4, 24, 16
WORKLOAD = "dda400.eval"


def _envs(carve_mode: str, max_episode_length: int = 6):
    """(the port's ReconEnv, the exact reference Env) on the same four
    scenes of the cell's configuration, cut to the small size."""
    from gennbv_tpu_torch.env import ReconEnv
    cfg = tiny.tiny_cell(WORKLOAD).config["config"]
    env = cfg["env"]
    env.update(num_envs=N, carve_mode=carve_mode,
               max_episode_length=max_episode_length)
    env["camera"].update(height=HW, width=HW)
    env["renderer"]["resolution"] = RES
    tensors = harness.to_device(harness.scene_arrays(env, N, 5), "cpu")
    port = ReconEnv(harness.port_config(cfg, 1).env,
                    harness.program_scenes(tensors, env))
    return port, env_exact.Env(env, tensors, RES)


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
@pytest.mark.parametrize("carve_mode", ["bresenham", "ztest"])
def test_env_steps_equal_the_programs(carve_mode, start):
    """From a reset, or from the port's own state four steps into an
    episode, every step's outputs are bit-equal (done envs auto-reset
    within the run: episodes of 6 steps)."""
    port, ref = _envs(carve_mode)
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
    carved = 0
    for _ in range(8):
        a = _actions(g)
        ps, po = port.step(ps, a)
        rs, ro = ref.step(rs, a)
        _assert_equal(po, ro)
        carved += int((po.obs[:, 600:8600] < 0).sum())
    assert carved > 0                  # the carve marked free voxels
    assert all(m[0] > 0 for m in ref.marched)


def test_the_reference_refuses_a_splat_configuration():
    cell = harness.find_cell(harness.load_spec(), "ref400.eval")
    env = cell.config["config"]["env"]
    tensors = harness.to_device(harness.scene_arrays(
        dict(env, renderer=dict(env["renderer"], resolution=RES)), 2, 0), "cpu")
    with pytest.raises(ValueError, match="DDA ray march"):
        env_exact.Env(env, tensors, RES)
    with pytest.raises(ValueError, match="carve"):
        env_exact.Env(dict(env, renderer=dict(env["renderer"], mode="dda"),
                           carve_mode="other"), tensors, RES)


def _tiny_cell():
    cell = tiny.tiny_cell(WORKLOAD)
    cell.traffic["eval_env"].update(num_envs=4, max_episode_length=5)
    cell.traffic["eval_scenes"]["count"] = 4
    return cell


def test_the_episodes_take_the_trained_policys_mode():
    """The loop's policy holds the configuration's trained weights, the
    same for every seed, and each step's actions are the mode of its
    logits (the protocol's deterministic episodes): every episode of a
    run takes the same actions.  The policy keeps its mode across an
    episode."""
    from benchmark import trained
    from benchmark.loops import eval_exact
    cell = _tiny_cell()
    want = trained.load(cell.config["weights"], "cpu")
    loop = eval_exact.Loop(cell, 3, "cpu")
    loop.setup(0.05)
    got = loop.policy.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(loop.weights[k], want[k]) for k in want)
    logits, actions = [], []
    hook = loop.policy.register_forward_hook(
        lambda m, i, out: logits.append(out.logits))
    step = loop.env.step
    loop.env.step = lambda state, a: (actions.append(a), step(state, a))[1]
    was_training = loop.policy.training
    loop._episode()
    loop._episode()
    hook.remove()
    t_max = len(logits) // 2
    # the reset's own step (the initial pose) leads each episode
    assert len(actions) == 2 * (t_max + 1)
    actions = actions[1:t_max + 1] + actions[t_max + 2:]
    assert loop.policy.training == was_training
    assert all(torch.equal(a, ref_policy.mode(lg))
               for a, lg in zip(actions, logits))
    assert all(torch.equal(a, b) for a, b in zip(actions[:t_max],
                                                 actions[t_max:]))
    other = eval_exact.Loop(_tiny_cell(), 4, "cpu")
    other.setup(0.05)
    assert all(torch.equal(other.weights[k], want[k]) for k in want)


def test_the_trained_policy_file_holds_the_policys_state_dict():
    """The configuration's weights file holds every tensor of the
    policy's state_dict at its shape and dtype, finite, and reads back
    bit for bit through ``trained.dump``."""
    from benchmark import trained
    cell = _tiny_cell()
    held = trained.load(cell.config["weights"], "cpu")
    shapes = ref_policy.Policy(cell.config["config"]["model"],
                               "meta").state_dict()
    assert held.keys() == shapes.keys()
    for k, v in shapes.items():
        assert held[k].shape == v.shape and held[k].dtype == v.dtype, k
        assert torch.isfinite(held[k].double()).all(), k


def test_a_state_dict_reads_back_bit_for_bit(tmp_path):
    from benchmark import trained
    sd = harness.weights(_tiny_cell().config["config"]["model"], 5, "cpu")
    sd["encoder.x"] = torch.tensor([1.0, -0.0, 3e-41, float("inf")])
    path = tmp_path / "w.json"
    trained.dump(sd, str(path), {"about": 1})
    back = trained.load(str(path), "cpu")
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        got = back[k]
        assert got.dtype == v.dtype and got.shape == v.shape
        if v.is_floating_point():     # the bits: -0.0, subnormals, inf
            got, v = got.view(torch.int32), v.view(torch.int32)
        assert torch.equal(got, v), k


def test_tiny_run_is_correct_and_counts_the_march():
    """The cell's loop on the CPU: ``evaluate``'s episodes held to the
    exact reference (observations, per-env coverage and AUC, the means;
    logits), and the march's work kept for each step of one episode."""
    from benchmark.loops import eval_exact
    res = run.run_cell(_tiny_cell(), 3, 0.05, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["checks"]["env_mismatches"]["value"] == 0
    assert res["metrics"] == {}        # no profile on the CPU: no reading
    loop = eval_exact.Loop(_tiny_cell(), 3, "cpu")
    loop.setup(0.05)
    loop.window(0.05)
    loop.release()
    assert loop.check()["env_mismatches"] == 0
    assert len(loop.marched) == 6 and all(m[1] == 4 * 16 * 16 and m[2] == 4
                                          for m in loop.marched)
    rec = loop.layer_records("cpu")
    assert "zbuf_calls" not in rec and "raymarch_calls" not in rec


@pytest.mark.parametrize("fault", ["march_dropped", "carve_dropped",
                                   "march_depth_ulp", "state_unchanged",
                                   "logit_altered"])
def test_a_fault_makes_the_run_incorrect(fault):
    with faults.BY_LOOP["eval_exact"][fault]():
        res = run.run_cell(_tiny_cell(), 3, 0.05, False, device="cpu")
    assert not res["correct"], res["checks"]


# --- the march's work ---------------------------------------------------

def _brute_reads(occ, lo, hi, origin, direction, r, max_steps):
    """One ray's voxel reads by the textbook loop in float64: the entry
    voxel, then a voxel a crossing, until a solid one or the box's end."""
    o, d = np.array(origin, float), np.array(direction, float)
    lo, hi = np.array(lo, float), np.array(hi, float)
    size = (hi - lo) / r
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0, 1.0 / d, np.inf)
        ta, tb = (lo - o) * inv, (hi - o) * inv
    ta, tb = np.nan_to_num(ta, nan=-np.inf), np.nan_to_num(tb, nan=np.inf)
    t_in, t_out = np.minimum(ta, tb).max(), np.maximum(ta, tb).min()
    t = max(t_in, 1e-3)
    if t_out <= t:
        return 0
    cell = np.clip(np.floor((o + d * (t + 1e-5) - lo) / size), 0, r - 1)
    cell = cell.astype(int)
    step = np.where(d >= 0, 1, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_cross = np.where(d != 0, (lo + (cell + (step > 0)) * size - o) * inv,
                           np.inf)
        t_delta = np.where(d != 0, size * np.abs(inv), np.inf)
    reads = 0
    while reads < max_steps:
        reads += 1
        if occ[tuple(cell)]:
            return reads
        axis = int(np.argmin(t_cross))
        cell[axis] += step[axis]
        t_cross[axis] += t_delta[axis]
        if not 0 <= cell[axis] < r:
            return reads
    return reads


RAYS = [  # (origin, direction): along an axis, diagonals, a miss, a hit
    ((-1.0, 0.5, 0.5), (1.0, 0.0, 0.0)),
    ((0.5, -1.0, 0.5), (0.0, 1.0, 0.0)),
    ((0.5, 0.5, 9.0), (0.0, 0.0, -1.0)),
    ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),      # x, y, z on ties: hits
    ((9.0, -1.0, 0.25), (-1.0, 1.0, 0.0)),
    ((-1.0, 9.0, 0.25), (0.0, 0.0, 1.0)),        # passes beside the box
    ((-1.0, 3.5, 3.5), (1.0, 0.0, 0.0)),         # hits the solid block
    ((3.5, 3.5, 3.5), (1.0, 0.5, 0.25)),         # starts inside the block
]


def test_march_reads_equal_a_brute_force_count():
    """The reference march's reads on hand-built rays through an 8^3 grid
    over [0, 8]^3 with a solid 2^3 block at (3, 3, 3) equal the textbook
    loop's, and the work formula counts them."""
    r = 8
    occ = np.zeros((r, r, r), bool)
    occ[3:5, 3:5, 3:5] = True
    lo, hi = (0.0, 0.0, 0.0), (8.0, 8.0, 8.0)
    want = [_brute_reads(occ, lo, hi, o, d, r, 3 * r) for o, d in RAYS]
    assert want == [8, 8, 8, 10, 15, 0, 4, 1]
    origins = torch.tensor([o for o, _ in RAYS])
    dirs = torch.tensor([d for _, d in RAYS])
    depth, hit, reads = env_exact.march(
        torch.from_numpy(occ.reshape(1, -1)).expand(len(RAYS), -1),
        torch.zeros(len(RAYS), 3), torch.full((len(RAYS), 3), 8.0), origins,
        dirs[:, None], r, 3 * r, 50.0)
    assert reads[:, 0].tolist() == want
    assert hit[:, 0].tolist() == [False, False, False, True, False, False,
                                  True, True]
    assert depth[3, 0] == depth[6, 0] == 4.0
    assert work_raymarch.work(sum(want), len(RAYS), 1, r) == (
        r ** 3 + len(RAYS) * 5, 8 * sum(want))
    least = work_raymarch.least_seconds(sum(want), len(RAYS), 1, r, 8.0, 1.0)
    assert least == max((r ** 3 + 40) / 1.0, 8 * sum(want) / 8.0)


def test_reads_never_reach_the_cap():
    """A ray reads at most 3R - 2 voxels (its path between opposite
    corners), so a march of 3R steps never stops a ray early."""
    r = 8
    occ = torch.zeros(1, r ** 3)
    g = torch.Generator().manual_seed(0)
    dirs = torch.randn(1, 4096, 3, generator=g)
    _, _, reads = env_exact.march(occ, torch.zeros(1, 3),
                                  torch.full((1, 3), 8.0),
                                  torch.tensor([[-0.5, -0.25, -0.125]]),
                                  dirs.abs(), r, 3 * r, 50.0)
    assert 0 < int(reads.max()) <= 3 * r - 2


# --- the readers of the new per-layer metrics ---------------------------

T = 1_700_000_000_000_000_000            # a Unix-epoch instant, ns
MS = 1_000_000


def _rec_and_spans():
    """A profiled window of 100 ms and two eval episodes' spans: marches
    of 20 and 30 ms device time, carves of 2 and 4 ms; a span of the same
    name outside the window (a later session) is not read."""
    from benchmark import trace
    rec = {"spans": [trace.Span("k", T, T + 100 * MS)], "window_ns": 100 * MS,
           "peaks": {"float32_flops": 8e9, "hbm_bytes_per_s": 1e9},
           "raymarch_calls": [(1000, 100, 1, 8), (3000, 100, 1, 8)]}

    def span(name, unit, start, took):
        return profiling.Span(0, name, None, unit, T + start * MS,
                              T + (start + 1) * MS, took)
    spans = [span("env/render/raymarch", 1, 1, 0.020),
             span("env/map/carve", 1, 2, 0.002),
             span("env/render/raymarch", 2, 50, 0.030),
             span("env/map/carve", 2, 51, 0.004),
             span("env/render/raymarch", 3, 60_000, 9.0),
             span("env/step", 1, 0, None)]
    return rec, spans


@pytest.mark.parametrize("name,want", [
    ("raymarch_ms.eval", 25.0), ("carve_ms.eval", 3.0),
    # least time a call: max(bytes (512 + 500) / 1e9, ops 8 * reads /
    # 8e9), 1.012e-6 and 3e-6 s, over the marches' mean 25 ms
    ("raymarch_roofline.eval", 100.0 * (1.012e-6 + 3e-6) / 2 / 0.025)])
def test_readers_read_the_spans_device_time(monkeypatch, name, want):
    rec, spans = _rec_and_spans()
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    got = harness.metric_reader(name).read(rec)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["raymarch_ms.eval", "carve_ms.eval",
                                  "raymarch_roofline.eval"])
def test_readers_give_nothing_without_device_timed_spans(monkeypatch, name):
    """A program whose spans keep no device time (the parent of these
    spans) or that records none, and a run without a profile, read
    nothing."""
    rec, spans = _rec_and_spans()
    reader = harness.metric_reader(name)
    untimed = collections.namedtuple(      # a span as it was before
        "Span", "id name parent unit start_ns end_ns")
    monkeypatch.setattr(profiling, "spans",
                        lambda: [untimed(*s[:6]) for s in spans])
    assert reader.read(rec) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read(rec) is None
    assert reader.read({}) is None


def test_the_roofline_share_lies_below_the_whole():
    """At the cell's size the least time of a march is far below its
    device time: 8.0M rays of up to 192 reads cannot take under the
    bound's time."""
    rays = 50 * 400 * 400
    least = work_raymarch.least_seconds(rays * 192, rays, 50, 64, 67e12,
                                        3.35e12)
    assert least == pytest.approx(8 * rays * 192 / 67e12)
    assert least < 0.003 and math.isfinite(least)
