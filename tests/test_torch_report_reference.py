"""The report's accuracy reference (``benchmark/reference/accuracy.py``:
the strided scan by the plain DDA march and back-projection, the 1 cm
dedupe and float64 brute-force nearest neighbours) against the port's
``evaluate(..., compute_accuracy=True)`` on the CPU, at a small size (4
envs, a 32x32 camera, R = 16, procedural houses, the scan at strides 2
and 4, the configuration's trained weights and random ones from a seed);
the cell's loop (``benchmark/loops/eval_report.py``) and its faults
(``benchmark/faults_report.py``); the frozen count of the passes' work
(``benchmark/work/chamfer.py``); and the readers of the new per-layer
metrics on synthetic spans.

Tolerances: the scan's points and masks are exact, since the march is
integer or explicitly rounded and both sides run the same float32
operations on its depth.  The six accuracy numbers are held to the cell's
``accuracy_gap`` limit: the program's minima are float32 and its means
float32 sums, the reference's float64, a relative gap of ~1e-7."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import collections
import json

import numpy as np
import pytest
import torch

from benchmark import faults, harness, run, trained
from benchmark import faults_report  # noqa: F401  (registers its faults)
from benchmark.reference import accuracy as ref_accuracy
from benchmark.reference import env as ref_env
from benchmark.tests import tiny
from benchmark.work import chamfer as work_chamfer
from gennbv_tpu_torch.algo import evaluation
from gennbv_tpu_torch.ops import chamfer
from gennbv_tpu_torch.utils import profiling

N, HW, RES, T_MAX = 4, 32, 16, 6
WORKLOAD = "ref400.report"
LIMITS = harness.find_cell(harness.load_spec(), WORKLOAD).limits


def _tiny_cell(stride: int = 4):
    """The cell at the small size, held to tiny.LIMITS and the cell's own
    limits of the scan and the accuracy."""
    cell = tiny.tiny_cell(WORKLOAD)
    cell.config["config"]["env"]["camera"].update(height=HW, width=HW)
    cell.traffic["eval_env"].update(num_envs=N, max_episode_length=T_MAX)
    cell.traffic["eval_scenes"]["count"] = N
    cell.traffic["point_stride"] = stride
    return cell._replace(limits=dict(
        cell.limits, scan_mismatches=LIMITS["scan_mismatches"],
        accuracy_gap=LIMITS["accuracy_gap"]))


@pytest.fixture
def random_weights(monkeypatch):
    """The trained weights file read as random weights from a seed."""
    def drawn(path, device):
        model = harness.find_cell(harness.load_spec(), WORKLOAD).config[
            "config"]["model"]
        return harness.weights(model, 11, device)
    monkeypatch.setattr(trained, "load", drawn)


def _run(cell, traced=False):
    return run.run_cell(cell, 3, 0.05, traced, device="cpu")


@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("weights", ["trained", "random"])
def test_tiny_run_is_correct(request, stride, weights):
    """The loop's episodes with the accuracy path held to the reference:
    every view's scan exact, the six numbers within the limit."""
    if weights == "random":
        request.getfixturevalue("random_weights")
    res = _run(_tiny_cell(stride))
    assert res["correct"], res["checks"]
    assert res["checks"]["scan_mismatches"]["value"] == 0
    assert res["checks"]["accuracy_gap"]["value"] < 1e-6


@pytest.mark.parametrize("fault", sorted(faults_report.REPORT))
def test_a_fault_makes_the_run_incorrect(fault):
    with faults.BY_LOOP["eval_report"][fault]():
        res = _run(_tiny_cell())
    assert not res["correct"], res["checks"]


def test_the_loop_refuses_a_configuration_without_weights():
    from benchmark.loops import eval_report
    cell = _tiny_cell()
    del cell.config["weights"]
    with pytest.raises(ValueError, match="weights"):
        eval_report.Loop(cell, 3, "cpu").setup(0.05)


def test_the_loop_keeps_the_checked_episodes_scans():
    """Each result carries its episode's scans; the window keeps those of
    its checked episodes, and the reference's point counts are kept for
    the passes' work."""
    from benchmark.loops import eval_report
    loop = eval_report.Loop(_tiny_cell(), 3, "cpu")
    loop.setup(0.05)
    loop.window(0.05)
    loop.release()
    for *_, result in loop.checked:
        ep = result.episodes
        assert isinstance(result, evaluation.EvalResult)
        assert ep.scan_pts.shape == (T_MAX + 1, N, (HW // 4) ** 2, 3)
        assert ep.scan_valid.shape == ep.scan_pts.shape[:-1]
    numbers = loop.check()
    assert numbers["scan_mismatches"] == 0
    assert len(loop.nn_counts) == N
    assert all(s > 0 and g > 0 for s, g in loop.nn_counts)


# --- the reference against the program, piece by piece -------------------

def _port_env(max_episode_length: int = T_MAX):
    from gennbv_tpu_torch.env import ReconEnv
    cell = _tiny_cell()
    cfg = cell.config["config"]
    env = cfg["env"]
    env.update(num_envs=N, max_episode_length=max_episode_length)
    env["renderer"]["resolution"] = RES
    tensors = harness.to_device(harness.scene_arrays(env, N, 5), "cpu")
    return ReconEnv(harness.port_config(cfg, 1).env,
                    harness.program_scenes(tensors, env)), tensors, env


@pytest.mark.parametrize("stride", [2, 4])
def test_the_scan_equals_the_programs(stride):
    """Views from random actions, envs fresh after a collision or a
    timeout among them: the program's scan points and masks equal the
    reference's at the poses it decodes from the same actions."""
    port, scenes, env = _port_env(max_episode_length=3)
    cam = env["camera"]
    rays = torch.from_numpy(ref_accuracy.scan_rays(
        HW, HW, cam["horizontal_fov_deg"], stride))
    sub = evaluation.scan_rays(port, stride)
    assert torch.equal(sub, rays)
    g = torch.Generator().manual_seed(7)
    state, _ = port.reset(N, torch.arange(N))
    fresh = seen = 0
    for _ in range(8):
        actions = torch.stack([torch.randint(0, n, (N,), generator=g)
                               for n in ref_env.NVEC], -1)
        pts, valid = evaluation.scan_points(
            port, state.scene_id, evaluation.step_poses(port, state, actions),
            sub)
        want_pts, want_valid = ref_accuracy.scan(
            scenes, state.scene_id,
            ref_accuracy.view_poses(state.episode_len, actions), rays, RES,
            cam)
        assert torch.equal(pts, want_pts) and torch.equal(valid, want_valid)
        fresh += int((state.episode_len == 0).sum())
        seen += int(valid.sum())
        state, _ = port.step(state, actions)
    assert fresh > 0 and seen > 0
    # the reset's forced view: the init pose, rounded apart
    init = evaluation.init_pose(port).expand(N, -1)
    assert torch.equal(init, ref_accuracy.view_poses(
        torch.zeros(N, dtype=torch.int32), torch.zeros(N, 6, dtype=torch.int32)))


def test_the_dedupe_equals_the_programs():
    """Each env's points of the views up to its first done, rounded to
    1 cm and deduplicated, as the program's ``episode_scans``."""
    rng = np.random.default_rng(0)
    pts = np.round(rng.normal(size=(5, 3, 40, 3)), 3).astype(np.float32)
    valid = rng.random((5, 3, 40)) < 0.7
    dones = np.zeros((4, 3), bool)
    dones[1, 0] = dones[3, 1] = True            # env 2 runs out its time
    want = evaluation.episode_scans(pts, valid,
                                    evaluation.before_done_mask(dones))
    got = ref_accuracy.dedupe(pts, valid, dones)
    assert [len(p) for p in got] == [len(p) for p in want]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert len(got[0]) < len(got[2])


@pytest.mark.parametrize("exclude_self", [False, True])
def test_nearest_neighbours_equal_a_brute_force(monkeypatch, exclude_self):
    """Chunked as the card's memory asks (a chunk of 7 rows here), the
    minima equal numpy's over every pair in float64."""
    monkeypatch.setattr(ref_accuracy, "CHUNK_PAIRS", 7 * 50)
    rng = np.random.default_rng(1)
    a = rng.normal(size=(50, 3)).astype(np.float32) * 5
    b = a if exclude_self else rng.normal(size=(50, 3)).astype(np.float32)
    d = ((a.astype(np.float64)[:, None] - b.astype(np.float64)[None]) ** 2
         ).sum(-1)
    if exclude_self:
        np.fill_diagonal(d, np.inf)
    got = ref_accuracy.nearest_sq(torch.from_numpy(a), torch.from_numpy(b),
                                  exclude_self)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), d.min(1))


def test_the_six_numbers_equal_batched_accuracy():
    """On random clouds (an env without scan points among them) the
    reference's float64 numbers lie within the cell's limit of the
    program's float32 ones, the unseen share exact."""
    rng = np.random.default_rng(2)
    n, m = 3, 300
    gt = (rng.normal(size=(n, m, 3)) * 4).astype(np.float32)
    gt_mask = rng.random((n, m)) < 0.9
    deduped = [np.unique(np.round(gt[e, :80] + rng.normal(size=(80, 3))
                                  .astype(np.float32) * 0.05, 2), axis=0)
               for e in range(n - 1)] + [np.zeros((0, 3), np.float32)]
    vox = np.full(n, 0.2, np.float32)
    got = evaluation.batched_accuracy(deduped, gt, gt_mask, vox,
                                      device="cpu")
    want = ref_accuracy.accuracy(deduped, torch.from_numpy(gt),
                                 torch.from_numpy(gt_mask), vox)
    for name, g in zip(ref_accuracy.NAMES, got):
        if name == "gt_unseen_frac":
            assert g == pytest.approx(want[name], abs=1e-12), name
        else:
            assert g == pytest.approx(want[name],
                                      rel=LIMITS["accuracy_gap"]), name


# --- the passes' work ------------------------------------------------------

def test_the_work_count_equals_a_brute_force_count():
    """The pairs, bytes and operations of the three passes over envs of
    (scan, GT) points, counted pair by pair."""
    counts = [(3, 5), (0, 4), (7, 1)]
    pairs = 0
    for s, g in counts:
        pairs += sum(1 for _ in range(s) for _ in range(g))     # scan->GT
        pairs += sum(1 for _ in range(g) for _ in range(s))     # GT->scan
        pairs += sum(1 for _ in range(g) for _ in range(g))     # GT->GT
    assert work_chamfer.pairs(counts) == pairs == 55 + 16 + 15
    nbytes, ops = work_chamfer.work(counts)
    points = sum(s + g for s, g in counts)
    minima = sum(s + 2 * g for s, g in counts)
    assert (nbytes, ops) == (12 * points + 4 * minima, 8 * pairs)
    assert work_chamfer.least_seconds(counts, 8.0, 1.0) == max(
        nbytes / 1.0, ops / 8.0)


def test_the_programs_pairs_are_at_least_the_least():
    """The counter of the pairs the program computes, padding and groups
    included, is at least the frozen count's pairs over the same points,
    and equals the chunks it computes."""
    rng = np.random.default_rng(3)
    gt = (rng.normal(size=(3, 900, 3)) * 4).astype(np.float32)
    gt_mask = rng.random((3, 900)) < 0.9
    deduped = [rng.normal(size=(k, 3)).astype(np.float32)
               for k in (1500, 20, 700)]
    computed = []
    sq = chamfer._sq_dists

    def counting(a, b):
        out = sq(a, b)
        computed.append(out.numel())
        return out
    profiling.reset_counters("accuracy/")
    with faults._patched(chamfer, "_sq_dists", counting):
        evaluation.batched_accuracy(deduped, gt, gt_mask, np.ones(3),
                                    device="cpu")
    counted = profiling.counters("accuracy/")["accuracy/nn_pairs"]
    least = work_chamfer.pairs([(len(p), int(m)) for p, m in
                                zip(deduped, gt_mask.sum(1))])
    assert counted == sum(computed) >= least


# --- the readers of the new per-layer metrics -----------------------------

T = 1_700_000_000_000_000_000            # a Unix-epoch instant, ns
MS = 1_000_000


def _rec_and_spans():
    """A profiled window of 100 ms and two report episodes' spans: scans
    of 1 and 3 ms device time, dedupes of 20 and 40 ms host time, passes
    of 300 and 500 ms device time; spans of the same names outside the
    window (a later session) are not read."""
    from benchmark import trace
    rec = {"spans": [trace.Span("k", T, T + 100 * MS)], "window_ns": 100 * MS,
           "peaks": {"float32_flops": 8e9, "hbm_bytes_per_s": 1e9},
           "nn_counts": [(1000, 2000), (0, 500)],
           "counted": {"accuracy/nn_pairs": 1.5e7,
                       "accuracy/scan_points": 1000.0}}

    def span(name, unit, start, took, length=1):
        return profiling.Span(0, name, None, unit, T + start * MS,
                              T + (start + length) * MS, took)
    spans = [span("eval/scan", 1, 1, 0.001),
             span("eval/accuracy/dedupe", 1, 2, None, 20),
             span("eval/accuracy/nn", 1, 23, 0.300),
             span("eval/scan", 2, 50, 0.003),
             span("eval/accuracy/dedupe", 2, 51, None, 40),
             span("eval/accuracy/nn", 2, 92, 0.500),
             span("eval/scan", 3, 60_000, 9.0),
             span("eval/accuracy/dedupe", 3, 60_001, None, 900),
             span("eval/accuracy/nn", 3, 61_000, 9.0)]
    return rec, spans


# the least pairs: 2 * 1000 * 2000 + 2000^2 + 500^2 = 8.25e6; bytes
# 12 * 3500 + 4 * 6000 = 66,000 (66 us at 1e9), operations 6.6e7 (8.25 ms
# at 8e9), over the passes' mean 400 ms
PAIRS = 2 * 1000 * 2000 + 2000 ** 2 + 500 ** 2


@pytest.mark.parametrize("name,want", [
    ("scan_ms.report", 2.0), ("dedupe_ms.report", 30.0),
    ("nn_ms.report", 400.0),
    ("nn_roofline.report", 100.0 * (8 * PAIRS / 8e9) / 0.4),
    ("nn_pairs_ratio.report", 1.5e7 / PAIRS)])
def test_readers_read_the_spans_and_counts(monkeypatch, name, want):
    rec, spans = _rec_and_spans()
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    got = harness.metric_reader(name).read(rec)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["scan_ms.report", "dedupe_ms.report",
                                  "nn_ms.report", "nn_roofline.report",
                                  "nn_pairs_ratio.report"])
def test_readers_give_nothing_where_the_program_has_nothing(monkeypatch,
                                                            name):
    """A program without the report's spans and counters (the parent of
    these), or with spans that keep no device time, and a run without a
    profile, read nothing."""
    rec, spans = _rec_and_spans()
    reader = harness.metric_reader(name)
    untimed = collections.namedtuple(      # a span as it was before
        "Span", "id name parent unit start_ns end_ns")
    parent = dict(rec, counted={})
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read(parent) is None
    if name != "dedupe_ms.report":          # a host span: no device time
        monkeypatch.setattr(profiling, "spans",
                            lambda: [untimed(*s[:6]) for s in spans])
        assert reader.read(parent) is None
    assert reader.read({}) is None


def test_the_limits_file_holds_the_cells_numbers():
    with open(harness.BENCH / "limits" / f"{WORKLOAD}.json") as f:
        limits = json.load(f)
    assert set(limits) == {"env_mismatches", "logit_gap", "scan_mismatches",
                           "accuracy_gap"}
    assert limits["scan_mismatches"] == limits["env_mismatches"] == 0
