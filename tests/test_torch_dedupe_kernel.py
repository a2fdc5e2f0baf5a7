"""Tests of the report's 1 cm dedupe on the card (``csrc/dedupe_cm.cu``
through ``ops/dedupe.py``, ``evaluation.episode_accuracy`` on a CUDA env):
each env's rows and count equal ``np.unique(np.round(points, 2), axis=0)``
of its episode's points, in value and in order (``assert_array_equal``,
for which -0.0 equals +0.0), over the report's shape (31 views x 50 envs x
2,500 rays), masks with holes, episodes that end at varied steps (step 0
among them), an env with no valid point, rows repeated across views,
negative coordinates, values within a float32 ulp of a half-centimetre and
coordinates up to 20 m; a point beyond the key's range raises; one launch
is counted a call; and ``batched_accuracy`` fed from the kernel gives the
host path's six numbers bit for bit.  Those skip on a machine without a
card.  The tests at the end run on the CPU: the plain version
``dedupe_cm_ref`` against np.unique on the same cases, the wrapper's
refusals, a CPU ``evaluate`` that launches nothing and reads what the host
path gives, and the counter ``accuracy/dedupe_points_in``.  This file imports
no jax, so where jax is missing run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dedupe_kernel.py
"""
import test_torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest
import torch

from gennbv_tpu_torch import config
from gennbv_tpu_torch.algo import evaluation
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.ops import dedupe, kernels
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.work import WorkCounter


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _scans(seed, t1, n, s):
    """An episode's scans, numpy: pts [t1, n, s, 3] float32 up to 20 m
    either side, a third of them on a 5 cm lattice (rows that repeat in a
    view and across views), some within a float32 ulp of a half-centimetre
    and some within 6 mm of 0 (rows np.round leaves at -0.0); each env's
    view 2 a copy of its view 1; valid [t1, n, s] with holes, env 1 with no
    valid point; first_done [n] int64 from 0 to past the episode's end."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20, 20, (t1, n, s, 3)).astype(np.float32)
    third = s // 3
    pts[..., :third, :] = np.round(pts[..., :third, :] * 20) / 20
    k = rng.integers(-2000, 2000, (t1, n, 8, 3)).astype(np.float32)
    mid = (k + np.float32(0.5)) / np.float32(100)
    edge = slice(third, third + 24)
    pts[..., edge, :] = np.concatenate(
        [mid, np.nextafter(mid, np.float32(np.inf)),
         np.nextafter(mid, np.float32(-np.inf))], 2)[..., :pts[..., edge, :]
                                                       .shape[-2], :]
    near = slice(third + 24, third + 40)
    pts[..., near, :] = rng.uniform(-0.006, 0.006,
                                    pts[..., near, :].shape)
    if t1 > 2:
        pts[2] = pts[1]
    valid = rng.random((t1, n, s)) < np.linspace(0.9, 0.4, s)
    if n > 1:
        valid[:, 1] = False
    first_done = rng.integers(0, t1 + 1, n)
    first_done[0] = 0
    return pts, valid, first_done.astype(np.int64)


def _unique(pts, valid, first_done):
    """Each env's np.unique rows, through the host path's own masking
    (``evaluation.episode_scans``)."""
    t = pts.shape[0] - 1
    before_done = np.arange(t)[:, None] <= first_done[None, :]
    return evaluation.episode_scans(pts, valid, before_done)


def _held(got, pts, valid, first_done, multiple):
    """``got`` (a ``Deduped``) against np.unique: each env's rows in value
    and order, zeros past its count, the width its largest count rounded up
    to `multiple`, the points that entered the masks' count."""
    want = _unique(pts, valid, first_done)
    counts = [len(w) for w in want]
    assert got.counts.tolist() == counts
    rows = got.rows.cpu().numpy()
    assert rows.dtype == np.float32
    assert rows.shape == (len(want), -(-max(counts) // multiple) * multiple, 3)
    for e, w in enumerate(want):
        np.testing.assert_array_equal(rows[e, :len(w)], w)
        assert not rows[e, len(w):].any()
    keep = valid.copy()
    keep[1:] &= (np.arange(pts.shape[0] - 1)[:, None]
                 <= first_done[None, :])[..., None]
    assert got.points_in.tolist() == keep.sum((0, 2)).tolist()


CASES = [(31, 50, 2500), (1, 1, 1), (2, 3, 37), (6, 5, 300), (31, 2, 9000),
         (4, 64, 257)]


def _tensors(pts, valid, first_done, device):
    return (torch.as_tensor(pts, device=device),
            torch.as_tensor(valid, device=device),
            torch.as_tensor(first_done, device=device))


@pytest.mark.parametrize("t1,n,s", CASES)
def test_kernel_equals_np_unique(cuda, t1, n, s):
    """The report's shape, and shapes whose rows no CTA's 256 threads
    and whose env segments no tile of 4,096 keys divide (one env of
    ~280,000 points at 9,000 rays); the plain version on the card gives the
    same rows bit for bit; one launch counted."""
    case = _scans(t1 * n * s, t1, n, s)
    args = _tensors(*case, "cuda")
    before = kernels.launches()["dedupe_cm"]
    got = dedupe.dedupe_cm(*args, multiple=1024)
    assert kernels.launches()["dedupe_cm"] == before + 1
    _held(got, *case, 1024)
    ref = dedupe.dedupe_cm_ref(*args, multiple=1024)
    assert torch.equal(got.rows, ref.rows)
    assert (got.counts == ref.counts).all()
    assert (got.points_in == ref.points_in).all()


def test_runs_across_tiles_and_single_rows(cuda):
    """Every point of an env the same row (one run across many tiles of
    the sort), an env whose every point differs, an env of one valid
    point, and widths of multiple 1."""
    pts, valid, first_done = _scans(3, 5, 4, 4000)
    pts[:, 0] = np.float32(-3.215)
    valid[:, 0] = True
    pts[:, 2] = (np.arange(5 * 4000 * 3, dtype=np.float32).reshape(
        5, 4000, 3) / 100)
    valid[:, 2] = True
    valid[:, 3] = False
    valid[0, 3, 17] = True
    first_done[:] = 10
    got = dedupe.dedupe_cm(*_tensors(pts, valid, first_done, "cuda"))
    _held(got, pts, valid, first_done, 1)
    assert got.counts[0] == 1 and got.counts[2] == 20_000
    assert got.counts[3] == 1


@pytest.mark.parametrize("bad", ["nan", "inf", "beyond"])
def test_a_point_beyond_the_keys_range_raises(cuda, bad):
    """A valid point that is not finite or lies beyond +-2^(b-1) cm
    raises; the same point masked out does not."""
    pts, valid, first_done = _scans(5, 3, 4, 100)
    half = 2 ** (dedupe.key_bits(4) - 1)
    value = {"nan": np.nan, "inf": -np.inf, "beyond": half / 100.0}[bad]
    pts[1, 2, 7, 1] = value
    valid[1, 2, 7] = True
    first_done[2] = 3
    with pytest.raises(ValueError, match="not finite or lie beyond"):
        dedupe.dedupe_cm(*_tensors(pts, valid, first_done, "cuda"))
    valid[1, 2, 7] = False
    _held(dedupe.dedupe_cm(*_tensors(pts, valid, first_done, "cuda")),
          pts, valid, first_done, 1)


def test_kernel_counters(cuda):
    """``kernel/dedupe_cm/launches`` counts one a call, and none where
    there is no point; inside a WorkCounter the call adds
    ``dedupe.work``'s bytes and operations."""
    case = _scans(11, 4, 3, 500)
    args = _tensors(*case, "cuda")
    before = kernels.launches()["dedupe_cm"]
    got = dedupe.dedupe_cm(*args)
    dedupe.dedupe_cm(args[0][:, :, :0], args[1][:, :, :0], args[2])
    assert kernels.launches()["dedupe_cm"] == before + 1
    nbytes, ops = dedupe.work(args[1].numel(), int(got.points_in.sum()),
                              int(got.counts.sum()))
    with WorkCounter() as counted:
        dedupe.dedupe_cm(*args)
    assert counted.flops == ops > 0 and counted.bytes >= nbytes > 0


def _accuracy_inputs(n=4, t1=31, s=2500):
    """An episode-sized scan of n of the report's held-out scenes (seed
    100 at R = 64): each view GT points moved by 2 cm of noise, so the
    views overlap at 1 cm; the GT points and masks and the render voxels,
    on the host."""
    scenes = make_scenes(config.SceneConfig(num_scenes=n, seed=100), 64,
                         "cuda")
    gt = scenes.gt_points.cpu().numpy()
    gt_mask = scenes.gt_points_mask.cpu().numpy()
    rng = np.random.default_rng(27)
    pts = np.zeros((t1, n, s, 3), np.float32)
    for e in range(n):
        surface = gt[e][gt_mask[e]]
        pick = surface[rng.integers(0, len(surface), (t1, s))]
        pts[:, e] = pick + rng.normal(size=pick.shape).astype(
            np.float32) * np.float32(0.02)
    valid = rng.random((t1, n, s)) < 0.8
    first_done = np.array([29, 0, 12, 40][:n], np.int64)
    vox = ((scenes.box_hi - scenes.box_lo).cpu().numpy().max(axis=1)
           / scenes.grid_res)
    return (pts, valid, first_done), gt, gt_mask, vox


def test_batched_accuracy_from_the_kernel_equals_the_host_path(cuda):
    """The six numbers and the pairs counted from the kernel's rows equal
    those from the host's np.unique lists, bit for bit, on the card."""
    case, gt, gt_mask, vox = _accuracy_inputs()
    host = _unique(*case)
    profiling.reset_counters("accuracy/")
    want = evaluation.batched_accuracy(host, gt, gt_mask, vox)
    want_pairs = profiling.counters("accuracy/")["accuracy/nn_pairs"]
    rows = dedupe.dedupe_cm(*_tensors(*case, "cuda"),
                            multiple=evaluation.SCAN_PAD)
    assert rows.counts.tolist() == [len(p) for p in host]
    profiling.reset_counters("accuracy/")
    got = evaluation.batched_accuracy(rows, gt, gt_mask, vox)
    assert got == want
    assert profiling.counters("accuracy/")["accuracy/nn_pairs"] == want_pairs


def _report_env(device, hw=32, max_len=4):
    cfg = config.EnvConfig(
        num_envs=3, max_episode_length=max_len,
        camera=config.CameraConfig(height=hw, width=hw),
        renderer=config.RendererConfig(resolution=16),
        scene=config.SceneConfig(num_scenes=3, seed=1))
    env = ReconEnv(cfg, make_scenes(cfg.scene, 16, device))
    torch.manual_seed(0)
    return env, ActorCriticPolicy(
        config.ModelConfig(pose_mlp_hidden=32, grid_channels=4, fused_dim=32),
        None, device)


def _kept(monkeypatch):
    """Each ``run_episodes`` result of the test, kept."""
    run, kept = evaluation.run_episodes, []

    def keeping(*args, **kwargs):
        kept.append(run(*args, **kwargs))
        return kept[-1]
    monkeypatch.setattr(evaluation, "run_episodes", keeping)
    return kept


def test_a_card_eval_dedupes_on_the_card(cuda, monkeypatch):
    """A CUDA env's ``evaluate(..., compute_accuracy=True)`` launches the
    dedupe once inside ``eval/accuracy/dedupe`` and reads the six numbers
    the host path gives on the same episode; the counters count the same
    on both paths."""
    env, policy = _report_env("cuda")
    kept = _kept(monkeypatch)
    before = kernels.launches()["dedupe_cm"]
    profiling.reset_counters("accuracy/")
    got = evaluation.evaluate(env, policy, point_stride=2)
    on_card = profiling.counters("accuracy/")
    assert kernels.launches()["dedupe_cm"] == before + 1
    (ep,) = kept
    assert ep.device_scans[0].is_cuda
    profiling.reset_counters("accuracy/")
    host = evaluation.episode_accuracy(env, ep._replace(device_scans=None))
    assert kernels.launches()["dedupe_cm"] == before + 1
    assert host == (got.mean_accuracy_cm, got.accuracy_scan2gt,
                    got.accuracy_gt2scan, got.accuracy_gt2scan_seen,
                    got.gt_unseen_frac, got.accuracy_floor_gt_sampling)
    assert profiling.counters("accuracy/") == on_card


# --- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("t1,n,s", CASES)
def test_plain_version_equals_np_unique(t1, n, s):
    """``dedupe_cm_ref`` (the wrapper's path for CPU tensors) on the card
    tests' cases."""
    case = _scans(t1 * n * s, t1, n, s)
    got = dedupe.dedupe_cm(*_tensors(*case, "cpu"), multiple=1024)
    _held(got, *case, 1024)


@pytest.mark.parametrize("bad", ["nan", "beyond", "below"])
def test_the_plain_version_raises_beyond_the_keys_range(bad):
    """A valid point that is not finite or lies beyond the key's range
    raises on the CPU too; masked out, it does not."""
    pts, valid, first_done = _scans(5, 3, 4, 100)
    half = 2 ** (dedupe.key_bits(4) - 1)
    value = {"nan": np.nan, "beyond": half / 100.0,
             "below": -(half + 1) / 100.0}[bad]
    pts[0, 3, 7, 2] = value
    valid[0, 3, 7] = True
    with pytest.raises(ValueError, match="not finite or lie beyond"):
        dedupe.dedupe_cm(*_tensors(pts, valid, first_done, "cpu"))
    valid[0, 3, 7] = False
    _held(dedupe.dedupe_cm(*_tensors(pts, valid, first_done, "cpu")),
          pts, valid, first_done, 1)


@pytest.mark.parametrize("n", [1, 2, 50, 63, 64, 1000, 2 ** 20])
def test_every_key_lies_below_the_masked_key(n):
    """The largest key of n envs (the last env, every axis field all ones)
    is non-negative and below MASKED; 50 envs take 19 bits an axis."""
    b = dedupe.key_bits(n)
    top = ((n - 1) << 3 * b) | ((1 << 3 * b) - 1)
    assert 0 <= top < dedupe.MASKED and b >= 1
    assert dedupe.key_bits(50) == 19


@pytest.mark.parametrize("case", ["float64", "int_valid", "int32_done",
                                  "no_xyz", "valid_shape", "done_shape",
                                  "no_views", "devices", "multiple"])
def test_the_wrapper_refuses_what_it_does_not_take(case):
    """Points other than float32, masks other than bool, first_done other
    than int64, shapes that do not fit [T + 1, N, S, 3], [T + 1, N, S] and
    [N], no view, tensors on two devices, a multiple below 1."""
    pts, valid, done = _tensors(*_scans(1, 3, 4, 10), "cpu")
    error = {"float64": TypeError, "int_valid": TypeError,
             "int32_done": TypeError}.get(case, ValueError)
    args = {"float64": (pts.double(), valid, done),
            "int_valid": (pts, valid.int(), done),
            "int32_done": (pts, valid, done.int()),
            "no_xyz": (pts[..., :2], valid, done),
            "valid_shape": (pts, valid[:, :, :5], done),
            "done_shape": (pts, valid, done[:3]),
            "no_views": (pts[:0], valid[:0], done),
            "devices": (pts, valid.to("meta"), done),
            "multiple": (pts, valid, done, 0)}[case]
    with pytest.raises(error, match="dedupe_cm"):
        dedupe.dedupe_cm(*args)


def test_a_cpu_evaluate_launches_nothing_and_reads_as_before(monkeypatch):
    """On the CPU the dedupe is ``episode_scans``' np.unique: no kernel
    launches, the six numbers and the counters are those of
    ``episode_scans`` and ``batched_accuracy``'s list form on the same
    episode, and ``accuracy/dedupe_points_in`` is the episode masks'
    sum."""
    env, policy = _report_env("cpu")
    kept = _kept(monkeypatch)
    kernels.reset_launches()
    profiling.reset_counters("accuracy/")
    got = evaluation.evaluate(env, policy, point_stride=2)
    counted = profiling.counters("accuracy/")
    assert set(kernels.launches().values()) == {0}
    (ep,) = kept
    assert ep.device_scans is not None and not ep.device_scans[0].is_cuda
    before_done = evaluation.before_done_mask(ep.dones)
    deduped = evaluation.episode_scans(ep.scan_pts, ep.scan_valid,
                                       before_done)
    sc = env.scenes
    box_lo = sc.box_lo[ep.scene_id].numpy()
    box_hi = sc.box_hi[ep.scene_id].numpy()
    profiling.reset_counters("accuracy/")
    want = evaluation.batched_accuracy(
        deduped, sc.gt_points[ep.scene_id].numpy(),
        sc.gt_points_mask[ep.scene_id].numpy(),
        (box_hi - box_lo).max(axis=1) / sc.grid_res, device="cpu")
    assert (got.mean_accuracy_cm, got.accuracy_scan2gt,
            got.accuracy_gt2scan, got.accuracy_gt2scan_seen,
            got.gt_unseen_frac, got.accuracy_floor_gt_sampling) == want
    assert counted["accuracy/nn_pairs"] == profiling.counters(
        "accuracy/")["accuracy/nn_pairs"] > 0
    assert counted["accuracy/scan_points"] == sum(map(len, deduped)) > 0
    keep = ep.scan_valid.copy()
    keep[1:] &= before_done[:, :, None]
    assert counted["accuracy/dedupe_points_in"] == keep.sum() > 0


def test_dedupe_points_in_counts_the_masks_on_a_longer_episode(monkeypatch):
    """Over an episode whose envs end early (16 steps of a 32^2 camera),
    ``accuracy/dedupe_points_in`` is the sum of the masks that
    ``episode_scans`` dedupes, and at least ``accuracy/scan_points``."""
    env, policy = _report_env("cpu", max_len=16)
    kept = _kept(monkeypatch)
    profiling.reset_counters("accuracy/")
    evaluation.evaluate(env, policy, point_stride=2)
    counted = profiling.counters("accuracy/")
    (ep,) = kept
    keep = ep.scan_valid.copy()
    keep[1:] &= evaluation.before_done_mask(ep.dones)[:, :, None]
    assert counted["accuracy/dedupe_points_in"] == keep.sum()
    assert counted["accuracy/dedupe_points_in"] >= counted[
        "accuracy/scan_points"] > 0
