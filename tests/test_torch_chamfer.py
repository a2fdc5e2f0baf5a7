"""The port's chamfer ops (``gennbv_tpu_torch/ops/chamfer.py``), the
eval's ``batched_accuracy`` and the objects and convex scene families,
each against the JAX package's on the same numpy inputs.

Per-point nearest-neighbour distances are exact (the squared distance is
rounded as XLA rounds it).  Means that the JAX package sums on its device
in XLA's order (``sampling_floor``, the chamfer terms and the accuracy's
GT sampling floor) are held to 1e-6 relative; the other five accuracy
outputs, whose means both packages take on the host, are exact."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

from gennbv_tpu import config as jax_config
from gennbv_tpu.algo import evaluation as jax_evaluation
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu.ops import chamfer as jax_chamfer
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch.algo import evaluation
from gennbv_tpu_torch.env import make_scenes
from gennbv_tpu_torch.ops import chamfer


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _clouds(seed, p, q):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(p, 3)) * 3).astype(np.float32)
    b = (rng.normal(size=(q, 3)) * 3).astype(np.float32)
    am = rng.random(p) < 0.8
    bm = rng.random(q) < 0.9
    return a, am, b, bm


@pytest.mark.parametrize("p,q,chunk", [(700, 900, 128), (37, 5, 16),
                                       (1000, 1, 1024)])
def test_nn_sq_dists_matches_jax(p, q, chunk):
    a, am, b, bm = _clouds(p + q, p, q)
    bm[0] = True
    want = np.asarray(jax_chamfer.nn_sq_dists(a, am, b, bm, chunk=chunk))
    got = chamfer.nn_sq_dists(*_t(a, am, b, bm), chunk=chunk).numpy()
    np.testing.assert_array_equal(got, want)
    # batched over a leading env axis: the same rows
    got2 = chamfer.nn_sq_dists(*_t(np.stack([b[:1].repeat(p, 0), a]),
                                   np.stack([am, am]), np.stack([b, b]),
                                   np.stack([bm, bm])), chunk=chunk)[1]
    np.testing.assert_array_equal(got2.numpy(), want)


@pytest.mark.parametrize("n", [37, 1000, 2049])
def test_sampling_floor_matches_jax(n):
    _, _, b, bm = _clouds(n, 1, n)
    want = float(jax_chamfer.sampling_floor(b, bm, chunk=128))
    got = float(chamfer.sampling_floor(*_t(b, bm), chunk=128))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the per-point minima under it exclude only the point itself
    mins = chamfer.self_nn_sq_dists(*_t(b, bm), chunk=128).numpy()
    d = ((b[:, None] - b[None]) ** 2).sum(-1)
    d[:, ~bm] = np.inf
    np.fill_diagonal(d, np.inf)
    np.testing.assert_allclose(mins[bm], d.min(1)[bm], rtol=1e-6)
    assert (mins[~bm] == 1e10).all()


def test_chamfer_distance_and_directed_match_jax():
    a, am, b, bm = _clouds(5, 300, 500)
    want = float(jax_chamfer.chamfer_distance(a, am, b, bm, chunk=64))
    got = float(chamfer.chamfer_distance(*_t(a, am, b, bm), chunk=64))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want2 = jax_chamfer.chamfer_directed(a, am, b, bm, chunk=64)
    got2 = chamfer.chamfer_directed(*_t(a, am, b, bm), chunk=64)
    np.testing.assert_allclose([float(x) for x in got2],
                               [float(x) for x in want2], rtol=1e-6)


def test_chamfer_known_values():
    """tests/test_ops.py's chamfer cases on the port: identical clouds,
    a known offset, masking, and the 1 cm dedupe."""
    rng = np.random.RandomState(3)
    pts = torch.from_numpy(rng.uniform(-1, 1, size=(100, 3)).astype(np.float32))
    ones = torch.ones(100, dtype=torch.bool)
    assert float(chamfer.chamfer_distance(pts, ones, pts, ones)) == \
        pytest.approx(0.0, abs=1e-6)

    a = torch.zeros(4, 3)
    b = torch.zeros(4, 3)
    b[:, 0] = 0.1
    m4 = torch.ones(4, dtype=torch.bool)
    assert float(chamfer.chamfer_distance(a, m4, b, m4)) == \
        pytest.approx(0.02, rel=1e-4)

    b = torch.tensor([[0.0, 0, 0], [5, 5, 5]])
    assert float(chamfer.chamfer_distance(
        a, m4, b, torch.tensor([True, False]))) == pytest.approx(0.0, abs=1e-6)

    pts = np.array([[0.001, 0, 0], [0.004, 0, 0], [1, 0, 0]])
    np.testing.assert_array_equal(chamfer.dedupe_round_cm(pts),
                                  jax_chamfer.dedupe_round_cm(pts))
    assert chamfer.dedupe_round_cm(pts).shape[0] == 2


def _accuracy_inputs(seed, sizes, pg):
    rng = np.random.default_rng(seed)
    n = len(sizes)
    # ragged scans, rounded and deduped as the eval makes them
    deduped = [chamfer.dedupe_round_cm(rng.normal(size=(k, 3)) * 0.5)
               .astype(np.float32) for k in sizes]
    gt_pts = rng.normal(size=(n, pg, 3)).astype(np.float32) * 0.5
    gt_mask = np.zeros((n, pg), bool)
    for e in range(n):                    # GT clouds are valid-first
        gt_mask[e, :rng.integers(pg // 2, pg + 1)] = True
    vox = rng.random(n).astype(np.float32) * 0.3 + 0.05
    return deduped, gt_pts, gt_mask, vox


@pytest.mark.parametrize("sizes,pg,group", [((20, 0, 1, 33, 7), 37, 2),
                                            ((1500, 900, 40), 700, None)])
def test_batched_accuracy_matches_jax(sizes, pg, group):
    """All six outputs on the same deduped lists, with an empty env and a
    one-point env; one remainder group."""
    deduped, gt_pts, gt_mask, vox = _accuracy_inputs(len(sizes), sizes, pg)
    want = jax_evaluation.batched_accuracy(deduped, gt_pts, gt_mask, vox,
                                           group=group)
    got = evaluation.batched_accuracy(deduped, gt_pts, gt_mask, vox,
                                      group=group, device="cpu")
    assert got[:5] == want[:5]
    np.testing.assert_allclose(got[5], want[5], rtol=1e-6)
    assert all(np.isfinite(got))


def test_batched_accuracy_group_invariant_and_empty():
    deduped, gt_pts, gt_mask, vox = _accuracy_inputs(1, (5, 9, 2, 11), 16)
    a = evaluation.batched_accuracy(deduped, gt_pts, gt_mask, vox, group=1,
                                    device="cpu")
    b = evaluation.batched_accuracy(deduped, gt_pts, gt_mask, vox, group=4,
                                    device="cpu")
    assert a == b
    got = evaluation.batched_accuracy(
        [np.zeros((0, 3))] * 2, np.zeros((2, 4, 3)), np.ones((2, 4), bool),
        np.full(2, 0.1), device="cpu")
    assert all(np.isnan(v) for v in got)


@pytest.mark.parametrize("dataset", ["objects", "convex"])
def test_object_families_equal_jax(dataset):
    """tests/test_aux.py's objects and convex families: the port's arrays
    equal JAX generate_procedural's, field by field."""
    r = 24
    want = jax_scene.generate_procedural(
        jax_config.SceneConfig(num_scenes=8, seed=0, dataset=dataset), r)
    got = make_scenes(pt_config.SceneConfig(num_scenes=8, seed=0,
                                            dataset=dataset), r, "cpu")
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
        else:
            assert g == w, name
    occ = got.render_occ.numpy().reshape(-1, r, r, r)
    frac = occ.mean(axis=(1, 2, 3))
    assert (frac > 0.003).all() and (frac < 0.6).all(), frac
    assert (got.num_valid_voxel > 0).all()

