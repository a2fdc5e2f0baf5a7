"""The port's mapping ops against the JAX package's, given identical
inputs: voxelization, hit scatter, z-test carve, grid update, coverage and
the collision test.  All are exact (indices, 0/1 grids, comparisons), so
they must agree bit for bit; the JAX functions run under jit(vmap(...))
as in the JAX env step."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from gennbv_tpu import spec
from gennbv_tpu.config import SceneConfig as JaxSceneConfig
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu.ops import camera as jax_camera
from gennbv_tpu.ops import carve as jax_carve
from gennbv_tpu.ops import render as jax_render
from gennbv_tpu.ops import voxel as jax_voxel
from gennbv_tpu_torch.ops import carve as pt_carve
from gennbv_tpu_torch.ops import render as pt_render
from gennbv_tpu_torch.ops import voxel as pt_voxel

G = spec.GRID_SIZE


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _scenes(n=4, seed=3, res=16):
    return jax_scene.generate_procedural(JaxSceneConfig(num_scenes=n, seed=seed), res)


def _poses(n, rng):
    acts = np.stack([rng.integers(0, k, n) for k in spec.NVEC], -1)
    acts[0] = spec.INIT_ACTION
    return (acts * np.asarray(spec.ACTION_UNIT, np.float32)
            + np.asarray(spec.CLIP_POSE_LOW, np.float32)).astype(np.float32)


def test_voxelize_and_scatter_hits():
    sc = _scenes()
    rng = np.random.default_rng(0)
    pts = np.asarray(sc.surf_pts)
    pts = pts + rng.normal(0, 0.3, pts.shape).astype(np.float32)   # some out of box
    valid = rng.random(pts.shape[:2]) < 0.7
    rg, vs = np.asarray(sc.range_gt), np.asarray(sc.voxel_size)
    idx_j, inb_j = jax.jit(jax_voxel.points_to_voxel_idx)(pts, valid, rg, vs)
    idx_p, inb_p = pt_voxel.points_to_voxel_idx(*_t(pts, valid, rg, vs))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(inb_p.numpy(), np.asarray(inb_j))
    assert 0 < np.asarray(inb_j).mean() < 1

    hits_j = jax.jit(jax.vmap(lambda i, v: jax_voxel.scatter_hits(G, i, v)))(
        idx_j, inb_j)
    hits_p = pt_voxel.scatter_hits(G, idx_p, inb_p)
    np.testing.assert_array_equal(hits_p.numpy(), np.asarray(hits_j))
    empty = pt_voxel.scatter_hits(G, idx_p, torch.zeros_like(inb_p))
    assert empty.sum() == 0


def test_carve_ztest_bit_equal():
    sc = _scenes()
    rng = np.random.default_rng(1)
    n, h, w = 4, 48, 64
    rg, vs = np.asarray(sc.range_gt), np.asarray(sc.voxel_size)
    centers = np.asarray(jax.jit(jax.vmap(
        lambda r, v: jax_scene.voxel_centers(r, v, G)))(rg, vs))
    r, t = jax.vmap(jax_camera.pose_to_c2w)(jnp.asarray(_poses(n, rng)))
    r, t = np.array(r), np.array(t)
    depth = rng.uniform(1.0, 30.0, (n, h, w)).astype(np.float32)
    depth[rng.random((n, h, w)) < 0.3] = 50.0               # empty pixels
    margin = (0.5 * vs.mean(-1)).astype(np.float32)
    k = jax_camera.intrinsics(h, w, 90.0)

    proj_j = jax.jit(jax.vmap(lambda c, rr, tt: jax_carve.project_centers_px(
        c, k, rr, tt, h, w)))(centers, r, t)
    proj_p = pt_carve.project_centers_px(*_t(centers), torch.from_numpy(k),
                                         *_t(r, t), h, w)
    for a, b in zip(proj_p, proj_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    free_j = jax.jit(jax.vmap(lambda c, d, rr, tt, m: jax_carve.carve_ztest(
        c, d, None, k, rr, tt, m, depth_max=50.0)))(centers, depth, r, t, margin)
    free_p = pt_carve.carve_ztest(*_t(centers, depth), torch.from_numpy(k),
                                  *_t(r, t, margin), 50.0)
    np.testing.assert_array_equal(free_p.numpy(), np.asarray(free_j))
    assert np.asarray(free_j).sum() > 0


def test_grid_update_tri_cls_and_coverage():
    rng = np.random.default_rng(2)
    n = 3
    prob = rng.choice([-0.1, -0.05, 0.0, 0.3, 0.55, 1.0], (n, G, G, G)).astype(np.float32)
    hit = (rng.random((n, G, G, G)) < 0.1).astype(np.float32)
    trav = (rng.random((n, G, G, G)) < 0.3).astype(np.float32)
    gt = (rng.random((n, G, G, G)) < 0.2).astype(np.float32)
    scanned = (rng.random((n, G, G, G)) < 0.05).astype(np.float32)
    nvalid = gt.sum((1, 2, 3)).astype(np.float32)
    nvalid[2] = 0.0                                        # guarded by max(., 1)

    new_j = jax.jit(jax_carve.update_prob_grid)(prob, hit, trav)
    new_p = pt_carve.update_prob_grid(*_t(prob, hit, trav))
    np.testing.assert_array_equal(new_p.numpy(), np.asarray(new_j))
    np.testing.assert_array_equal(pt_voxel.tri_cls(new_p).numpy(),
                                  np.asarray(jax.jit(jax_voxel.tri_cls)(new_j)))
    sc_j, ratio_j = jax.jit(jax_voxel.coverage_update)(scanned, hit, gt, nvalid)
    sc_p, ratio_p = pt_voxel.coverage_update(*_t(scanned, hit, gt, nvalid))
    np.testing.assert_array_equal(sc_p.numpy(), np.asarray(sc_j))
    np.testing.assert_array_equal(ratio_p.numpy(), np.asarray(ratio_j))


def test_check_collision_batch_bit_equal():
    sc = _scenes(n=3, seed=4, res=24)
    rng = np.random.default_rng(3)
    n = 64
    sid = rng.integers(0, 3, n).astype(np.int32)
    pos = np.c_[rng.uniform(-6, 6, (n, 2)), rng.uniform(0.1, 4, n)].astype(np.float32)
    pos[:8, :2] = 0.0                                  # inside the houses
    args = tuple(map(np.asarray, (sc.render_occ, sc.box_lo, sc.box_hi)))
    want = jax.jit(lambda *a: jax_render.check_collision_batch(*a, 0.25, 24))(
        *args, sid, pos)
    got = pt_render.check_collision_batch(*_t(*args, sid.astype(np.int64), pos),
                                          0.25, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < np.asarray(want).sum() < n
