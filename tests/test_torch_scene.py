"""The port's procedural scenes are bit-identical to the JAX package's."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu.config import SceneConfig as JaxSceneConfig
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu_torch.config import SceneConfig
from gennbv_tpu_torch.env import scene as pt_scene


@pytest.mark.parametrize("num_scenes,grid_res", [(2, 16), (8, 16), (2, 64), (8, 64)])
def test_generate_procedural_bit_equal(num_scenes, grid_res):
    want = jax_scene.generate_procedural(
        JaxSceneConfig(num_scenes=num_scenes, seed=5), grid_res)
    got = pt_scene.make_scenes(SceneConfig(num_scenes=num_scenes, seed=5),
                               grid_res, "cpu")
    assert got.grid_res == want.grid_res and got.grid_size == want.grid_size
    for name in pt_scene.SceneSet._fields[:-2]:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.device.type == "cpu"
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert got.surf_pts.shape[1] % 1024 == 0


def test_unported_datasets_raise(tmp_path):
    """Every dataset the JAX package's make_scenes takes loads: the terrain
    family (tests/test_torch_terrain.py holds it bit-equal to the JAX
    package), a dataset directory (tests/test_torch_dataset.py holds both
    forms to the JAX package), and the objects and convex families
    (tests/test_torch_chamfer.py holds them to the JAX generator)."""
    from gennbv_tpu.env.terrain import generate_terrain
    terrain = pt_scene.make_scenes(SceneConfig(num_scenes=1, dataset="terrain"),
                                   16, "cpu")
    want = generate_terrain(JaxSceneConfig(num_scenes=1, dataset="terrain"), 16)
    assert terrain.num_scenes == 1 and terrain.grid_res == 16
    np.testing.assert_array_equal(terrain.render_occ.numpy(),
                                  np.asarray(want.render_occ))
    src = pt_scene.generate_procedural(SceneConfig(num_scenes=2, seed=3), 16,
                                       device="cpu")
    g = src.grid_size
    gt = torch.cat([pt_scene.voxel_centers(src.range_gt, src.voxel_size, g)
                    .reshape(2, g, g, g, 3), src.grid_gt[..., None]], -1)
    np.save(tmp_path / "gt_grid.npy", gt.numpy())
    scenes = pt_scene.make_scenes(SceneConfig(dataset=str(tmp_path)), 16, "cpu")
    assert scenes.num_scenes == 2 and scenes.grid_res == 16
    assert torch.equal(scenes.grid_gt, src.grid_gt)
    for dataset in ("objects", "convex"):
        scenes = pt_scene.make_scenes(SceneConfig(num_scenes=1, dataset=dataset),
                                      16, "cpu")
        assert scenes.num_scenes == 1


def test_voxel_centers_bit_equal():
    """voxel_centers batched over scenes equals the JAX function vmapped
    under jit (where XLA fuses min + i * size into one multiply-add)."""
    rng = np.random.default_rng(0)
    range_gt = rng.uniform(-6, 6, (5, 6)).astype(np.float32)
    vsize = rng.uniform(0.2, 0.7, (5, 3)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda r, v: jax_scene.voxel_centers(r, v, 20)))(
        jnp.asarray(range_gt), jnp.asarray(vsize))
    got = pt_scene.voxel_centers(torch.from_numpy(range_gt),
                                 torch.from_numpy(vsize), 20)
    assert got.shape == (5, 8000, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
