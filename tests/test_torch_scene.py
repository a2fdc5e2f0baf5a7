"""The port's procedural scenes are bit-identical to the JAX package's."""
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
                               grid_res)
    assert got.grid_res == want.grid_res and got.grid_size == want.grid_size
    for name in pt_scene.SceneSet._fields[:-2]:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.device.type == "cpu"
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert got.surf_pts.shape[1] % 1024 == 0


def test_unported_datasets_raise():
    for dataset in ("objects", "terrain", "/some/dir"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
            pt_scene.make_scenes(SceneConfig(num_scenes=1, dataset=dataset), 16)


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
