"""Dataset directories in the port: ``load_reference_gt``, ``load_npz`` and
``make_scenes`` on both directory forms against the JAX package's, the
port's ``convert_dataset`` against ``tools/convert_dataset.py`` on OBJ
meshes made here by the native mesher, a short env episode on the
converted scenes against the JAX env, and where the voxelizer is built.
Scene arrays and converted arrays are exact; the episode is held as
tests/test_torch_dda_env.py holds the env (grayscale frames to 1e-4)."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import config as jax_config
from gennbv_tpu.env import ReconEnv as JaxReconEnv
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch.env import ReconEnv
from gennbv_tpu_torch.env import scene as pt_scene
from gennbv_tpu_torch.ops._cuda import BUILD_DIR
from gennbv_tpu_torch.tools import convert_dataset as pt_convert
from gennbv_tpu_torch.utils import native as pt_native
from test_torch_dda_env import assert_same_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16


def assert_same_scenes(got, want):
    assert got.grid_res == want.grid_res and got.grid_size == want.grid_size
    for name in pt_scene.SceneSet._fields[:-2]:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.device.type == "cpu"
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def _gt_grid(num_scenes, seed):
    """A reference-layout GT tensor [S, G, G, G, 4] of procedural houses:
    voxel-center coordinates and the GT surface occupancy."""
    sc = jax_scene.generate_procedural(
        jax_config.SceneConfig(num_scenes=num_scenes, seed=seed), RES)
    g = sc.grid_size
    out = np.zeros((num_scenes, g, g, g, 4), np.float32)
    for i in range(num_scenes):
        out[i, ..., :3] = np.asarray(jax_scene.voxel_centers(
            sc.range_gt[i], sc.voxel_size[i], g)).reshape(g, g, g, 3)
    out[..., 3] = np.asarray(sc.grid_gt)
    return out


@pytest.mark.parametrize("grid_res", [40, 24])
def test_load_reference_gt_matches_jax(grid_res):
    """R a multiple of G (block upsampling) and not (nearest indices)."""
    gt = _gt_grid(3, 2)
    assert_same_scenes(pt_scene.load_reference_gt(gt, grid_res, "cpu"),
                       jax_scene.load_reference_gt(gt, grid_res))


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """OBJ meshes of 3 procedural houses (the native mesher), converted by
    the JAX tool and by the port's; returns (mesh dir, JAX dir, port dir)."""
    from tools import convert_dataset as jax_convert
    root = tmp_path_factory.mktemp("dataset")
    meshes = root / "meshes"
    paths = pt_convert.write_procedural_meshes(str(meshes), 3, seed=4, res=RES)
    assert len(paths) == 3 and all(os.path.getsize(p) > 0 for p in paths)
    jax_convert.convert(str(meshes), str(root / "jax"), res=RES, grid_size=20,
                        scale=1.0)
    pt_convert.main(["--mesh_dir", str(meshes), "--out", str(root / "port"),
                     "--res", str(RES)])
    return meshes, root / "jax", root / "port"


def test_convert_dataset_matches_jax_tool(converted):
    _, jdir, pdir = converted
    want = np.load(jdir / "scenes.npz")
    got = np.load(pdir / "scenes.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["render_occ"].sum() > 0 and got["gt_points_mask"].any()


def test_dataset_directories_load_as_jax(converted, tmp_path):
    """make_scenes on a scenes.npz directory and on a gt_grid.npy one
    gives load_npz / load_reference_gt, equal to the JAX package's."""
    _, _, pdir = converted
    cfg = pt_config.SceneConfig(dataset=str(pdir))
    got = pt_scene.make_scenes(cfg, 99, "cpu")        # R comes from the file
    assert_same_scenes(got, jax_scene.load_npz(str(pdir / "scenes.npz")))
    assert_same_scenes(pt_scene.load_npz(str(pdir / "scenes.npz"), "cpu"),
                       jax_scene.make_scenes(
                           jax_config.SceneConfig(dataset=str(pdir)), 99))
    assert got.num_scenes == 3 and got.grid_res == RES

    np.save(tmp_path / "gt_grid.npy", _gt_grid(2, 5))
    cfg = pt_config.SceneConfig(dataset=str(tmp_path))
    assert_same_scenes(pt_scene.make_scenes(cfg, 20, "cpu"),
                       jax_scene.make_scenes(
                           jax_config.SceneConfig(dataset=str(tmp_path)), 20))
    with pytest.raises(FileNotFoundError, match="scenes.npz or gt_grid.npy"):
        pt_scene.make_scenes(pt_config.SceneConfig(
            dataset=str(tmp_path / "missing")), 20, "cpu")


@pytest.mark.parametrize("mode", ["splat", "dda"])
def test_env_on_converted_scenes_matches_jax(converted, mode):
    """4 envs on the 3 converted scenes, 16^2 camera, reset + 5 steps of
    4-step episodes."""
    _, jdir, pdir = converted
    cfgs = [mod.EnvConfig(
        num_envs=4, max_episode_length=4,
        camera=mod.CameraConfig(height=16, width=16),
        renderer=mod.RendererConfig(resolution=RES, mode=mode),
        scene=mod.SceneConfig(num_scenes=3))
        for mod in (jax_config, pt_config)]
    jenv = JaxReconEnv(cfgs[0], jax_scene.load_npz(str(jdir / "scenes.npz")))
    penv = ReconEnv(cfgs[1], pt_scene.load_npz(str(pdir / "scenes.npz"), "cpu"))
    rng = np.random.default_rng(2)
    acts = np.stack([rng.integers(20, 60, (5, 4)), rng.integers(20, 60, (5, 4)),
                     rng.integers(10, 40, (5, 4)), np.zeros((5, 4), int),
                     rng.integers(0, 13, (5, 4)), rng.integers(0, 13, (5, 4))],
                    -1).astype(np.int32)
    jstate, jout = jenv.reset(4)
    pstate, pout = penv.reset(4)
    occupied = 0
    for t in range(6):
        assert_same_step(pstate, pout, jstate, jout, t)
        occupied += int((np.asarray(jout.obs)[:, 600:8600] > 0).sum())
        if t == 5:
            break
        jstate, jout = jenv.step(jstate, jnp.asarray(acts[t]))
        pstate, pout = penv.step(pstate, torch.from_numpy(acts[t]))
    assert occupied > 0, "the views hit the converted houses"


def _tree_digest(path):
    h = hashlib.sha256()
    for name in sorted(os.listdir(path)):
        h.update(name.encode())
        with open(os.path.join(path, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_voxelizer_builds_under_build_dir(tmp_path):
    """The port compiles native/voxelizer.cpp into gennbv_tpu_torch/_build/
    (a name keyed by the source's digest), checks its ABI and never
    writes into native/."""
    native_dir = os.path.join(REPO, "native")
    before = _tree_digest(native_dir)
    so = pt_native.build(pt_native._VOXELIZER_SRC, pt_native._VOXELIZER_FLAGS)
    assert so.parent == BUILD_DIR and so.exists()
    assert so.name.startswith("libvoxelizer_")
    lib = pt_native.load_voxelizer()
    assert lib.voxelizer_abi_version() == pt_native.VOXELIZER_ABI
    pt_convert.write_procedural_meshes(str(tmp_path), 1, seed=0, res=RES)
    occ, lo, hi = pt_native.voxelize_obj(str(tmp_path / "house_000.obj"), RES)
    assert occ.shape == (RES,) * 3 and occ.sum() > 0 and (hi > lo).all()
    assert _tree_digest(native_dir) == before
