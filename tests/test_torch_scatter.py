"""The port's any-hit voxel scatter against the JAX package's Pallas kernel
(``pallas_scatter.scatter_cells_any``, run in interpret mode off a TPU) and
its one-hot GEMM form (``mxu.scatter_cells_any``).  All produce a {0, 1}
grid, so they must agree bit for bit."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu.ops import mxu, pallas_scatter
from gennbv_tpu_torch.ops import scatter, voxel


def _numpy_any_hit(idx, valid, g):
    ref = np.zeros((g, g, g), np.float32)
    ii = idx[valid]
    ref[ii[:, 0], ii[:, 1], ii[:, 2]] = 1.0
    return ref


@pytest.mark.parametrize("g,q", [(4, 40), (20, 700), (20, 5000)])
def test_single_env_matches_pallas_and_mxu(g, q):
    rng = np.random.default_rng(g + q)
    idx = rng.integers(0, g, (q, 3)).astype(np.int32)
    valid = rng.random(q) < 0.7
    want = np.asarray(pallas_scatter.scatter_cells_any(
        jnp.asarray(idx), jnp.asarray(valid), g))
    np.testing.assert_array_equal(
        np.asarray(mxu.scatter_cells_any(jnp.asarray(idx), jnp.asarray(valid), g)),
        want)
    np.testing.assert_array_equal(want, _numpy_any_hit(idx, valid, g))
    args = (torch.from_numpy(idx)[None], torch.from_numpy(valid)[None], g)
    for fn in (scatter.scatter_cells_any_ref, scatter.scatter_cells_any):
        got = fn(*args)
        assert got.dtype == torch.float32 and got.shape == (1, g, g, g)
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_batch_with_an_all_invalid_env_matches_vmapped_pallas():
    """q > 4096 points, so the vmapped Pallas kernel runs several grid
    steps per env; env 2 has no valid point."""
    rng = np.random.default_rng(1)
    n, g, q = 3, 20, 5000
    idx = rng.integers(0, g, (n, q, 3)).astype(np.int32)
    valid = rng.random((n, q)) < 0.5
    valid[2] = False
    want = np.asarray(jax.vmap(
        lambda i, v: pallas_scatter.scatter_cells_any(i, v, g))(
            jnp.asarray(idx), jnp.asarray(valid)))
    assert want[2].sum() == 0.0
    got = scatter.scatter_cells_any(torch.from_numpy(idx),
                                    torch.from_numpy(valid), g)
    np.testing.assert_array_equal(got.numpy(), want)
    # the env step's hit grid goes through the same scatter
    hits = voxel.scatter_hits(g, torch.from_numpy(idx), torch.from_numpy(valid))
    np.testing.assert_array_equal(hits.numpy(), want)


def test_rejects_what_the_kernel_does_not_take():
    idx = torch.zeros(2, 5, 3, dtype=torch.int32)
    valid = torch.ones(2, 5, dtype=torch.bool)
    with pytest.raises(TypeError):
        scatter.scatter_cells_any(idx.long(), valid, 4)
    with pytest.raises(ValueError):
        scatter.scatter_cells_any(idx, valid[:, :4], 4)
    with pytest.raises(ValueError):
        scatter.scatter_cells_any(idx.transpose(0, 1), valid.t(), 4)
