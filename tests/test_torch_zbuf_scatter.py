"""The port's exact scatter-min z-buffer (``ops/zbuf_scatter.py``) against
the JAX package: its XLA scatter-min (``gennbv_tpu/ops/splat.py::_zbuf_px``,
``zbuf_impl="scatter"``), the Pallas kernel of ``tools/bench_scatter.py``
run in interpret mode, and the whole ``zbuf_vis_px`` visibility path.  A
min takes one of its inputs, so all must agree bit for bit."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gennbv_tpu.ops import splat as jax_splat
from gennbv_tpu_torch.ops import kernels, splat, zbuf_scatter

DMAX = 50.0


def _inputs(n, q, h, w, seed):
    """Seeded (vic, uic, z, ok) [n, q]: env 0 has no valid point, env 1
    piles its points on four pixels at many depths, the rest are random
    with 30% invalid; depths in [1, 30)."""
    rng = np.random.default_rng(seed)
    vic = rng.integers(0, h, (n, q)).astype(np.int32)
    uic = rng.integers(0, w, (n, q)).astype(np.int32)
    z = rng.uniform(1.0, 30.0, (n, q)).astype(np.float32)
    ok = rng.random((n, q)) < 0.7
    ok[0] = False
    vic[1] %= 2
    uic[1] %= 2
    return vic, uic, z, ok


def _jax_zbuf0(vic, uic, z, ok, h, w):
    """The JAX package's unpooled exact z-buffer [n, H*W]."""
    fn = jax.jit(jax.vmap(lambda v, u, zz, o: jax_splat._zbuf_px(
        v, u, zz, o, h, w, DMAX, jnp.float32(0.1), footprint=0,
        zbuf_impl="scatter")[0]))
    return np.asarray(fn(*map(jnp.asarray, (vic, uic, z, ok))))


def _port_zbuf0(vic, uic, z, ok, h, w, fn=zbuf_scatter.zbuf_scatter_min_ref):
    flat = torch.from_numpy(vic * w + uic)
    zz = torch.where(torch.from_numpy(ok), torch.from_numpy(z), DMAX)
    return fn(flat, zz, h, w, DMAX)


@pytest.mark.parametrize("n,q,h,w", [(4, 3000, 32, 32), (3, 700, 37, 53),
                                     (2, 1, 16, 16), (3, 0, 8, 12)])
def test_plain_equals_jax_scatter_min(n, q, h, w):
    """Duplicates on few pixels, invalid points, an empty env, Q = 1 and
    Q = 0 (every pixel at the fill)."""
    vic, uic, z, ok = _inputs(n, q, h, w, n + q + h)
    want = _jax_zbuf0(vic, uic, z, ok, h, w)
    for fn in (zbuf_scatter.zbuf_scatter_min_ref, zbuf_scatter.zbuf_scatter_min):
        got = _port_zbuf0(vic, uic, z, ok, h, w, fn)
        assert got.shape == (n, h, w) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.reshape(n, h * w).numpy(), want)
    assert (want[0] == DMAX).all()
    if q > 1:
        assert (want[1] < DMAX).sum() <= 4 and want[2].min() < DMAX


def test_plain_takes_negative_values_and_zeros():
    """The key map of the CUDA kernel orders negative depths below positive
    ones; the plain version and JAX agree on them (a pixel gets -0.0 or
    +0.0, never both, where the two are compared as equal)."""
    rng = np.random.default_rng(7)
    n, q, h, w = 2, 400, 8, 8
    flat = rng.integers(0, h * w, (n, q)).astype(np.int32)
    zz = rng.uniform(-30.0, 30.0, (n, q)).astype(np.float32)
    flat[:, :3] = [5, 6, 7]
    zz[:, :3] = [-0.0, 0.0, -1e-30]
    zz[flat == 5] = np.where(zz[flat == 5] > 0, zz[flat == 5], -0.0)
    zz[flat == 6] = np.abs(zz[flat == 6])
    got = zbuf_scatter.zbuf_scatter_min_ref(torch.from_numpy(flat),
                                            torch.from_numpy(zz), h, w, DMAX)
    want = jax.vmap(lambda f, v: jnp.full((h * w,), DMAX).at[f].min(v))(
        jnp.asarray(flat), jnp.asarray(zz))
    np.testing.assert_array_equal(got.reshape(n, -1).numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    assert (got.reshape(n, -1)[:, 5].numpy().view(np.int32)
            == np.float32(-0.0).view(np.int32)).all()
    assert got.min() < -20


def _pallas_zbuf(flat, zz, n, q, cam):
    """tools/bench_scatter.py's zbuf_kernel / zbuf_pallas (lines 94-117),
    run in interpret mode.  As written there the kernel stores a 2-D value
    into its 3-D (1, cam, cam) block and indexes it with two indices, which
    raises "Invalid shape for swap" at trace (the tool's try/except prints
    "pallas kernel failed"); here the block's leading index 0 is written
    out, and nothing else changes."""
    def zbuf_kernel(flat_ref, z_ref, out_ref):
        out_ref[0] = jnp.full((cam, cam), DMAX, jnp.float32)

        def body(i, _):
            f = flat_ref[0, i]
            v = f // cam
            u = f % cam
            old = out_ref[0, v, u]
            out_ref[0, v, u] = jnp.minimum(old, z_ref[0, i])
            return 0
        jax.lax.fori_loop(0, q, body, 0)

    return pl.pallas_call(
        zbuf_kernel,
        out_shape=jax.ShapeDtypeStruct((n, cam, cam), jnp.float32),
        grid=(n,),
        in_specs=[
            pl.BlockSpec((1, q), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, q), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, cam, cam), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(flat, zz)


def test_plain_equals_the_pallas_kernel():
    """The tool's own inputs (RandomState(0), depths in [1, 30), 70%
    valid, flat = vi * cam + ui, zz = where(ok, z, DMAX)) at 3 envs, 300
    points and a 16x16 image, plus a pile-up of every point of env 1 on
    one pixel."""
    n, q, cam = 3, 300, 16
    rng = np.random.RandomState(0)
    vi = rng.randint(0, cam, (n, q)).astype(np.int32)
    ui = rng.randint(0, cam, (n, q)).astype(np.int32)
    z = rng.uniform(1.0, 30.0, (n, q)).astype(np.float32)
    ok = rng.rand(n, q) < 0.7
    vi[1], ui[1] = 3, 5
    flat = vi * cam + ui
    zz = np.where(ok, z, DMAX).astype(np.float32)
    want = np.asarray(_pallas_zbuf(jnp.asarray(flat), jnp.asarray(zz), n, q,
                                   cam))
    got = zbuf_scatter.zbuf_scatter_min(torch.from_numpy(flat),
                                        torch.from_numpy(zz), cam, cam, DMAX)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[1] < DMAX).sum() == 1 and want[1, 3, 5] == zz[1][ok[1]].min()


@pytest.mark.parametrize("footprint", [1, 0, 2])
def test_scatter_vis_equals_jax_zbuf_vis(footprint):
    """zbuf_scatter_vis_px against JAX's zbuf_vis_px(zbuf_impl="scatter"):
    the pooled z-buffer and the visibility (the pooled depth read rounded
    to bf16, the slack not widened) bit for bit."""
    n, q, h, w = 4, 2000, 24, 40
    vic, uic, z, ok = _inputs(n, q, h, w, footprint)
    veps = np.array([0.15, 0.2, 0.1, 0.17], np.float32)
    fn = jax.jit(jax.vmap(lambda v, u, zz, o, e: jax_splat.zbuf_vis_px(
        v, u, zz, o, h, w, DMAX, e, footprint, "scatter")))
    zbuf_j, vis_j = fn(*map(jnp.asarray, (vic, uic, z, ok, veps)))
    zbuf, vis = splat.zbuf_scatter_vis_px(
        *map(torch.from_numpy, (vic, uic, z, ok)), h, w, DMAX,
        torch.from_numpy(veps), footprint)
    np.testing.assert_array_equal(zbuf.numpy(), np.asarray(zbuf_j))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(vis_j))
    assert not vis[0].any() and vis[2:].any()


def test_rejects_what_the_kernel_does_not_take():
    flat = torch.zeros(2, 5, dtype=torch.int32)
    zz = torch.ones(2, 5)
    with pytest.raises(TypeError):
        zbuf_scatter.zbuf_scatter_min(flat.long(), zz, 4, 4, DMAX)
    with pytest.raises(TypeError):
        zbuf_scatter.zbuf_scatter_min(flat, zz.double(), 4, 4, DMAX)
    with pytest.raises(ValueError):
        zbuf_scatter.zbuf_scatter_min(flat, zz[:, :4], 4, 4, DMAX)
    with pytest.raises(ValueError):
        zbuf_scatter.zbuf_scatter_min(flat[0], zz[0], 4, 4, DMAX)
    with pytest.raises(ValueError):
        zbuf_scatter.zbuf_scatter_min(flat.t(), zz.t(), 4, 4, DMAX)
    before = kernels.launches()["zbuf_scatter_min"]
    zbuf_scatter.zbuf_scatter_min(flat, zz, 4, 4, DMAX)
    assert kernels.launches()["zbuf_scatter_min"] == before, \
        "the plain version on the CPU is not a launch"
