"""``gennbv_tpu_torch/ops/fp32.py`` reproduces the float32 rounding of the
JAX reference's jitted CPU code, helper by helper.  If a jax upgrade
changes XLA's choices, this file says which helper to revisit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu_torch.ops import fp32


def _rng_f32(seed, shape, lo=-5.0, hi=5.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def test_fma_matches_xla_contraction():
    a, b, c = (_rng_f32(i, 4096) for i in range(3))
    want = jax.jit(lambda a, b, c: a * b + c)(a, b, c)
    got = fp32.fma(*map(torch.from_numpy, (a, b, c)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("c", [3.0, 10.0, 24.0, 64.0, 100.0])
def test_div_const_matches_xla(c):
    x = _rng_f32(4, 4096, 0.0, 30.0)
    want = jax.jit(lambda x: x / c)(x)
    np.testing.assert_array_equal(fp32.div_const(torch.from_numpy(x), c).numpy(),
                                  np.asarray(want))


def test_means_of_three_match_xla():
    x = _rng_f32(5, (512, 3), 0.1, 12.0)
    want = jax.jit(jax.vmap(jnp.mean))(x)
    np.testing.assert_array_equal(fp32.mean3(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))
    # the env's visibility slack: mean((box_hi - box_lo) / R)
    hi, lo = _rng_f32(6, (512, 3), 4.0, 7.0), _rng_f32(7, (512, 3), -7.0, -4.0)
    for r in (16, 24, 64):
        want = jax.jit(jax.vmap(lambda h, l: jnp.mean((h - l) / r)))(hi, lo)
        got = fp32.mean3_of_scaled(torch.from_numpy(hi) - torch.from_numpy(lo), r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("q", [1024, 8000, 11264])
def test_rotate_matches_xla_projection_dot(q):
    """The projection dot of splat.py:36 / carve.py:136, batched over envs
    as the JAX env vmaps it."""
    d = _rng_f32(8, (4, q, 3), -10.0, 10.0)
    r = np.random.default_rng(9).standard_normal((4, 3, 3)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda d, r: d @ r))(d, r)
    got = fp32.rotate(torch.from_numpy(d), torch.from_numpy(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cos_sin_correctly_rounded():
    x = _rng_f32(10, 2048, -7.0, 7.0)
    c, s = fp32.cos_sin(torch.from_numpy(x))
    np.testing.assert_array_equal(c.numpy(), np.cos(x.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(s.numpy(), np.sin(x.astype(np.float64)).astype(np.float32))
