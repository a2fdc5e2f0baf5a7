"""The port's GAE (``gennbv_tpu_torch/algo/gae.py``) against the JAX
package's ``compute_gae`` on the same seeded inputs."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu.algo import gae as jax_gae
from gennbv_tpu_torch.algo import gae


@pytest.mark.parametrize("t,n,seed", [(16, 4, 0), (128, 8, 1)])
def test_gae_matches_jax(t, n, seed):
    """Episode ends at ~15% of the steps; the same float32 recurrence on
    both sides, which XLA may contract into fused multiply-adds: advantages
    and returns (magnitudes up to ~20 over 128 steps) agree to 1e-5."""
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(t, n)).astype(np.float32)
    values = rng.normal(size=(t, n)).astype(np.float32)
    dones = rng.random((t, n)) < 0.15
    last_values = rng.normal(size=n).astype(np.float32)
    want_adv, want_ret = jax_gae.compute_gae(
        jnp.asarray(rewards), jnp.asarray(values),
        jnp.asarray(dones.astype(np.float32)), jnp.asarray(last_values),
        0.99, 0.95)
    adv, ret = gae.compute_gae(torch.from_numpy(rewards), torch.from_numpy(values),
                               torch.from_numpy(dones), torch.from_numpy(last_values),
                               0.99, 0.95)
    assert adv.dtype == torch.float32 and adv.shape == (t, n)
    np.testing.assert_allclose(adv.numpy(), np.asarray(want_adv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(want_ret), rtol=0, atol=1e-5)


def test_gae_cuts_at_episode_ends():
    """With every step terminal, the advantage is the one-step TD error
    r - v: nothing flows across a done."""
    rewards = torch.tensor([[1.0], [2.0], [3.0]])
    values = torch.tensor([[0.5], [0.25], [1.0]])
    adv, ret = gae.compute_gae(rewards, values, torch.ones(3, 1, dtype=torch.bool),
                               torch.tensor([9.0]), 0.9, 0.8)
    assert torch.equal(adv, rewards - values)
    assert torch.equal(ret, rewards)
