"""The port's policy against the JAX package's, with the JAX variables
carried over by ``models/convert.py``."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import spec
from gennbv_tpu.config import ModelConfig as JaxModelConfig
from gennbv_tpu.models import distributions as jax_dist
from gennbv_tpu.models import init_policy
from gennbv_tpu_torch.config import ModelConfig
from gennbv_tpu_torch.models import convert
from gennbv_tpu_torch.models import distributions as pt_dist
from gennbv_tpu_torch.models.encoder import positional_encoding
from gennbv_tpu_torch.models.policy import ActorCriticPolicy


def _obs(n, seed):
    """Observations with the env's layout: poses, a tri-class grid, frames."""
    rng = np.random.default_rng(seed)
    pose = rng.uniform(-8, 10, (n, spec.STATE_DIM))
    grid = rng.choice([-1.0, 0.0, 1.0], (n, spec.GRID_DIM))
    rgb = rng.uniform(0, 255, (n, spec.RGB_DIM))
    return np.concatenate([pose, grid, rgb], -1).astype(np.float32)


@pytest.fixture(scope="module")
def converted():
    model, variables = init_policy(JaxModelConfig(), jax.random.PRNGKey(3))
    variables = jax.device_get(variables)
    # non-trivial BN statistics, so the eval-mode normalisation is exercised
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda x: np.asarray(x), variables["batch_stats"])
    for bn in stats["encoder"].values():
        bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    variables = {"params": variables["params"], "batch_stats": stats}
    policy = ActorCriticPolicy(ModelConfig(), device="cpu")
    policy.load_state_dict(convert.jax_to_state_dict(variables))
    return model, variables, policy.eval()


def test_logits_and_value_agree(converted):
    """Full width, batch 8, obs 16792: float32 sums in another order and
    transcendental ulps -> agreement to 1e-5."""
    model, variables, policy = converted
    obs = _obs(8, 1)
    want = model.apply(variables, jnp.asarray(obs), train=False)
    with torch.no_grad():
        got = policy(torch.from_numpy(obs))
    assert got.logits.shape == (8, spec.NUM_LOGITS) and got.value.shape == (8,)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=0, atol=1e-5)


def test_train_mode_batchnorm_matches_flax(converted):
    """A train-mode forward normalises with the batch statistics and moves
    the running stats as Flax's ``mutable=["batch_stats"]`` apply does,
    with the biased batch variance.  The n/(n-1) of PyTorch's own
    BatchNorm3d (n = 16 * 9^3 rows for grid_bn1, 16 * 4^3 for grid_bn2)
    puts grid_bn1's running variance ~1e-5 relative off on this batch
    (grid_bn2's more), outside the 1e-6 held here."""
    model, variables, _ = converted
    policy = ActorCriticPolicy(ModelConfig(), device="cpu")
    policy.load_state_dict(convert.jax_to_state_dict(variables))
    obs = _obs(16, 6)
    want, mutated = model.apply(variables, jnp.asarray(obs), train=True,
                                mutable=["batch_stats"])
    got = policy.train()(torch.from_numpy(obs))
    np.testing.assert_allclose(got.logits.detach().numpy(), np.asarray(want.logits),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.value.detach().numpy(), np.asarray(want.value),
                               rtol=0, atol=1e-5)
    stats = jax.device_get(mutated["batch_stats"]["encoder"])
    for i in (1, 2):
        bn = getattr(policy.encoder, f"grid_bn{i}")
        old = variables["batch_stats"]["encoder"][f"grid_bn{i}"]
        for key, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            want_stat = np.asarray(stats[f"grid_bn{i}"][key])
            assert not np.allclose(want_stat, old[key]), "the stats moved"
            np.testing.assert_allclose(buf.numpy(), want_stat, rtol=1e-6,
                                       atol=1e-7, err_msg=f"grid_bn{i} {key}")
        assert bn.num_batches_tracked == 0


def test_distribution_functions_agree():
    rng = np.random.default_rng(2)
    logits = (rng.normal(0, 3, (16, spec.NUM_LOGITS))).astype(np.float32)
    actions = np.stack([rng.integers(0, k, 16) for k in spec.NVEC], -1).astype(np.int32)
    lt, at = torch.from_numpy(logits), torch.from_numpy(actions)
    np.testing.assert_allclose(pt_dist.log_prob(lt, at).numpy(),
                               np.asarray(jax_dist.log_prob(logits, actions)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt_dist.entropy(lt).numpy(),
                               np.asarray(jax_dist.entropy(logits)), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pt_dist.mode(lt).numpy(),
                                  np.asarray(jax_dist.mode(logits)))


def test_sample_frequencies_follow_softmax():
    """The RNG streams differ from JAX's, so sampling is checked by
    distribution: each component's empirical frequencies against its
    softmax (20k draws; 5 standard errors)."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.normal(0, 1.5, (1, spec.NUM_LOGITS)).astype(np.float32))
    draws = 20000
    gen = torch.Generator().manual_seed(0)
    acts = pt_dist.sample(logits.expand(draws, -1), gen)
    assert acts.dtype == torch.int32 and acts.shape == (draws, 6)
    for i, comp in enumerate(torch.split(logits[0], spec.NVEC)):
        p = torch.softmax(comp, -1).numpy()
        freq = np.bincount(acts[:, i].numpy(), minlength=len(p)) / draws
        se = np.sqrt(p * (1 - p) / draws)
        assert (np.abs(freq - p) <= 5 * se + 1e-12).all(), i
    again = pt_dist.sample(logits.expand(draws, -1), torch.Generator().manual_seed(0))
    assert torch.equal(acts, again), "a seeded generator fixes the draws"


def test_init_is_seeded_and_heads_orthogonal():
    a = ActorCriticPolicy(ModelConfig(), torch.Generator().manual_seed(1),
                          device="cpu")
    b = ActorCriticPolicy(ModelConfig(), torch.Generator().manual_seed(1),
                          device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.action_net.weight                       # [240, 256], gain 0.01
    torch.testing.assert_close(w @ w.T, 1e-4 * torch.eye(240), rtol=0, atol=1e-8)
    v = a.value_net.weight                        # [1, 256], gain 1
    torch.testing.assert_close(v.norm(), torch.tensor(1.0))
    assert a.action_net.bias.abs().sum() == 0


def test_positional_encoding_layout():
    pos = np.random.default_rng(5).normal(size=(2, 3, 6)).astype(np.float32)
    from gennbv_tpu.models.encoder import positional_encoding as jax_pe
    np.testing.assert_allclose(positional_encoding(torch.from_numpy(pos)).numpy(),
                               np.asarray(jax_pe(jnp.asarray(pos))), rtol=0, atol=1e-6)
