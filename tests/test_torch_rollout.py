"""The whole slice: the JAX ``rollout.collect`` (env + policy) at a small
size, replayed through the port.  The RNG streams differ, so the port
takes the JAX run's actions; everything else it computes itself."""
import jax
import numpy as np
import torch

from gennbv_tpu import config as jax_config
from gennbv_tpu.algo import rollout as jax_rollout
from gennbv_tpu.env import ReconEnv as JaxReconEnv
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu.models import init_policy
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch.algo import rollout as pt_rollout
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.models import convert
from gennbv_tpu_torch.models import distributions as pt_dist
from gennbv_tpu_torch.models.policy import ActorCriticPolicy

N_ENVS, N_STEPS, MAX_LEN, GAMMA = 4, 5, 3, 0.99


class _Replay(torch.nn.Module):
    """A policy that plays recorded actions and scores them with `policy`."""

    def __init__(self, policy, actions):
        super().__init__()
        self.policy = policy
        self.actions = iter(actions)

    def forward(self, obs):
        return self.policy(obs)

    @torch.no_grad()
    def act(self, obs, generator=None):
        out = self.policy(obs)
        actions = next(self.actions)
        return actions, out.value, pt_dist.log_prob(out.logits, actions)


def _cfg(mod):
    return mod.EnvConfig(
        num_envs=N_ENVS, max_episode_length=MAX_LEN,
        camera=mod.CameraConfig(height=16, width=16),
        renderer=mod.RendererConfig(resolution=16),
        scene=mod.SceneConfig(num_scenes=4, seed=2))


def test_rollout_replay_matches_jax_collect():
    """Obs (state and grid exact, grayscale frames to 1e-4), dones, timeouts
    and the per-step env stats are equal; values, log-probs and the
    bootstrap-adjusted rewards (which add gamma * V at timeouts) agree to
    1e-5, the policy's float32 tolerance."""
    jcfg = _cfg(jax_config)
    jenv = JaxReconEnv(jcfg, jax_scene.generate_procedural(jcfg.scene, 16))
    model, variables = init_policy(jax_config.ModelConfig(), jax.random.PRNGKey(7))
    state, out = jenv.reset(N_ENVS)
    _, _, jb, js = jax_rollout.collect(jenv, model, variables, state, out.obs,
                                       jax.random.PRNGKey(8), N_STEPS, GAMMA)
    jb, js = jax.device_get((jb, js))

    pcfg = _cfg(pt_config)
    penv = ReconEnv(pcfg, make_scenes(pcfg.scene, 16))
    policy = ActorCriticPolicy(pt_config.ModelConfig())
    policy.load_state_dict(convert.jax_to_state_dict(jax.device_get(variables)))
    replay = _Replay(policy, [torch.from_numpy(np.array(a)) for a in jb.actions])
    pstate, pout = penv.reset(N_ENVS)
    _, _, pb, ps = pt_rollout.collect(penv, replay, pstate, pout.obs, None,
                                      N_STEPS, GAMMA)
    assert policy.training, "collect restores the policy's mode"

    n_state = 600 + 8000
    obs = pb.obs.numpy()
    assert obs.dtype == np.float32 and obs.shape == jb.obs.shape
    np.testing.assert_array_equal(obs[..., :n_state], jb.obs[..., :n_state])
    np.testing.assert_allclose(obs[..., n_state:], jb.obs[..., n_state:],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(pb.actions.numpy(), jb.actions)
    np.testing.assert_array_equal(pb.dones.numpy(), jb.dones)
    for name in js._fields:
        np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                      getattr(js, name), err_msg=name)
    time_outs = ps.ep_length.numpy() == MAX_LEN
    np.testing.assert_array_equal(time_outs, js.ep_length == MAX_LEN)
    assert time_outs.any(), "the run reaches a timeout bootstrap"
    for name in ("values", "log_probs", "last_values", "rewards"):
        np.testing.assert_allclose(getattr(pb, name).numpy(), getattr(jb, name),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_collect_samples_with_generator():
    """Without replay: a seeded generator fixes the rollout, and the
    outputs are finite and well-formed."""
    pcfg = _cfg(pt_config)
    penv = ReconEnv(pcfg, make_scenes(pcfg.scene, 16))
    runs = []
    for _ in range(2):
        policy = ActorCriticPolicy(pt_config.ModelConfig(),
                                   torch.Generator().manual_seed(1))
        state, out = penv.reset(N_ENVS)
        runs.append(pt_rollout.collect(penv, policy, state, out.obs,
                                       torch.Generator().manual_seed(2), 3, GAMMA))
    (_, obs_a, a, stats), (_, obs_b, b, _) = runs
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(obs_a, obs_b)
    assert a.obs.shape == (3, N_ENVS, penv.obs_dim)
    assert torch.isfinite(a.rewards).all()
    # without the timeout bootstrap the env's rewards are never negative
    next_values = torch.cat([a.values[1:], a.last_values[None]])
    time_outs = (stats.ep_length == MAX_LEN).float()
    assert time_outs.any()
    assert (a.rewards - GAMMA * next_values * time_outs >= 0).all()
