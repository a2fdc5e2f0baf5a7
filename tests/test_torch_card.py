"""Tests of the port that need a CUDA card: the gather kernel against its
plain version, the mapping golden and a rollout with the kernel in use.
They skip on a machine without one.  This file imports no jax, so it also
runs where jax is missing; tests/conftest.py imports jax, so there run it
without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py
"""
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def test_gather_kernel_equals_plain_at_rollout_shapes(cuda):
    import chip_smoke
    assert chip_smoke.phase_kernel()["max_abs_err"] == 0.0


def test_golden_on_card(cuda):
    import chip_smoke
    chip_smoke.phase_golden()


def test_rollout_launches_the_kernel_twice_per_step(cuda):
    from gennbv_tpu_torch import config
    from gennbv_tpu_torch.algo import rollout
    from gennbv_tpu_torch.env import ReconEnv, make_scenes
    from gennbv_tpu_torch.models.policy import ActorCriticPolicy
    from gennbv_tpu_torch.ops import gather

    cfg = config.EnvConfig(num_envs=8, camera=config.CameraConfig(height=32, width=32),
                           renderer=config.RendererConfig(resolution=16),
                           scene=config.SceneConfig(num_scenes=4, seed=1))
    env = ReconEnv(cfg, make_scenes(cfg.scene, 16, "cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    policy = ActorCriticPolicy(config.ModelConfig(), gen, device="cuda")
    before = gather.gather_image.launches
    state, out = env.reset(8)
    _, obs, batch, stats = rollout.collect(env, policy, state, out.obs, gen, 4, 0.99)
    torch.cuda.synchronize()
    assert gather.gather_image.launches - before == 2 * (1 + 4)
    assert obs.is_cuda and torch.isfinite(batch.values).all()
    assert ((stats.coverage >= 0) & (stats.coverage <= 1)).all()
