"""The port's entry points switch on the settings under which training on
the card reproduces itself from its seed (``fp32.deterministic_fp32``:
full float32, deterministic cuDNN algorithms chosen without timing, a
fixed cuBLAS workspace), and no configuration key turns them off: the JAX
reference is deterministic by construction and has no such key.  The card
itself is held to it by tests/test_torch_card.py and chip_smoke.py phase 7
(two Runners from one seed, bit-equal)."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import os

import numpy as np
import pytest
import torch

from gennbv_tpu_torch import config, spec
from gennbv_tpu_torch.algo import ppo
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.ops import fp32

NARROW = config.ModelConfig(pose_mlp_hidden=16, grid_channels=2, fused_dim=16)


def _env():
    cfg = config.EnvConfig(num_envs=2, camera=config.CameraConfig(height=16, width=16),
                           renderer=config.RendererConfig(resolution=16),
                           scene=config.SceneConfig(num_scenes=2, seed=3))
    ReconEnv(cfg, make_scenes(cfg.scene, 16, device="cpu"))


def _policy():
    ActorCriticPolicy(NARROW, torch.Generator().manual_seed(0), device="cpu")


def _update():
    policy = ActorCriticPolicy(NARROW, torch.Generator().manual_seed(0), device="cpu")
    _reset_settings()          # the constructor above has set them already
    rng = np.random.default_rng(0)
    m = 16
    obs = torch.from_numpy(np.concatenate([
        rng.uniform(-8, 10, (m, spec.STATE_DIM)),
        rng.choice([-1.0, 0.0, 1.0], (m, spec.GRID_DIM)),
        rng.uniform(0, 255, (m, spec.RGB_DIM))], -1).astype(np.float32))
    actions = torch.from_numpy(np.stack(
        [rng.integers(0, k, m) for k in spec.NVEC], -1).astype(np.int32))
    zeros = torch.zeros(m)
    cfg = config.PPOConfig(n_steps=8, batch_size=8, n_epochs=1, target_kl=None)
    opt = ppo.make_optimizer(cfg, 2)
    ppo.update(policy, opt, cfg, opt.init(policy), obs, actions, zeros, zeros,
               torch.from_numpy(rng.normal(0, 1, m).astype(np.float32)), zeros,
               torch.Generator().manual_seed(1), num_envs=2)


def _reset_settings():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True


@pytest.fixture
def settings_off(monkeypatch):
    """Every setting at the opposite value, restored after the test."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    # set, then delete: monkeypatch records the variable's first state
    # (unset or not) and restores it, whatever the entry point writes
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", "unset by the test")
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    _reset_settings()
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved


@pytest.mark.parametrize("entry", [_env, _policy, _update],
                         ids=["env", "policy", "ppo_update"])
def test_entry_points_switch_the_deterministic_settings_on(settings_off, entry):
    entry()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == fp32.CUBLAS_WORKSPACE_CONFIG == ":4096:8"


def test_a_workspace_setting_of_the_environment_is_kept(settings_off, monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    fp32.deterministic_fp32()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark


def _keys(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _keys(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}"


def test_no_config_key_controls_determinism():
    keys = list(_keys(config.config_to_dict(config.Config())))
    assert len(keys) > 50
    words = ("determin", "cudnn", "cublas", "tf32", "benchmark", "reproduc")
    assert not [k for k in keys if any(w in k.lower() for w in words)]
    for key in ("runner.deterministic", "ppo.cudnn_benchmark",
                "model.deterministic"):
        with pytest.raises(AttributeError):
            config.apply_overrides(config.Config(), (f"{key}=false",))
