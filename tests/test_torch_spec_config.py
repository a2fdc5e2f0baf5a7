"""The PyTorch port's spec and config against the JAX package's, and the
port's independence from jax."""
import dataclasses
import os
import subprocess
import sys

import pytest

from gennbv_tpu import config as jax_config
from gennbv_tpu import spec as jax_spec
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch import spec as pt_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _public(module):
    return {k: v for k, v in vars(module).items()
            if k.isupper() and not k.startswith("_")}


def test_spec_constants_equal():
    want = _public(jax_spec)
    assert want, "the JAX spec exposes public constants"
    assert _public(pt_spec) == want


def test_config_defaults_equal():
    assert pt_config.config_to_dict(pt_config.Config()) == \
        jax_config.config_to_dict(jax_config.Config())
    for name in ("CameraConfig", "RendererConfig", "SceneConfig",
                 "RewardConfig", "EnvConfig", "ModelConfig", "PPOConfig",
                 "RunnerConfig", "Config"):
        pt_fields = [f.name for f in dataclasses.fields(getattr(pt_config, name))]
        jax_fields = [f.name for f in dataclasses.fields(getattr(jax_config, name))]
        assert pt_fields == jax_fields, name


OVERRIDES = (
    "env.camera.height=128", "env.camera.width=128",
    "env.renderer.resolution=64", "env.renderer.gather_impl=pallas",
    "env.scene.num_scenes=256", "env.coverage_done_threshold=none",
    "env.reward.only_positive=false", "ppo.target_kl=0.03",
    "runner.experiment_name=port", "model.grid_channels=8",
)


def test_apply_overrides_same_tree():
    got = pt_config.apply_overrides(pt_config.Config(), OVERRIDES)
    want = jax_config.apply_overrides(jax_config.Config(), OVERRIDES)
    assert pt_config.config_to_dict(got) == jax_config.config_to_dict(want)
    env = pt_config.eval_env_config(pt_config.with_camera(got.env, 400))
    want_env = jax_config.eval_env_config(jax_config.with_camera(want.env, 400))
    assert pt_config.config_to_dict(env) == jax_config.config_to_dict(want_env)
    with pytest.raises(ValueError):
        pt_config.apply_overrides(pt_config.Config(), ("env.num_envs=none",))


@pytest.mark.parametrize("override", [
    "env.renderer.zbuf_impl=pallas", "env.renderer.zbuf_impl=scatter",
    "env.renderer.merge_vis_carve=true", "env.renderer.compact_cap_frac=0.5",
    "env.renderer.band_split=8", "env.renderer.mode=dda",
    "env.carve_mode=bresenham",
])
def test_unsupported_renderer_settings_raise(override):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue"):
        pt_config.apply_overrides(pt_config.Config(), (override,))


def test_bad_impl_name_rejected():
    with pytest.raises(ValueError):
        pt_config.RendererConfig(gather_impl="fused")


def test_package_imports_without_jax():
    """Every module of the port imports with jax blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['optax'] = None\n"
        "import pkgutil, importlib, gennbv_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "gennbv_tpu_torch.__path__, 'gennbv_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'gennbv_tpu_torch.env.recon_env' in names, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
