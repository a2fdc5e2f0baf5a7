"""The PyTorch port's spec and config against the JAX package's, and the
port's independence from jax."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
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
    "env.renderer.zbuf_impl=pallas", "env.renderer.scatter_impl=pallas",
    "env.renderer.zbuf_impl=scatter",
    "env.renderer.merge_vis_carve=true", "env.renderer.compact_cap_frac=0.5",
    "env.renderer.band_split=8", "env.renderer.mode=dda",
    "env.renderer.mode=replay", "env.renderer.mode=callback",
    "env.carve_mode=bresenham",
])
def test_pallas_renderer_settings_accepted(override):
    """Every renderer setting of the JAX config is accepted, with the same
    config tree (tests/test_torch_dda_env.py runs the env under each)."""
    got = pt_config.apply_overrides(pt_config.Config(), (override,))
    want = jax_config.apply_overrides(jax_config.Config(), (override,))
    assert pt_config.config_to_dict(got) == jax_config.config_to_dict(want)


def test_bad_impl_name_rejected():
    with pytest.raises(ValueError):
        pt_config.RendererConfig(gather_impl="fused")


# the modules of the continuous-control slices (the drone, then the legged
# robots, terrain, the recurrent family and the torsos), of the
# off-policy family and of the mesh slice, each the JAX package's module
# of the same path
CONTINUOUS_MODULES = (
    "utils.normalizer", "env.synthetic", "utils.env_checker", "env.wrappers",
    "utils.math", "models.gaussian", "models.actor_critic",
    "algo.ppo_continuous", "algo.on_policy_runner", "env.drone_robot",
    "registry", "train.train_rsl", "env.legged_robot", "env.terrain",
    "models.torso", "algo.ppo_recurrent", "models.off_policy_nets",
    "algo.replay_buffer", "algo.off_policy", "algo.dqn", "algo.her",
    "parallel.mesh", "utils.episode_plotter")


def test_package_imports_without_jax():
    """Every module of the port imports with jax, flax, optax and the JAX
    package blocked."""
    code = (
        "import sys\n"
        "for blocked in ('jax', 'flax', 'optax', 'gennbv_tpu'):\n"
        "    sys.modules[blocked] = None\n"
        "import pkgutil, importlib, gennbv_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "gennbv_tpu_torch.__path__, 'gennbv_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'gennbv_tpu_torch.env.recon_env' in names, names\n"
        f"for m in {CONTINUOUS_MODULES!r}:\n"
        "    assert 'gennbv_tpu_torch.' + m in names, m\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


def test_continuous_modules_mirror_the_jax_package():
    import importlib
    for m in CONTINUOUS_MODULES:
        assert os.path.exists(os.path.join(REPO, "gennbv_tpu", *m.split("."))
                              + ".py"), m
        importlib.import_module(f"gennbv_tpu_torch.{m}")


@pytest.mark.parametrize("entry", ["env.scene.make_scenes",
                                   "env.scene.generate_procedural",
                                   "models.policy.ActorCriticPolicy",
                                   "models.encoder.HybridEncoder",
                                   "env.drone_robot.DroneRobot",
                                   "env.synthetic.PointGoalEnv",
                                   "env.synthetic.IdentityEnvMultiDiscrete",
                                   "env.synthetic.GoalPointEnv",
                                   "models.actor_critic.GaussianActorCritic",
                                   "utils.normalizer.init",
                                   "registry.make_env",
                                   "env.legged_robot.LeggedRobot",
                                   "env.terrain.generate_terrain",
                                   "models.actor_critic.RecurrentActorCritic",
                                   "models.torso.NatureCNN",
                                   "models.torso.MlpTorso",
                                   "models.torso.CnnPolicy",
                                   "models.off_policy_nets.QCritic",
                                   "models.off_policy_nets.DeterministicActor",
                                   "models.off_policy_nets.SquashedGaussianActor",
                                   "models.off_policy_nets.DiscreteQNet",
                                   "algo.replay_buffer.init",
                                   "algo.her.init_episode_buffer",
                                   "graft_entry.entry"])
def test_entry_points_build_on_the_card_by_default(entry):
    """The port's entry points run on the card unless the caller asks for
    the CPU (the CPU tests pass device="cpu")."""
    import importlib
    import inspect
    module, name = entry.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"gennbv_tpu_torch.{module}"), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
