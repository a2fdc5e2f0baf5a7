"""The slice's path at a small size: the env on the JAX package's batched
splat path (``renderer.zbuf_impl="pallas"``, ``scatter_impl="pallas"``,
with the per-scene init-view cache) and the held-out evaluation, each
beside the JAX package's.  The JAX Pallas kernels run in interpret mode.

Pose history, the tri-class grid, rewards, dones, timeouts, collisions and
coverage are exact; grayscale frames are held to 1e-4 (the antialiased
resize, as in the mapping golden); eval metrics to 1e-6, and with the
accuracy scan exactly, but for the GT sampling floor (1e-6 relative)."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import config as jax_config
from gennbv_tpu.algo import evaluation as jax_evaluation
from gennbv_tpu.env import ReconEnv as JaxReconEnv
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu.models import distributions as jax_dist
from gennbv_tpu.models import init_policy
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch.algo import evaluation as pt_evaluation
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.models import convert
from gennbv_tpu_torch.models import distributions as pt_dist
from gennbv_tpu_torch.models.policy import ActorCriticPolicy

N_ENVS, HW, RES = 4, 48, 24
N_STATE = 600 + 8000          # pose history + tri-class grid of the obs


def _cfgs(max_len, seed, eval_env=False):
    cfgs = []
    for mod in (jax_config, pt_config):
        cfg = mod.EnvConfig(
            num_envs=N_ENVS, max_episode_length=max_len,
            camera=mod.CameraConfig(height=HW, width=HW),
            renderer=mod.RendererConfig(resolution=RES, zbuf_impl="pallas",
                                        scatter_impl="pallas"),
            scene=mod.SceneConfig(num_scenes=N_ENVS, seed=seed))
        if eval_env:
            cfg = dataclasses.replace(mod.eval_env_config(cfg),
                                      num_envs=N_ENVS, max_episode_length=max_len)
        cfgs.append(cfg)
    return cfgs


def _envs(max_len, seed, eval_env=False):
    jcfg, pcfg = _cfgs(max_len, seed, eval_env)
    jenv = JaxReconEnv(jcfg, jax_scene.generate_procedural(jcfg.scene, RES))
    penv = ReconEnv(pcfg, make_scenes(pcfg.scene, RES, "cpu"))
    return jenv, penv


def _assert_same_obs(pobs, jobs, t):
    pobs, jobs = pobs.numpy(), np.asarray(jobs)
    np.testing.assert_array_equal(pobs[:, :N_STATE], jobs[:, :N_STATE],
                                  err_msg=f"step {t}: pose/grid obs")
    np.testing.assert_allclose(pobs[:, N_STATE:], jobs[:, N_STATE:], rtol=0,
                               atol=1e-4, err_msg=f"step {t}: frames")


def test_batched_splat_env_matches_jax_env():
    """3-step episodes over 7 steps: envs 0-1 fly into the house (a
    collision at step 1), the others time out at step 2 and again at 5, so
    fresh envs take the init-view cache on the reset step and mid-run."""
    jenv, penv = _envs(3, 11)
    c_hit, c_trav, c_gray = penv._init_cache
    j_hit, j_trav, j_gray = (np.asarray(x) for x in jenv._init_cache)
    np.testing.assert_array_equal(c_hit.numpy(), j_hit)
    np.testing.assert_array_equal(c_trav.numpy(), j_trav)
    np.testing.assert_allclose(c_gray.numpy(), j_gray, rtol=0, atol=1e-4)
    assert j_hit.any(axis=(1, 2, 3)).all(), "every init view hits the house"

    rng = np.random.default_rng(0)
    acts = np.stack([rng.integers(0, k, (6, N_ENVS))
                     for k in (81, 81, 51, 1, 13, 13)], -1).astype(np.int32)
    acts[1:4, :2, :3] = (40, 40, 3)           # x = y = 0, z = 0.7 m
    jstate, jout = jenv.reset(N_ENVS)
    pstate, pout = penv.reset(N_ENVS)
    seen = {"collision": 0, "time_out": 0}
    for t in range(7):
        _assert_same_obs(pout.obs, jout.obs, t)
        for name in pout._fields[1:]:
            np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                          np.asarray(getattr(jout, name)),
                                          err_msg=f"step {t}: {name}")
        for name in pstate._fields[2:]:
            np.testing.assert_array_equal(getattr(pstate, name).numpy(),
                                          np.asarray(getattr(jstate, name)),
                                          err_msg=f"step {t}: state.{name}")
        for key in seen:
            seen[key] += int(np.asarray(getattr(jout, key)).sum())
        if t == 6:
            break
        jstate, jout = jenv.step(jstate, jnp.asarray(acts[t]))
        pstate, pout = penv.step(pstate, torch.from_numpy(acts[t]))
    assert seen["collision"] > 0 and seen["time_out"] > 0


@pytest.fixture(scope="module")
def policies():
    """The JAX policy and its port, with non-trivial BatchNorm statistics
    and the action head scaled up, so that the argmax of each action
    component has a clear winner in float32."""
    model, variables = init_policy(jax_config.ModelConfig(), jax.random.PRNGKey(5))
    variables = jax.device_get(variables)
    rng = np.random.default_rng(0)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    for bn in stats["encoder"].values():
        bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    params = jax.tree.map(np.asarray, variables["params"])
    params["action_net"]["kernel"] = params["action_net"]["kernel"] * 300.0
    variables = {"params": params, "batch_stats": stats}
    policy = ActorCriticPolicy(pt_config.ModelConfig(), device="cpu")
    policy.load_state_dict(convert.jax_to_state_dict(variables))
    return model, variables, policy


def test_evaluate_matches_jax_evaluate(policies):
    """4 held-out scenes, 6-step eval episodes: the deterministic actions
    are equal step by step, and every metric of ``evaluate`` agrees."""
    model, variables, policy = policies
    jenv, penv = _envs(6, 100, eval_env=True)

    jstate, jout = jenv.reset(N_ENVS)
    pstate, pout = penv.reset(N_ENVS)
    policy.eval()
    for t in range(6):
        _assert_same_obs(pout.obs, jout.obs, t)
        ja = np.asarray(jax_dist.mode(
            model.apply(variables, jout.obs, train=False).logits))
        with torch.no_grad():
            pa = pt_dist.mode(policy(pout.obs).logits)
        np.testing.assert_array_equal(pa.numpy(), ja, err_msg=f"step {t}")
        jstate, jout = jenv.step(jstate, jnp.asarray(ja))
        pstate, pout = penv.step(pstate, pa)
        np.testing.assert_array_equal(pout.reward.numpy(), np.asarray(jout.reward))

    policy.train()
    want = jax_evaluation.evaluate(jenv, model, variables, compute_accuracy=False)
    got = pt_evaluation.evaluate(penv, policy, compute_accuracy=False)
    assert policy.training, "evaluate restores the policy's mode"
    for name in ("mean_reward", "std_reward", "mean_ep_length", "mean_auc",
                 "mean_final_coverage", "mean_init_coverage", "mean_curve_auc",
                 "per_env_coverage", "per_env_auc"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert np.isnan(got.mean_accuracy_cm) and np.isnan(want.mean_accuracy_cm)
    assert 1.0 <= got.mean_ep_length <= 6.0
    assert 0.0 < got.mean_init_coverage <= got.mean_final_coverage <= 1.0
    assert got.mean_reward <= got.mean_final_coverage + 1e-4
    # the accuracy scan (the default) leaves every other result as it was
    with_scan = pt_evaluation.evaluate(penv, policy)
    for name in got._fields[:5] + got._fields[6:10]:
        np.testing.assert_array_equal(getattr(with_scan, name),
                                      getattr(got, name), err_msg=name)
    assert np.isfinite(with_scan.mean_accuracy_cm)


def test_evaluate_with_accuracy_matches_jax_evaluate(policies):
    """compute_accuracy=True (the default) on 4 held-out scenes, 6-step
    episodes that end early in collisions, the scan's sub-rays at stride 4:
    every EvalResult field equals the JAX evaluate's, but the GT sampling
    floor, whose mean JAX sums on its device in XLA's order (1e-6
    relative)."""
    model, variables, policy = policies
    jenv, penv = _envs(6, 100, eval_env=True)
    want = jax_evaluation.evaluate(jenv, model, variables, point_stride=4)
    got = pt_evaluation.evaluate(penv, policy, point_stride=4)
    for name in got._fields:
        if name == "accuracy_floor_gt_sampling":
            np.testing.assert_allclose(got.accuracy_floor_gt_sampling,
                                       want.accuracy_floor_gt_sampling,
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
    assert got.mean_ep_length < 6, "some episodes end in a collision"
    assert 0 < got.gt_unseen_frac < 1
    assert got.mean_accuracy_cm == pytest.approx(
        got.accuracy_scan2gt + got.accuracy_gt2scan)
