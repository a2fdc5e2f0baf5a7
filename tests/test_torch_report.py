"""The port's post-training report path at a tiny size: the runner's
accuracy metrics, ``gennbv_tpu_torch/tools/post_run.py`` on a port run
directory (each family's numbers beside the JAX ``evaluate`` on the same
weights and scenes), ``train/play.py``'s artifacts, the ``torch.export``
policy, the episode recorder and the native mesher.

The eval protocol's 50 envs x 30 steps are cut to 4 x 5 here by setting
the port's spec constants for the test (``eval_env_config`` and post_run
read them when called).  The report is rounded as the JAX report is; its
numbers equal the JAX evaluate's rounded alike (the GT sampling floor to
1e-3, its last rounded digit)."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from gennbv_tpu import config as jax_config
from gennbv_tpu.algo import evaluation as jax_evaluation
from gennbv_tpu.env import ReconEnv as JaxReconEnv
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu.models import init_policy
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch import spec as pt_spec
from gennbv_tpu_torch.algo import ppo
from gennbv_tpu_torch.algo.runner import Runner
from gennbv_tpu_torch.env import make_scenes
from gennbv_tpu_torch.models import convert, distributions
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.tools import post_run
from gennbv_tpu_torch.train import play
from gennbv_tpu_torch.utils.checkpoint import CheckpointManager
from gennbv_tpu_torch.utils.episode_video import EpisodeVideoRecorder
from gennbv_tpu_torch.utils.logger import Logger
from gennbv_tpu_torch.utils.native import mesh_voxels_to_obj

HW, RES, N_EVAL, T_EVAL, STRIDE = 32, 16, 4, 5, 4
REFERENCE_REPORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reports", "r5_refbudget128", "report.json")


def _without_tensorboard(monkeypatch):
    """The Logger goes on without TensorBoard when it cannot import it;
    here it skips the import, which takes seconds."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture
def small_eval(monkeypatch):
    monkeypatch.setattr(pt_spec, "EVAL_NUM_ENVS", N_EVAL)
    monkeypatch.setattr(pt_spec, "MAX_EPISODE_LENGTH_EVAL", T_EVAL)


def _train_config(**runner):
    cfg = pt_config.Config(
        env=pt_config.EnvConfig(
            num_envs=4, camera=pt_config.CameraConfig(height=HW, width=HW),
            renderer=pt_config.RendererConfig(resolution=RES),
            scene=pt_config.SceneConfig(num_scenes=4, seed=0)),
        ppo=pt_config.PPOConfig(n_steps=4, batch_size=8, n_epochs=1))
    return dataclasses.replace(cfg, runner=dataclasses.replace(cfg.runner,
                                                               **runner))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port run directory (config.json from the port's Logger, two
    checkpoints) holding a policy converted from JAX weights; returns
    (path, the JAX model and variables)."""
    model, variables = init_policy(jax_config.ModelConfig(),
                                   jax.random.PRNGKey(7))
    variables = jax.device_get(variables)
    params = jax.tree.map(np.asarray, variables["params"])
    # a decisive action head, so each argmax has a clear float32 winner
    params["action_net"]["kernel"] = params["action_net"]["kernel"] * 300.0
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    policy = ActorCriticPolicy(pt_config.ModelConfig(), device="cpu")
    policy.load_state_dict(convert.jax_to_state_dict(variables))

    path = tmp_path_factory.mktemp("run")
    cfg = _train_config()
    with pytest.MonkeyPatch.context() as mp:
        _without_tensorboard(mp)
        Logger(str(path), config=pt_config.config_to_dict(cfg)).close()
    mgr = CheckpointManager(str(path / "models"))
    opt_state = ppo.make_optimizer(cfg.ppo, 4).init(policy)
    mgr.save_step(64, policy, opt_state)
    mgr.save_best("episode_reward", policy, opt_state, 64)
    mgr.save_best("eval_coverage", policy, opt_state, 64)
    return str(path), model, variables


def _jax_family(dataset, seed):
    cfg = jax_config.eval_env_config(jax_config.EnvConfig(
        camera=jax_config.CameraConfig(height=HW, width=HW),
        renderer=jax_config.RendererConfig(resolution=RES),
        scene=jax_config.SceneConfig(num_scenes=N_EVAL, seed=seed,
                                     dataset=dataset)))
    cfg = dataclasses.replace(cfg, num_envs=N_EVAL, max_episode_length=T_EVAL)
    return JaxReconEnv(cfg, jax_scene.generate_procedural(cfg.scene, RES))


def test_post_run_report_matches_jax_evaluate(run_dir, small_eval):
    path, model, variables = run_dir
    report = post_run.main([path, "--device", "cpu", "--no-artifacts",
                            "--point_stride", str(STRIDE)])
    with open(os.path.join(path, "report.json")) as f:
        assert json.load(f) == report
    with open(REFERENCE_REPORT) as f:
        reference = json.load(f)
    assert report["checkpoint"] == "rl_model_best_eval_coverage"
    assert report["point_stride"] == STRIDE
    for tag, dataset, seed in (("held_out_houses", "procedural", 100),
                               ("objects_zero_shot", "objects", 101),
                               ("convex_floor_probe", "convex", 102)):
        got = report[tag]
        assert set(got) == set(reference[tag]), tag
        assert all(np.isfinite(v) for v in got.values()), tag
        res = jax_evaluation.evaluate(_jax_family(dataset, seed), model,
                                      variables, point_stride=STRIDE)
        want = post_run.family_report(res)
        floor = "accuracy_floor_gt_sampling"
        assert abs(got.pop(floor) - want.pop(floor)) <= 1e-3, tag
        assert got == want, tag


def test_post_run_picks_checkpoints_and_refuses_datasets(tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    with pytest.raises(FileNotFoundError):
        post_run.pick_checkpoint(str(models))
    for name in ("rl_model_64_steps", "rl_model_1024_steps",
                 "rl_model_best_episode_reward"):
        (models / name).write_bytes(b"")
    assert post_run.pick_checkpoint(str(models)) == "rl_model_best_episode_reward"
    (models / "rl_model_best_episode_reward").unlink()
    assert post_run.pick_checkpoint(str(models)) == "rl_model_1024_steps"
    # the held-out family's dataset: --holdout_dataset, else the run's
    # recorded eval dataset, else its training dataset (the JAX rule)
    raw = {"env": {"scene": {"dataset": "objects"}}}
    fams = post_run.families(raw, 100, holdout_dataset="data_rehearsal/eval")
    assert fams == (("held_out_houses", "data_rehearsal/eval", 100),
                    ("objects_zero_shot", "objects", 101),
                    ("convex_floor_probe", "convex", 102))
    assert post_run.families(dict(raw, eval_dataset="/d/eval"), 7)[0] == (
        "held_out_houses", "/d/eval", 7)
    assert post_run.families(dict(raw, eval_dataset="/d/eval"), 7,
                             "/d/other")[0][1] == "/d/other"
    assert post_run.families(raw, 7)[0] == ("held_out_houses", "objects", 7)
    assert post_run.families({}, 7)[0][1] == "procedural"


def test_runner_logs_accuracy_and_post_run_reads_its_run(tmp_path, small_eval,
                                                         monkeypatch):
    """runner.eval_accuracy=True logs the six accuracy keys of the JAX
    runner; post_run then reports on the run directory the Runner wrote,
    with play's artifacts, and export_report copies the evidence under the
    given root."""
    _without_tensorboard(monkeypatch)
    cfg = _train_config(eval_freq=1, eval_accuracy=True, save_freq=1, seed=3)
    eval_scenes = make_scenes(dataclasses.replace(
        cfg.env.scene, num_scenes=N_EVAL, seed=100), RES, "cpu")
    runner = Runner(cfg, eval_scenes=eval_scenes, log_dir=str(tmp_path),
                    device="cpu")
    try:
        metrics = runner.train(1)
    finally:
        runner.close()
    keys = ("eval/mean_accuracy", "eval/accuracy_scan2gt",
            "eval/accuracy_gt2scan", "eval/accuracy_gt2scan_seen",
            "eval/gt_unseen_frac", "eval/accuracy_floor_gt_sampling")
    for k in keys:
        assert np.isfinite(metrics[k]), k
    with open(tmp_path / "metrics.jsonl") as f:
        logged = json.loads(f.readline())
    assert all(logged[k] == metrics[k] for k in keys)
    assert metrics["eval/mean_accuracy"] == pytest.approx(
        metrics["eval/accuracy_scan2gt"] + metrics["eval/accuracy_gt2scan"])

    report = post_run.main([str(tmp_path), "--device", "cpu",
                            "--only", "held_out_houses"])
    assert report["checkpoint"] == "rl_model_best_eval_coverage"
    assert set(report) == {"checkpoint", "held_out_dataset", "eval_cam",
                           "held_out_houses", "artifacts"}
    # no eval dataset recorded: the training family, as the JAX post_run
    assert report["held_out_dataset"] == "procedural"
    assert report["eval_cam"] == 0
    assert sorted(os.listdir(report["artifacts"])) == [
        "episode.gif", "recon.obj", "recon.ply"]
    out = post_run.export_report(str(tmp_path), "smoke", root=str(tmp_path))
    assert out == str(tmp_path / "reports" / "smoke")
    assert sorted(os.listdir(out)) == ["config.json", "eval_curve.csv",
                                       "last_metrics.json", "report.json"]


def test_play_writes_artifacts_and_export_round_trips(run_dir, tmp_path,
                                                      small_eval):
    path = run_dir[0]
    out = {k: str(tmp_path / f"recon.{k}") for k in ("ply", "gif", "obj")}
    exported = str(tmp_path / "policy.pt2")
    play.main(["--ckpt", os.path.join(path, "models", "rl_model_64_steps"),
               "--ply", out["ply"], "--gif", out["gif"], "--obj", out["obj"],
               "--export", exported, "--num_envs", "2", "--device", "cpu",
               "--set", f"env.camera.height={HW}",
               "--set", f"env.camera.width={HW}",
               "--set", f"env.renderer.resolution={RES}"])
    with open(out["ply"]) as f:
        ply = f.read().splitlines()
    n = int(ply[2].split()[-1])
    assert n > 0 and len(ply) == 7 + n
    with open(out["obj"]) as f:
        obj = f.read()
    assert "\nv " in obj and "\nf " in obj
    from PIL import Image
    with Image.open(out["gif"]) as im:
        # one frame a step; the GIF writer merges identical neighbours
        assert 1 <= im.n_frames <= T_EVAL
        assert im.size[0] == 2 * im.size[1]

    # the exported program gives the eager policy's actions
    run = play.load_exported_policy(exported)
    policy = post_run.load_policy({}, os.path.join(path, "models"),
                                  "rl_model_64_steps", "cpu").eval()
    obs_dim = 600 + 8000 + 8192          # pose history, grid, 2 frames
    obs = torch.randn(2, obs_dim, generator=torch.Generator().manual_seed(0))
    obs[:, 600:8600] = torch.randint(-1, 2, (2, 8000)).float()
    with torch.no_grad():
        want = distributions.mode(policy(obs).logits)
    assert torch.equal(run(obs), want)


def test_export_policy_round_trip_and_recurrent_refusal(tmp_path):
    policy = ActorCriticPolicy(pt_config.ModelConfig(),
                               torch.Generator().manual_seed(2), device="cpu")
    obs_dim = 600 + 8000 + 8192          # pose history, grid, 2 frames
    path = str(tmp_path / "policy.pt2")
    nbytes = play.export_policy(policy, obs_dim, path, batch=3)
    assert nbytes > 1000 and os.path.getsize(path) == nbytes
    assert policy.training, "export restores the policy's mode"
    obs = torch.randn(3, obs_dim, generator=torch.Generator().manual_seed(1))
    policy.eval()
    with torch.no_grad():
        want = distributions.mode(policy(obs).logits)
    assert torch.equal(play.load_exported_policy(path)(obs), want)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        play.export_recurrent_policy(None, None, obs_dim, path)


def test_save_ply_and_episode_video_recorder(tmp_path):
    """tests/test_aux.py's PLY and recorder cases on the port's copies."""
    p = str(tmp_path / "x.ply")
    play.save_ply(p, np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]))
    txt = open(p).read()
    assert "element vertex 2" in txt and "3.0000 4.0000 5.0000" in txt

    rec = EpisodeVideoRecorder(depth_max=10.0, scale=2)
    rng = np.random.RandomState(0)
    for _ in range(5):
        rec.add(rng.uniform(0, 10, (16, 16)), rng.rand(8, 8, 8) > 0.5)
    gif = str(tmp_path / "ep.gif")
    rec.write(gif, fps=2)
    from PIL import Image
    with Image.open(gif) as im:
        assert im.n_frames == 5
        assert im.size[0] == 2 * im.size[1]  # depth panel + coverage panel
    with pytest.raises(ValueError, match="no frames"):
        EpisodeVideoRecorder(10.0).write(str(tmp_path / "y.gif"))


@pytest.mark.parametrize("cells,quads", [([(1, 1, 1)], 6),
                                         ([(1, 1, 1), (1, 1, 2)], 10),
                                         ([], 0)])
def test_mesher_writes_one_quad_per_exposed_face(tmp_path, cells, quads):
    grid = np.zeros((4, 4, 4), np.float32)
    for c in cells:
        grid[c] = 1.0
    path = str(tmp_path / "m.obj")
    assert mesh_voxels_to_obj(grid, [0.0, 0.0, 0.0], [0.5, 0.5, 0.5],
                              path) == quads
    lines = open(path).read().splitlines()
    assert sum(ln.startswith("f ") for ln in lines) == quads
    verts = [list(map(float, ln.split()[1:])) for ln in lines
             if ln.startswith("v ")]
    if cells:
        assert np.min(verts) == 0.5 and np.max(verts) == 0.5 * (
            1 + max(max(c) for c in cells))
    with pytest.raises(ValueError, match="cubic"):
        mesh_voxels_to_obj(np.zeros((2, 3, 4)), [0, 0, 0], [1, 1, 1], path)
