"""The mesh slice of the port (``gennbv_tpu_torch/parallel/mesh.py``): the
multi-device training of ``gennbv_tpu/algo/runner.py``'s meshes over
``torch.distributed``, one process a rank.

Ranks are gloo CPU processes started by ``parallel.mesh.launch`` over a
FileStore (tests/torch_mesh_ranks.py holds what they run), held to one
process from the same seed, as tests/test_runner.py holds the JAX
package's 8-device runs to its 1-device run:
- the mesh rules: groups, env rows, ``param_plan`` against the JAX
  ``param_spec``, and the settings that raise;
- one update from a fixed rollout at W = 2 and 4, and with W not dividing
  the minibatch shards (the all-gather path); the collectives an update
  makes;
- two Runner iterations at W = 2 and 4, a 2 x 2 multislice mesh and
  2 x 2 tensor parallelism;
- checkpoints across a tensor-parallel and a one-process run, a resume
  under two ranks, and the train CLI under torchrun.
"""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as R
from gennbv_tpu import config as jax_config
from gennbv_tpu.models import init_policy
from gennbv_tpu.parallel import mesh as jax_mesh
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.parallel import mesh as mesh_lib
from gennbv_tpu_torch.train import train_gennbv
from gennbv_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = pt_config.ModelConfig()
# Runner iterations: tests/test_runner.py's tolerances (rollout and update
# metrics; the rollout is bit-equal, the update's sums differ in order)
RUN_RTOL, RUN_ATOL = 2e-3, 2e-4
TP_RTOL, TP_ATOL = 2e-4, 2e-5
# S = 3 minibatch shards of 6 envs on 2 ranks: the all-gather path
GATHER = dict(num_envs=6, n_steps=4, batch_size=6, shards=3)


def _cfg(**kw):
    return R.tiny(**kw)


def _floored(cfg):
    """The entropy floor above the policy's entropy (~17.8): the hinge is
    active at every minibatch."""
    return dataclasses.replace(cfg, ppo=dataclasses.replace(
        cfg.ppo, ent_floor=18.0, ent_floor_coef=0.1))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    return {name: str(root / name)
            for name in ("one", "tp", "cli", "pipe_one", "pipe")}


@pytest.fixture(scope="module")
def one(dirs):
    """The one-process references."""
    return {
        "update": R.update_case("cpu", _cfg()),
        "update_gather": R.update_case("cpu", _cfg(**GATHER)),
        "update_floor": R.update_case("cpu", _floored(_cfg())),
        "train": R.train_case("cpu", _cfg(), 2),
        "train1": R.train_case("cpu", _cfg(), 1),
        "train_full": R.train_case("cpu", _cfg(model=FULL), 2),
        "saved": R.save_case("cpu", _cfg(model=FULL), dirs["one"]),
        "pipelined": R.pipelined_case("cpu", _cfg(depth=1), 2,
                                      dirs["pipe_one"]),
    }


@pytest.fixture(scope="module")
def w2(one, dirs):
    tp = _cfg(num_devices=2, model_axis=2, model=FULL)
    out = mesh_lib.launch(R.cases, 2, [
        ("mesh_case", ()),
        ("update_case", (_cfg(num_devices=2),)),
        ("update_case", (_cfg(num_devices=2, **GATHER),)),
        ("train_case", (_cfg(num_devices=2), 2)),
        ("save_case", (tp, dirs["tp"])),
        ("restore_case", (tp, dirs["one"])),
        ("restore_case", (_cfg(num_devices=2, model=FULL), dirs["one"])),
        ("update_case", (_floored(_cfg(num_devices=2)),)),
        ("pipelined_case", (_cfg(num_devices=2, depth=2), 2, dirs["pipe"])),
    ], device="cpu")
    keys = ("mesh", "update", "update_gather", "train", "saved", "restored",
            "resumed", "update_floor", "pipelined")
    return [dict(zip(keys, rank)) for rank in out]


@pytest.fixture(scope="module")
def w4():
    out = mesh_lib.launch(R.cases, 4, [
        ("mesh_case", ()),
        ("mesh_case", (2, 1)),
        ("mesh_case", (1, 2)),
        ("update_case", (_cfg(num_devices=4),)),
        ("train_case", (_cfg(num_devices=4), 2)),
        ("train_case", (_cfg(num_devices=4, num_slices=2), 1)),
        ("train_case", (_cfg(num_devices=4, model_axis=2, model=FULL), 2)),
        ("train_case", (_cfg(num_devices=4, model=FULL), 2)),
    ], device="cpu")
    keys = ("mesh", "mesh_slices", "mesh_tp", "update", "train", "multislice",
            "tp", "dp_full")
    return [dict(zip(keys, rank)) for rank in out]


# ---------------------------------------------------------------- the rules
def test_mesh_of_one_rank():
    """W = 1 (a FileStore group of one in this process): the whole env
    axis, every row."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            got = R.mesh_case("cpu")
            with pytest.raises(ValueError, match="num_devices"):
                mesh_lib.make_mesh(2)
        finally:
            dist.destroy_process_group()
    assert got == {"shape": {"env": 1}, "env_index": 0, "env_width": 1,
                   "env_group": [0], "reduce_groups": [[0]],
                   "rows": (0, 8)}


@pytest.mark.parametrize("case", ["mesh", "mesh_slices", "mesh_tp"])
def test_mesh_groups_of_four_ranks(w4, case):
    """W = 4 as an 'env' mesh, ('slice', 'env') 2 x 2 and ('env', 'model')
    2 x 2: each rank's env slice in the order of P(('slice', 'env')) (or
    of its model group's env index), and the groups the sums run over."""
    for rank, res in enumerate(w4):
        got = res[case]
        if case == "mesh":
            want = {"shape": {"env": 4}, "env_index": rank, "env_width": 4,
                    "env_group": [0, 1, 2, 3],
                    "reduce_groups": [[0, 1, 2, 3]],
                    "rows": (2 * rank, 2 * rank + 2)}
        elif case == "mesh_slices":
            want = {"shape": {"slice": 2, "env": 2}, "env_index": rank,
                    "env_width": 4, "env_group": [0, 1, 2, 3],
                    "reduce_groups": [[2 * (rank // 2), 2 * (rank // 2) + 1],
                                      [rank % 2, rank % 2 + 2]],
                    "rows": (2 * rank, 2 * rank + 2)}
        else:
            e = rank // 2
            want = {"shape": {"env": 2, "model": 2}, "env_index": e,
                    "env_width": 2, "env_group": [rank % 2, rank % 2 + 2],
                    "reduce_groups": [[rank % 2, rank % 2 + 2]],
                    "rows": (4 * e, 4 * e + 4)}
        assert got == want, (rank, got)


def test_mesh_groups_of_two_ranks(w2):
    for rank, res in enumerate(w2):
        assert res["mesh"]["rows"] == (4 * rank, 4 * rank + 4)
        assert res["mesh"]["reduce_groups"] == [[0, 1]]


def _jax_sharded(model_cfg, model_axis):
    """The port parameter names whose JAX leaves ``param_spec`` shards."""
    _, variables = init_policy(model_cfg, jax.random.PRNGKey(0))
    names = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables["params"]):
        keys = [k.key for k in path]
        leaf_name = {"kernel": "weight", "scale": "weight"}.get(keys[-1],
                                                                 keys[-1])
        if jax_mesh.param_spec(leaf, model_axis) != jax_mesh.P():
            names.add(".".join(keys[:-1] + [leaf_name]))
    return names


@pytest.mark.parametrize("model,model_axis", [("full", 2), ("full", 4),
                                              ("narrow", 2)])
def test_param_plan_matches_param_spec(model, model_axis):
    """param_plan shards the port tensors whose JAX counterparts (Dense
    kernels transposed) param_spec shards, and no other."""
    cfgs = {"full": (FULL, jax_config.ModelConfig()),
            "narrow": (R.NARROW, jax_config.ModelConfig(
                pose_mlp_hidden=32, grid_channels=4, fused_dim=32))}
    pt_cfg, jax_cfg = cfgs[model]
    policy = ActorCriticPolicy(pt_cfg, torch.Generator().manual_seed(0), "cpu")
    plan = mesh_lib.param_plan(policy, model_axis)
    ours = {f"{mod}.{p}" for mod in plan for p in ("weight", "bias")}
    assert ours == _jax_sharded(jax_cfg, model_axis)
    # every Linear of 256 features, and the 240-logit head; never the
    # value head, a Conv3d or a BatchNorm
    heads = {"action_net"}
    layers = {f"encoder.{n}" for n in ("pose_fc1", "pose_fc2", "grid_fc",
                                       "fuse_fc")} if model == "full" else set()
    assert set(plan) == heads | layers


@pytest.mark.parametrize("settings,error,match", [
    ({"model_axis": 2, "num_slices": 2}, ValueError, "mutually exclusive"),
    ({"num_devices": 3, "model_axis": 2}, ValueError, "divisible"),
    ({"num_devices": 6, "num_slices": 4}, ValueError, "divisible"),
    ({"num_devices": 2}, RuntimeError, "torch.distributed.run"),
    ({"model_axis": 2}, RuntimeError, "nproc_per_node 2"),
])
def test_multi_device_settings_raise(settings, error, match):
    """The JAX runner's and mesh's assertions, as errors; without a process
    group a multi-device setting names the torchrun launch."""
    with pytest.raises(error, match=match):
        cfg = pt_config.apply_overrides(pt_config.Config(), tuple(
            f"runner.{k}={v}" for k, v in settings.items()))
        mesh_lib.mesh_for(cfg.runner, torch.device("cpu"))


def test_env_axis_must_divide_the_envs():
    mesh = mesh_lib.Mesh({"env": 3}, 0, 0, 3, (), None)
    with pytest.raises(ValueError, match="num_envs"):
        mesh_lib.env_rows(8, mesh)


# ---------------------------------------------------------- one update
@pytest.mark.parametrize("world", [2, 4])
def test_one_update_matches_one_process(one, w2, w4, world):
    """W ranks, each with its shards' rows of every minibatch, against one
    process on the whole rollout: the first minibatch's summed gradients,
    metrics and BatchNorm running stats, then the whole update."""
    ranks = {2: w2, 4: w4}[world]
    for res in ranks:
        R.held_update(res["update"], one["update"])


@pytest.mark.parametrize("world", [2, 4])
def test_no_rollout_row_crosses_ranks(w2, w4, world):
    """With W dividing the 8 minibatch shards, an update's collectives are
    the gradient bucket (every parameter and the five metrics, once a
    minibatch), the BatchNorm sums (4 channels, forward and backward),
    the advantage statistics and the explained variance: no all-gather
    and no broadcast (the counterpart of test_update_has_no_rollout_allgather)."""
    res = {2: w2, 4: w4}[world][0]["update"]
    calls = Counter(res["collectives"])
    n_mb = res["count"]
    assert calls == {("all_reduce", res["n_params"] + 5): n_mb,
                     ("all_reduce", 4): 8 * n_mb,
                     ("all_reduce", 1): 2 * n_mb,
                     ("all_reduce", 2): 2}


def test_gather_path_matches_one_process(one, w2):
    """S = 3 minibatch shards on W = 2 ranks: the rollout is all-gathered
    once (its six tensors) and each rank takes half of each minibatch's
    rows; the update equals the one-process run's."""
    for res in w2:
        got = res["update_gather"]
        R.held_update(got, one["update_gather"])
        gathers = [c for c in got["collectives"] if c[0] == "all_gather"]
        assert len(gathers) == 6


def test_entropy_floor_update_matches_one_process(one, w2):
    """ppo.ent_floor: the hinge on the whole minibatch's mean entropy, its
    gradient summed over the ranks by the all-reduce's backward."""
    for res in w2:
        R.held_update(res["update_floor"], one["update_floor"])
    # the floor moved the gradients
    assert not np.array_equal(one["update_floor"]["grads"]["action_net.bias"],
                              one["update"]["grads"]["action_net.bias"])


# ---------------------------------------------------------- iterations
def _held_metrics(got, want, rtol=RUN_RTOL, atol=RUN_ATOL):
    keys = [k for k in want if k.startswith(("rollout/", "train/"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_two_iterations_match_one_process(one, w2, w4, world):
    ranks = {2: w2, 4: w4}[world]
    for res in ranks:
        _held_metrics(res["train"]["metrics"], one["train"]["metrics"])
    # every rank holds the same policy
    for res in ranks[1:]:
        for k, v in ranks[0]["train"]["state"].items():
            assert np.array_equal(res["train"]["state"][k], v), k


def test_pipelined_ranks_match_one_process(one, w2):
    """runner.pipeline_depth 2 on two gloo ranks, with an eval and a
    checkpoint every iteration (rank 0 evaluates; the checkpoints' gathers
    and the eval's broadcast run between dispatched iterations, in the
    same order on both ranks), against one process at depth 1: the same
    rollout and update metrics at each iteration, within
    tests/test_runner.py's tolerances, the same checkpoint files, and
    the same policy on both ranks."""
    want = one["pipelined"]
    got = w2[0]["pipelined"]
    assert [rec["step"] for rec in got["logged"]] == [1, 2]
    for g, w in zip(got["logged"], want["logged"]):
        _held_metrics(g, w)
        assert "eval/final_coverage" in g
    assert got["files"] == want["files"]
    assert f"rl_model_{2 * 8 * 8}_steps" in got["files"]
    for k, v in got["state"].items():
        assert np.array_equal(w2[1]["pipelined"]["state"][k], v), k


def test_multislice_matches_one_process(one, w4):
    """('slice', 'env') 2 x 2, one iteration."""
    for res in w4:
        _held_metrics(res["multislice"]["metrics"], one["train1"]["metrics"])


def test_tensor_parallel_matches_one_process(one, w4):
    """env 2 x model 2 at the full widths (the Linears of 256 and 240
    output features sharded), against one process and against data
    parallelism on 4 ranks, at the JAX TP test's tolerance."""
    for res in w4:
        _held_metrics(res["tp"]["metrics"], one["train_full"]["metrics"],
                      TP_RTOL, TP_ATOL)
        _held_metrics(res["tp"]["metrics"], res["dp_full"]["metrics"],
                      TP_RTOL, TP_ATOL)


# ---------------------------------------------------------- checkpoints
def test_tensor_parallel_checkpoint_restores_in_one_process(w2, dirs):
    """A checkpoint saved by env 1 x model 2 holds whole tensors: a
    one-process Runner restored from it gives the TP policy's outputs."""
    cfg = R.one_process(_cfg(model=FULL))
    runner = R.Runner(cfg, device="cpu")
    step = runner.restore(dirs["tp"])
    assert step == runner.global_step == 8 * 8
    got = R.outputs(runner.policy)
    for want in (res["saved"] for res in w2):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)


def test_one_process_checkpoint_restores_under_tensor_parallelism(one, w2):
    for res in w2:
        assert res["restored"]["step"] == 8 * 8
        for got, want in zip(res["restored"]["outputs"], one["saved"]):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_resume_under_two_ranks_continues(w2):
    """A restore under two ranks (data or tensor parallel) resumes at the
    checkpoint's iteration and trains the remainder."""
    for res in w2:
        for case in ("restored", "resumed"):
            got = res[case]
            assert (got["first"], got["iteration"], got["global_step"]) == (
                1, 2, 2 * 8 * 8)


def test_train_cli_under_torchrun(dirs):
    """train_gennbv for 2 iterations on 2 gloo ranks of the CPU, a
    checkpoint each iteration: rank 0 logs both and writes them."""
    log_dir = dirs["cli"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", "2", "-m", "gennbv_tpu_torch.train.train_gennbv",
        "--device", "cpu", "--num_envs", "4", "--max_iterations", "2",
        "--log_dir", log_dir, "--exp_name", "ranks",
        "--set", "env.camera.height=16", "--set", "env.camera.width=16",
        "--set", "env.renderer.resolution=16",
        "--set", "env.scene.num_scenes=4", "--set", "ppo.n_steps=4",
        "--set", "ppo.batch_size=8", "--set", "runner.save_freq=1",
        "--set", "runner.num_devices=2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("final:") == 1
    (run,) = os.listdir(log_dir)
    logged = [json.loads(line)["step"]
              for line in open(os.path.join(log_dir, run, "metrics.jsonl"))]
    assert logged == [1, 2]
    models = os.path.join(log_dir, run, "models")
    assert CheckpointManager(models).latest_step() == 2 * 4 * 4


def test_train_cli_without_torchrun_raises(tmp_path):
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        train_gennbv.main(["--device", "cpu", "--log_dir", str(tmp_path),
                           "--set", "runner.num_devices=2"])
