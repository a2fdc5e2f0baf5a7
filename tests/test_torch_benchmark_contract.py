"""The seam between the port and its benchmark (``BENCHMARK.json``,
``benchmark/``) on the CPU, so that a rename or a dropped field in the
program fails here and not on the card: each configuration file states
every field of the port's ``Config`` as the harness applies it, and every
program name that a per-layer metric reads (its reader's ``READS``) is
still recorded as a span by a traced run at tiny shapes, written by the
Runner to ``metrics.jsonl`` with a positive value, or declared as a kernel
in ``gennbv_tpu_torch/csrc``.  It reads ``benchmark/`` and edits nothing
there."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import copy
import json
import re
import time
from pathlib import Path

import pytest

from benchmark import harness
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch.algo import evaluation, runner
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "benchmark" / "configs").glob("*.json"))
CSRC = ROOT / "gennbv_tpu_torch" / "csrc"
GLOBAL_FN = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
NARROW = dict(pose_mlp_hidden=32, grid_channels=4, fused_dim=32)


def _read_names() -> list:
    """Each program name in the per-layer readers' READS, once; entries
    that describe records rather than name them hold a space."""
    names = set()
    for path in sorted((ROOT / "benchmark" / "metrics").glob("*.py")):
        names.update(harness.metric_reader(path.stem).READS)
    return sorted(n for n in names if " " not in n)


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_a_configuration_states_every_field_of_config(path):
    """The Config the harness builds from the file's "config" holds the
    file's values and no field the file leaves out, key for key (the
    runner's seed is the run's)."""
    stated = json.loads(path.read_text())["config"]
    got = pt_config.config_to_dict(harness.port_config(stated, seed=5))
    want = copy.deepcopy(stated)
    del got["runner"]["seed"], want["runner"]["seed"]
    assert got == want


def _tiny_env(**kw) -> pt_config.EnvConfig:
    return pt_config.EnvConfig(
        num_envs=3, max_episode_length=3,
        camera=pt_config.CameraConfig(height=16, width=16),
        scene=pt_config.SceneConfig(num_scenes=3, seed=1), **kw)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The span names of a traced one-iteration ``Runner.train``, a
    traced ``evaluate`` episode with the accuracy scan (the report's
    path), a traced env step on the DDA march with the Bresenham carve
    and one on the splat's exact z-buffer; the keys the Runner wrote to
    ``metrics.jsonl`` with a positive value; the kernels of ``csrc``; the
    counters the runs counted."""
    log_dir = tmp_path_factory.mktemp("contract") / "run"
    cfg = pt_config.Config(
        env=pt_config.EnvConfig(
            num_envs=4, max_episode_length=4,
            camera=pt_config.CameraConfig(height=16, width=16),
            renderer=pt_config.RendererConfig(resolution=16),
            scene=pt_config.SceneConfig(num_scenes=2, seed=0)),
        model=pt_config.ModelConfig(**NARROW),
        ppo=pt_config.PPOConfig(n_steps=4, batch_size=8, n_epochs=1,
                                total_iters=1),
        runner=pt_config.RunnerConfig(seed=0, save_freq=0))
    eval_env = _tiny_env(renderer=pt_config.RendererConfig(resolution=16))
    dda_env = _tiny_env(carve_mode="bresenham", renderer=pt_config.
                        RendererConfig(mode="dda", resolution=16))
    exact_env = _tiny_env(renderer=pt_config.RendererConfig(
        resolution=16, zbuf_impl="scatter"))
    t0, counted = time.time_ns(), profiling.counters()
    with profiling.tracing():
        r = runner.Runner(cfg, log_dir=str(log_dir), device="cpu")
        r.train(1)
        r.close()
        env = ReconEnv(eval_env, make_scenes(eval_env.scene, 16, "cpu"))
        policy = ActorCriticPolicy(pt_config.ModelConfig(**NARROW), None,
                                   "cpu")
        evaluation.evaluate(env, policy, point_stride=2)
        for cfg_env in (dda_env, exact_env):
            env = ReconEnv(cfg_env, make_scenes(cfg_env.scene, 16, "cpu"))
            env.step(env.init_state(3), env.init_action.expand(3, 6))
    spans = {s.name for s in profiling.spans() if s.start_ns >= t0}
    with open(log_dir / "metrics.jsonl") as f:
        (logged,) = [json.loads(line) for line in f]
    positive = {k for k, v in logged.items()
                if isinstance(v, (int, float)) and v > 0}
    kernels = {fn for cu in CSRC.glob("*.cu")
               for fn in GLOBAL_FN.findall(cu.read_text())}
    counters = {k for k, v in profiling.counters().items()
                if v > counted.get(k, 0)}
    return {"spans": spans, "metrics.jsonl": positive, "csrc": kernels,
            "counters": counters}


@pytest.mark.parametrize("name", _read_names())
def test_a_name_a_metric_reads_is_still_made_by_the_program(recorded, name):
    """A span the traced runs record, a key the Runner logs with a
    positive value, a kernel of ``csrc`` or a counter the runs count:
    where the name is found."""
    where = [k for k, names in recorded.items() if name in names]
    assert where, f"{name!r}: read by a metric, made by no part of the port"


def test_the_exact_zbuffer_cell_reports_its_metrics():
    """``exact400.eval`` is found with its configuration's exact z-buffer
    and its traffic's loop, and reports the eval's end-to-end metrics, the
    eval's per-layer metrics of the layers it runs (not the fused splat's
    roofline) and its own two."""
    cell = harness.find_cell(harness.load_spec(), "exact400.eval")
    assert cell.workload["chips"] == 1
    assert cell.config["config"]["env"]["renderer"]["zbuf_impl"] == "scatter"
    assert cell.traffic["loop"] == "eval_zscatter"
    assert {m["name"] for m in cell.end_to_end} == {
        "eval_env_steps_per_s", "eval_episode_p90_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "idle_share.eval", "env_step_launches.eval", "eval_mfu",
        "env_step_host_ms.eval", "policy_host_ms.eval",
        "env_step_idle_share.eval", "zscatter_ms.eval",
        "zscatter_roofline.eval"}
