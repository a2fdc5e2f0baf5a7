"""The port's last examples, plotter and tools on the CPU at tiny sizes:
``utils/episode_plotter.py`` against the JAX plotter, the two examples
(``examples/03``'s output against the JAX example's), and ``tools/``
smoke, profile_train, export_fps_evidence, rehearse_ingestion and
bench_scatter (its errors against the JAX tool's)."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import json
import math
import os
import re
import subprocess
import sys

import numpy as np

from gennbv_tpu.utils.episode_plotter import EpisodePlotter as JaxPlotter
from gennbv_tpu_torch.examples import external_sim_bridge, train_nbv_policy
from gennbv_tpu_torch.tools import (bench_scatter, export_fps_evidence,
                                    profile_train, rehearse_ingestion)
from gennbv_tpu_torch.utils.episode_plotter import EpisodePlotter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _log(plotter):
    for t in range(10):
        plotter.log_states({"pos_x": t * 0.1, "vel_x": 1.0})
        plotter.log_reward("coverage", 0.5)
    return plotter


def test_episode_plotter(tmp_path):
    """tests/test_misc.py's inputs: a PNG of over 5,000 bytes, and the
    series the JAX plotter holds."""
    p, j = _log(EpisodePlotter(dt=0.02)), _log(JaxPlotter(dt=0.02))
    assert dict(p._series) == dict(j._series)
    assert dict(p._rewards) == dict(j._rewards)
    out = p.plot(str(tmp_path / "ep.png"))
    assert os.path.getsize(out) > 5000


def test_train_nbv_policy_example(capsys):
    metrics = train_nbv_policy.main(["--device", "cpu"])
    assert all(math.isfinite(v) for v in metrics.values())
    assert "final coverage:" in capsys.readouterr().out


def test_external_sim_bridge_example_matches_the_jax_example(capsys):
    """The replay-fed coverage the JAX example prints, to its 3 digits,
    and a finite callback-fed observation."""
    res = subprocess.run([sys.executable, "examples/03_external_sim_bridge.py"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-2000:]
    want = re.search(r"replay-fed coverage: (.*)", res.stdout).group(1)
    got = external_sim_bridge.main(["--device", "cpu"])
    assert str(got["coverage"].round(3)) == want
    assert got["finite"]
    assert "callback-fed obs finite: True" in capsys.readouterr().out


def test_smoke_tool():
    """tools/smoke.py without --card: the train CLI on two CPU ranks under
    torchrun and the dry run on four."""
    res = subprocess.run([sys.executable, "-m", "gennbv_tpu_torch.tools.smoke"],
                         cwd=REPO, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-3000:]
    assert "SMOKE PASS" in res.stdout
    assert res.stdout.count("OK   ") == 2


def test_profile_train_tool():
    out = profile_train.main(["4", "16", "16", "--device", "cpu"])
    for phase in ("scene_build", "env_step", "rollout", "update", "iteration"):
        assert out[f"time/{phase}"] > 0, phase
    assert out["iteration_fps"] > 0


def test_export_fps_evidence(tmp_path):
    """The port's copy of tools/export_fps_evidence.py on a run directory
    the port's Runner layout writes: the trimmed steady-state summary."""
    run = tmp_path / "run"
    run.mkdir()
    rows = [{"step": i + 1, "time/fps": fps, "time/iter_seconds": 1.0}
            for i, fps in enumerate([10.0, 100.0, 110.0, 90.0, 105.0])]
    (run / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    (run / "config.json").write_text(json.dumps({"env": {
        "camera": {"height": 16}, "renderer": {"band_split": None},
        "num_envs": 4}}))
    out = export_fps_evidence.export(str(run), "fps_test", root=str(tmp_path))
    got = json.load(open(os.path.join(out, "fps.json")))
    assert got["summary"] == {"n": 4, "mean_trimmed": 101.2, "median": 105.0,
                              "min": 90.0, "max": 110.0}
    assert [r["step"] for r in got["iterations"]] == [1, 2, 3, 4, 5]


def test_rehearse_ingestion_smoke(tmp_path):
    """--smoke: 8 + 50 houses meshed and converted at R=16, then the
    converted and the procedural run and post_run's held-out family."""
    out = rehearse_ingestion.main(["--smoke", "--iters", "1", "--out",
                                   str(tmp_path)])
    assert set(out["synth_seconds"]) == {"train", "eval"}
    for run in ("converted", "procedural"):
        assert math.isfinite(out[run]["eval_final_coverage"])
    assert out["held_out_houses"]["final_coverage"] == round(
        out["converted"]["eval_final_coverage"], 4)
    assert os.path.exists(tmp_path / "report.json")
    assert np.isfinite(out["held_out_houses"]["mean_AUC"])


def test_bench_scatter_tool_matches_the_jax_tool(tmp_path, capsys):
    """The tool's port on the CPU at 4 envs x 64 points, 8x8: every form's
    line, the kernel's plain version bit-equal to the library scatter-min,
    and the same inputs as the JAX tool (tools/bench_scatter.py), whose
    printed count-product and carve errors and hit exactness it repeats
    digit for digit."""
    res = subprocess.run(
        [sys.executable, "tools/bench_scatter.py", "4", "64", "8"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache")))
    assert res.returncode == 0, res.stderr[-2000:]
    out = bench_scatter.main(["4", "64", "8", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert out["device"] == "cpu" and out["kernel_bit_equal"]
    assert out["kernel_max_abs_err"] == 0.0
    assert out["hits_exact"] and out["vis_exact"]
    assert len(out["ms"]) == 9 and all(v > 0 for v in out["ms"].values())
    for line in ("count-matmul err:", "hits exactness:", "carve err"):
        want = next(x for x in res.stdout.splitlines() if line in x)
        assert want.strip() in printed, line
