"""The lower-precision control on the card (TF32 turned on after the
program's constructors): at a size a test run holds, each cell's
control comes out incorrect under the cell's own limits, and the program
as it runs comes out correct.  Skips without a card (no interpret mode):

    python -m pytest benchmark/tests/test_benchmark_card.py -q
"""
from __future__ import annotations

import pytest

from benchmark import harness, run
from benchmark.tests import tiny


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 exists only there")


def small_cell(name: str) -> harness.Cell:
    """The tiny cell at a card's small size, held to the cell's limits."""
    cell = tiny.tiny_cell(name)
    env = cell.config["config"]["env"]
    env["num_envs"] = 16
    env["camera"]["height"] = env["camera"]["width"] = 64
    env["renderer"]["resolution"] = 64
    env["scene"]["num_scenes"] = 16
    cell.config["config"]["ppo"].update(n_steps=16, batch_size=32)
    if cell.traffic["loop"] == "eval":
        cell.traffic["eval_env"].update(num_envs=16, max_episode_length=10)
        cell.traffic["eval_scenes"]["count"] = 16
    full = harness.find_cell(harness.load_spec(), name)
    return cell._replace(limits=full.limits)


@pytest.mark.parametrize("workload", ["flagship128.train", "ref400.eval"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_and_program_passes_on_the_card(cuda, workload, seed):
    cell = small_cell(workload)
    try:
        control = run.run_cell(cell, seed, 0.5, False, precision="tf32")
    finally:
        harness.set_tf32(False)
    assert not control["correct"], control["checks"]
    program = run.run_cell(cell, seed, 0.5, False)
    assert program["correct"], program["checks"]
