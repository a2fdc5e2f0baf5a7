"""No process of the benchmark holds JAX or the JAX package, compared by
whole top-level names (``gennbv_tpu_torch`` begins with ``gennbv_tpu``
and is allowed), and the plain reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

REFERENCE = harness.BENCH / "reference"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in ("gennbv_tpu_torch.fake", "jaxtyping_fake", "gennbv_tpu.env",
                 "jax.numpy_fake"):
        monkeypatch.setitem(sys.modules, name, object())
    found = harness.forbidden_modules()
    assert "gennbv_tpu.env" in found and "jax.numpy_fake" in found
    assert "gennbv_tpu_torch.fake" not in found
    assert "jaxtyping_fake" not in found


def _run(code: str) -> str:
    done = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return done.stdout.strip().splitlines()[-1]


def test_a_run_of_each_cell_imports_no_jax():
    """Both tiny cells run in a fresh process (the program, its logger,
    the reference and every metric reader), which then holds no module
    named jax, jaxlib, flax or gennbv_tpu."""
    last = _run(
        "import json\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "for w in ('flagship128.train', 'ref400.eval'):\n"
        "    assert tiny.run_tiny(w, traced=True)['correct']\n"
        "print(json.dumps(harness.forbidden_modules()))")
    assert last == "[]"


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top in ("__future__", "math", "typing", "numpy", "torch",
                           "benchmark"), name
            assert top != "benchmark" or name.startswith("benchmark.reference")


def test_reference_loads_no_program_module():
    last = _run(
        "import sys\n"
        "import benchmark.reference.env, benchmark.reference.policy\n"
        "import benchmark.reference.ppo, benchmark.reference.scenes\n"
        "print(sorted({n.split('.')[0] for n in sys.modules\n"
        "             if n.split('.')[0].startswith(('gennbv', 'jax'))}))")
    assert last == "[]"
