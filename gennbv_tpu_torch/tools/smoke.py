"""One-command verifier of the port (counterpart of ``tools/smoke.py``):
the train CLI on two CPU ranks and the multichip dry run, and with
``--card`` the card's smoke run.

Runs each surface as a subprocess:

  1. the train CLI, 2 iterations under ``torchrun --nproc_per_node 2`` on
     ``--device cpu`` (gloo), into a temporary log directory;
  2. ``graft_entry`` with n = 4 on the CPU (data and tensor parallel);
  3. (``--card``) ``python3 chip_smoke.py`` on the CUDA card.

Usage: python -m gennbv_tpu_torch.tools.smoke [--card]
Exit code 0 = every surface passed.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(name: str, cmd: list[str], timeout: int = 900) -> bool:
    """Runs `cmd` from the repository's root; prints its last lines and
    whether it passed."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    print(f"--- {name}: {' '.join(cmd)}", flush=True)
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, timeout=timeout,
                              capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        print(f"FAIL {name}: timeout after {timeout}s", flush=True)
        return False
    tail = "\n".join((proc.stdout + proc.stderr).strip().splitlines()[-6:])
    if proc.returncode != 0:
        print(f"FAIL {name} (exit {proc.returncode}):\n{tail}", flush=True)
        return False
    print(f"OK   {name}\n{tail}\n", flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--card", action="store_true",
                    help="also run chip_smoke.py on the CUDA card")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="gennbv_smoke_") as log_dir:
        ok = run("train-cli (2 CPU ranks)", [
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m",
            "gennbv_tpu_torch.train.train_gennbv", "--device", "cpu",
            "--num_envs", "8", "--max_iterations", "2", "--log_dir", log_dir,
            "--set", "env.camera.height=16", "--set", "env.camera.width=16",
            "--set", "env.renderer.resolution=16",
            "--set", "env.scene.num_scenes=4",
            "--set", "ppo.n_steps=4", "--set", "ppo.batch_size=16",
            "--set", "runner.num_devices=2",
        ])
    ok &= run("dryrun_multichip(4) on the CPU", [
        sys.executable, "-m", "gennbv_tpu_torch.graft_entry", "4",
        "--device", "cpu"])
    if args.card:
        ok &= run("chip_smoke.py (the card)", ["python3", "chip_smoke.py"],
                  timeout=1800)
    print("SMOKE", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
