"""Runs one cell of ``BENCHMARK.json`` once, on the card of the machine it
is started on:

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (scenes and weights from the seed, the program built on them, the
cell's shapes warmed up) runs first and counts as ``setup_s``; then the
timed window; then, with ``--trace 1``, the profiled units of work.  The
program is freed, the plain reference judges what the program produced
(``correct``), and the last line of standard output is one JSON object:
the end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``, each number compared beside its limit under ``checks``
(also the last lines of standard error).

Exits with 1, printing no result, without a CUDA card (or fewer than the
cell's chips) and when JAX or the JAX package was imported.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time

from benchmark import compare, harness, trace


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        return subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_cell(cell: harness.Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", precision: str = "float32",
             started: float | None = None) -> dict:
    """One run of `cell`: the result's keys before ``device``.
    `precision` "tf32" is the lower-precision control (``calibrate.py``):
    TF32 turned on after the program's constructors have set float32
    (for training's update, which the program runs in float32 whatever
    the setting, the reference's steps in TF32 in the program's place)."""
    import torch
    started = time.time() if started is None else started
    harness.keep_jax_out()
    loop = harness.loop(cell.traffic["loop"]).Loop(
        cell, seed, device, precision)
    loop.setup(seconds)
    setup_s = time.time() - started
    on_card = device == "cuda"
    before = harness.host_state(on_card)
    e2e, attempted = loop.window(seconds)
    print(f"host before the window: {before}\nhost after the window: "
          f"{harness.host_state(on_card)}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if traced and on_card:
        loop.trace()
    loop.release()
    t0 = time.time()
    numbers = loop.check()
    print(f"benchmark: set-up {setup_s:.3f} s, reference {time.time() - t0:.3f} s",
          file=sys.stderr)
    correct, checks = compare.judge(numbers, cell.limits)
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if correct else attempted, "checks": checks,
           "memory_peak_bytes": peak}
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    if not traced:
        values = {**e2e, "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
        return out
    rec = loop.layer_records(kind)
    out["metrics"] = {}
    for m in cell.per_layer:
        value = harness.metric_reader(m["name"]).read(rec)
        if value is not None:
            out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    prof, host = loop.records.get("profile"), loop.records.get("host_profile")
    if prof is not None:
        out["busy_s"] = trace.busy_ns(prof.spans) / 1e9
        out["window_s"] = (prof.window[1] - prof.window[0]) / 1e9
        out["breakdown"] = {
            "device_ops": trace.device_ops(prof.spans),
            "idle_gaps": trace.idle_gaps(host.spans, host.host, host.window)}
    return out


def main(argv=None) -> int:
    started = harness.process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = harness.find_cell(harness.load_spec(), args.workload)
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    print(f"benchmark: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr, flush=True)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   started=started)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process imported {found}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=res.get("busy_s"), window_s=res.get("window_s"))
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
