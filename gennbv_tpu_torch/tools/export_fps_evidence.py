"""Export a throughput run's evidence into the tracked reports/ dir (a copy
of ``tools/export_fps_evidence.py``, kept in the port so that it needs
nothing outside its package; the port's Runner writes the same
metrics.jsonl and config.json).

For live-fps measurement runs (no eval protocol): distills metrics.jsonl
into fps.json — every iteration's time/fps + iter_seconds, the trimmed
mean over steady-state iterations (first iteration excluded: it carries
compile + warmup), and the camera/band configuration — plus config.json.

Usage: python -m gennbv_tpu_torch.tools.export_fps_evidence runs/<exp> <report-name>
"""
from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def steady_fps(rows: list[dict], skip: int = 1) -> dict:
    """Trimmed summary of time/fps over iterations [skip:]."""
    fps = [r["time/fps"] for r in rows[skip:] if "time/fps" in r]
    if not fps:
        return {"n": 0}
    fps_sorted = sorted(fps)
    k = max(len(fps_sorted) // 10, 0)   # 10% trim each side
    trimmed = fps_sorted[k:len(fps_sorted) - k] or fps_sorted
    return {
        "n": len(fps),
        "mean_trimmed": round(sum(trimmed) / len(trimmed), 1),
        "median": round(fps_sorted[len(fps_sorted) // 2], 1),
        "min": round(fps_sorted[0], 1),
        "max": round(fps_sorted[-1], 1),
    }


def export(run_dir: str, name: str, root: str = ROOT) -> str:
    out_dir = os.path.join(root, "reports", name)
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy2(os.path.join(run_dir, "config.json"),
                 os.path.join(out_dir, "config.json"))
    rows = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    payload = {
        "run_dir": os.path.basename(run_dir.rstrip("/")),
        "camera": cfg["env"]["camera"],
        "band_split": cfg["env"]["renderer"].get("band_split"),
        "num_envs": cfg["env"]["num_envs"],
        "summary": steady_fps(rows),
        "iterations": [
            {"step": r.get("step"),
             "fps": round(r.get("time/fps", 0.0), 1),
             "iter_seconds": round(r.get("time/iter_seconds", 0.0), 3)}
            for r in rows
        ],
    }
    with open(os.path.join(out_dir, "fps.json"), "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({"report": out_dir, **payload["summary"]}))
    return out_dir


if __name__ == "__main__":
    export(sys.argv[1], sys.argv[2])
