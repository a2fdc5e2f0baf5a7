"""What every cell shares: reading ``BENCHMARK.json`` and the files it names
(a configuration's sizes, a traffic mix's parameters, a per-layer
metric's reader, a cell's limits), and making the inputs from the seed
(scenes and weights) that the program and the reference both get.

Everything that belongs to one configuration, mix or metric lives in a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose "loop"
names ``loops/<loop>.py``), ``metrics/<metric>.py`` and
``limits/<workload>.json``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names no process of the benchmark may hold: JAX and
# the JAX package the program was ported from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gennbv_tpu")


class Cell(NamedTuple):
    workload: dict       # the BENCHMARK.json entry
    config: dict         # the configuration file (source, ..., "config")
    traffic: dict        # the traffic mix's parameters
    end_to_end: list     # the BENCHMARK.json metrics this cell reports
    per_layer: list
    limits: dict         # number compared -> its limit


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def find_cell(spec: dict, name: str, bench: Path = BENCH) -> Cell:
    """The cell `name` of `spec` and the files its names lead to."""
    workload = next((w for w in spec["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{[w['name'] for w in spec['workloads']]}")
    entry = next(c for c in spec["configs"] if c["name"] == workload["config"])
    config = json.loads((bench.parent / entry["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{workload['traffic']}.json")
                         .read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    limits_file = bench / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Cell(workload, config, traffic, e2e, layer, limits)


def load_module(path: Path):
    """The module in the file `path` (a metric's name holds dots, so it is
    loaded by path, not by import name)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench: Path = BENCH):
    return load_module(bench / "metrics" / f"{name}.py")


def loop(name: str):
    return importlib.import_module(f"benchmark.loops.{name}")


def peaks(kind: str) -> dict | None:
    """The card's float32 peak and HBM bandwidth, where the table has
    it."""
    table = json.loads((BENCH / "work" / "peaks.json").read_text())
    return table.get(kind)


# --- inputs from the seed ----------------------------------------------------

def flat_overrides(d: dict, prefix: str = "") -> list:
    out = []
    for k, v in d.items():
        if isinstance(v, dict):
            out += flat_overrides(v, f"{prefix}{k}.")
        else:
            out.append(f"{prefix}{k}=" + ("none" if v is None else
                                          str(v).lower() if isinstance(v, bool)
                                          else repr(v) if isinstance(v, float)
                                          else str(v)))
    return out


def port_config(config: dict, seed: int):
    """The program's Config of the configuration file's "config", with
    its runner seeded by the run's seed."""
    from gennbv_tpu_torch.config import Config, apply_overrides
    return apply_overrides(Config(), tuple(
        flat_overrides(config) + [f"runner.seed={seed % 2 ** 63}"]))


def scene_arrays(env: dict, count: int, seed: int) -> dict:
    """`count` procedural houses of scene seed `seed` as numpy arrays
    (``reference/scenes.py``)."""
    from benchmark.reference import scenes
    sc = env["scene"]
    if sc["dataset"] != "procedural" or sc["difficulty"] != "standard":
        raise ValueError("the benchmark generates procedural houses of "
                         "standard difficulty only")
    return scenes.generate(count, seed % 2 ** 32, env["renderer"]["resolution"],
                           sc["grid_size"], sc["extent_xy"], sc["extent_z"])


def to_device(arrays: dict, device) -> dict:
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def program_scenes(tensors: dict, env: dict):
    """The arrays as the program's SceneSet."""
    from gennbv_tpu_torch.env.scene import SceneSet
    return SceneSet(grid_res=env["renderer"]["resolution"],
                    grid_size=env["scene"]["grid_size"], **tensors)


# each head's gain under SB3's orthogonal init (its bias is zero)
HEAD_GAINS = {"action_net": 0.01, "value_net": 1.0}


def weights(model: dict, seed: int, device) -> dict:
    """The policy's state_dict drawn from the seed by the benchmark, in
    one call of a generator on `device`: layers as PyTorch initialises
    them (uniform within 1/sqrt(fan_in)), the heads uniform with the
    standard deviation of SB3's orthogonal init at its gains (0.01 for the
    action head, 1 for the value head) and zero biases, BatchNorm at
    weight 1, bias 0, running mean 0 and variance 1."""
    import torch
    from benchmark.reference.policy import Policy
    shapes = {k: v for k, v in Policy(model, "meta").state_dict().items()}
    drawn = [k for k, v in shapes.items() if v.dim() >= 2
             or (k.endswith("bias") and k.split(".")[0] == "encoder"
                 and "bn" not in k)]
    total = sum(shapes[k].numel() for k in drawn)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    u = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    for k, v in shapes.items():
        if k in drawn:
            weight = shapes[k[: -len("bias")] + "weight"] if k.endswith("bias") \
                else v
            fan_in = weight[0].numel()
            head = k.split(".")[0]
            bound = (HEAD_GAINS[head] * 3 ** 0.5 if head in HEAD_GAINS else 1.0) \
                / fan_in ** 0.5
            out[k] = (u[at:at + v.numel()] * bound).reshape(v.shape)
            at += v.numel()
        elif k.endswith("running_var") or (k.endswith("weight") and "bn" in k):
            out[k] = torch.ones(v.shape, device=device)
        else:
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return out


# --- the run -------------------------------------------------------------------

def process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux), else now."""
    try:
        with open(f"/proc/{os.getpid()}/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def host_state(card: bool = True) -> str:
    """What may set a host-bound run's pace, for its log: the core the
    process last ran on, that core's NUMA node and clock, the cores it
    may use, the load average, the machine's steal time (jiffies taken
    by other guests of its host), the process's CPU seconds and its
    voluntary and involuntary context switches, the garbage collector's
    collections so far (by generation), and the card's clocks, power,
    temperature and active throttle reasons."""
    import gc
    import glob
    import resource
    import shutil
    import subprocess
    parts = []
    try:
        with open("/proc/self/stat") as f:
            cpu = int(f.read().rsplit(")", 1)[1].split()[36])
        node = [os.path.basename(n) for n in
                glob.glob(f"/sys/devices/system/cpu/cpu{cpu}/node*")]
        mhz = None
        with open("/proc/cpuinfo") as f:
            at = None
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() == "processor":
                    at = int(value)
                elif key.strip() == "cpu MHz" and at == cpu:
                    mhz = value.strip()
        parts.append(f"cpu {cpu} {','.join(node) or 'node ?'} {mhz} MHz")
    except (OSError, ValueError, IndexError):
        parts.append("cpu ?")
    parts.append(f"{len(os.sched_getaffinity(0))} cores allowed")
    parts.append("load " + " ".join(f"{x:.2f}" for x in os.getloadavg()))
    try:
        with open("/proc/stat") as f:
            parts.append(f"steal {f.readline().split()[8]}")
    except (OSError, IndexError):
        parts.append("steal ?")
    use = resource.getrusage(resource.RUSAGE_SELF)
    parts.append(f"cpu time {use.ru_utime + use.ru_stime:.3f} s, switches "
                 f"{use.ru_nvcsw}/{use.ru_nivcsw}")
    parts.append("gc " + "/".join(str(g["collections"])
                                  for g in gc.get_stats()))
    smi = shutil.which("nvidia-smi")
    if card and smi is not None:
        try:
            parts.append("card " + subprocess.run(
                [smi, "--query-gpu=clocks.sm,clocks.mem,power.draw,"
                 "temperature.gpu,clocks_throttle_reasons.active",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20).stdout.strip())
        except (OSError, subprocess.SubprocessError) as e:
            parts.append(f"card ? ({e})")
    return "; ".join(parts)


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of
    FORBIDDEN_MODULES, compared whole (``gennbv_tpu_torch`` is not
    ``gennbv_tpu``)."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN_MODULES)


def keep_jax_out() -> None:
    """Keeps the libraries the program loads from loading JAX: the
    program's logger tries TensorBoard, which imports TensorFlow where it
    is installed, and TensorFlow's lite converter imports JAX.  A
    ``tensorboard.compat.notf`` module makes TensorBoard take its own
    stand-in for TensorFlow, as its ``no_tensorflow`` build does."""
    import types
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))


def set_tf32(on: bool) -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
