"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
1. a CUDA card must be present; print its name and power limit, the torch
   version and nvcc's;
2. build the gather kernel from gennbv_tpu_torch/csrc with nvcc (timed);
3. at the rollout's shapes (256 envs, 128x128, 11264 and 8000 points) hold
   the kernel bit-equal to its plain PyTorch version and time both;
4. run the mapping golden on the card (tests/goldens/mapping_golden.npz,
   tests/test_goldens.py's tolerances) with the kernel doing the lookups;
5. the rollout at the flagship size: 256 procedural scenes, 256 envs,
   128x128 camera, R=64 render grid, full-width HybridEncoder policy from a
   seeded generator, reset + collect(n_steps=128).  Checks the outputs and
   that the kernel ran exactly twice per env step; prints env-steps/s.
The last two lines of stdout are the kernel summary with the card's name
and power limit before them, then the result line
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from gennbv_tpu_torch import config
from gennbv_tpu_torch.algo import rollout
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.ops import _cuda, gather

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "mapping_golden.npz")
N_ENVS, HW, RES, N_STEPS, GAMMA = 256, 128, 64, 128, 0.99
# points per env of the two gathers of an env step: visibility (the surface
# capacity Q of the 256 seed-0 scenes at R=64) and carve (G^3)
GATHER_Q = (11264, 8000)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    card = card_line()
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60).stdout
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{nvcc.strip().splitlines()[-1]}")
    return card


def phase_build() -> float:
    so = _cuda.library_path("gather_image")
    if so.exists():
        so.unlink()                      # always build from the checkout
    t0 = time.perf_counter()
    _cuda.load_library("gather_image")
    secs = time.perf_counter() - t0
    print(f"build: gather_image.cu -> {so.name} in {secs:.2f} s")
    return secs


def _time_ms(fn, trials: int = 21, calls: int = 10) -> float:
    """Median over trials of the mean time of `calls` back-to-back calls,
    from CUDA events, after a warm-up."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def phase_kernel() -> dict:
    """Kernel vs plain version at the rollout's shapes, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand(N_ENVS, HW, HW, device="cuda", generator=gen) * 30.0
    img[:, :8, :8] = 50.0                                    # empty pixels
    img[:, 8, :4] = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0, -3.7])
    ms = plain_ms = err = 0.0
    for q in GATHER_Q:
        vi = torch.randint(0, HW, (N_ENVS, q), device="cuda", dtype=torch.int32,
                           generator=gen)
        ui = torch.randint(0, HW, (N_ENVS, q), device="cuda", dtype=torch.int32,
                           generator=gen)
        got = gather.gather_image(img, vi, ui)
        want = gather.gather_image_ref(img, vi, ui)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather kernel differs from plain at Q={q}: "
                                 f"max {float((got - want).abs().max())}")
        err = max(err, float((got - want).abs().max()))
        k_ms = _time_ms(lambda: gather.gather_image(img, vi, ui))
        p_ms = _time_ms(lambda: gather.gather_image_ref(img, vi, ui))
        print(f"gather [{N_ENVS}x{HW}x{HW}] x [{N_ENVS}x{q}]: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms (median, CUDA events)")
        ms += k_ms
        plain_ms += p_ms
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_golden() -> None:
    """tools/make_goldens.py's run on the card, held to the golden."""
    cfg = config.EnvConfig(
        num_envs=4, camera=config.CameraConfig(height=24, width=24),
        renderer=config.RendererConfig(resolution=24),
        scene=config.SceneConfig(num_scenes=2, seed=7), max_episode_length=6)
    env = ReconEnv(cfg, make_scenes(cfg.scene, cfg.renderer.resolution, "cuda"))
    want = np.load(GOLDEN)
    before = gather.gather_image.launches
    state, out = env.reset(4)
    obs, rew, cov = [out.obs], [], []
    for a in want["actions"]:
        state, out = env.step(state, torch.as_tensor(a, device="cuda")[None]
                              .repeat(4, 1))
        obs.append(out.obs)
        rew.append(out.reward)
        cov.append(out.coverage)
    torch.cuda.synchronize()
    launches = gather.gather_image.launches - before
    if launches != 2 * (1 + len(want["actions"])):
        raise AssertionError(f"golden run launched the gather {launches} times")
    got = {"obs": obs, "rewards": rew, "coverage": cov}
    for name, tol in (("coverage", 1e-6), ("rewards", 1e-4), ("obs", 1e-4)):
        np.testing.assert_allclose(torch.stack(got[name]).cpu().numpy(),
                                   want[name], rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(state.prob_grid.cpu().numpy(), want["prob_grid"],
                               rtol=0, atol=1e-6, err_msg="prob_grid")
    print("golden: matches tests/goldens/mapping_golden.npz on the card")


def _flagship():
    cfg = config.EnvConfig(
        num_envs=N_ENVS, camera=config.CameraConfig(height=HW, width=HW),
        renderer=config.RendererConfig(resolution=RES),
        scene=config.SceneConfig(num_scenes=N_ENVS, seed=0))
    t0 = time.perf_counter()
    scenes = make_scenes(cfg.scene, RES, "cuda")
    print(f"scenes: {N_ENVS} procedural at R={RES}, Q={scenes.surf_pts.shape[1]}"
          f" in {time.perf_counter() - t0:.1f} s")
    if scenes.surf_pts.shape[1] != GATHER_Q[0]:
        raise AssertionError("phase 3 timed the gather at another Q than the "
                             f"rollout's {scenes.surf_pts.shape[1]}")
    env = ReconEnv(cfg, scenes)
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1),
                               device="cuda")
    return cfg, env, policy


def phase_rollout(card: str) -> int:
    cfg, env, policy = _flagship()
    # warm-up (allocator, cuDNN algorithm choice), outside the counted run
    state, out = env.reset(N_ENVS)
    rollout.collect(env, policy, state, out.obs,
                    torch.Generator(device="cuda").manual_seed(3), 2, GAMMA)
    torch.cuda.synchronize()

    gather.gather_image.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, out = env.reset(N_ENVS)
    t1 = time.perf_counter()
    state, obs, batch, stats = rollout.collect(
        env, policy, state, out.obs, torch.Generator(device="cuda").manual_seed(2),
        N_STEPS, GAMMA)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = gather.gather_image.launches

    if launches != 2 * (1 + N_STEPS):
        raise AssertionError(f"gather launched {launches} times, expected "
                             f"{2 * (1 + N_STEPS)}")
    for name, x in (*batch._asdict().items(), *stats._asdict().items()):
        if x.is_floating_point() and not torch.isfinite(x).all():
            raise AssertionError(f"non-finite {name}")
    assert batch.obs.shape == (N_STEPS, N_ENVS, env.obs_dim)
    assert batch.obs.dtype == torch.float32
    assert ((stats.coverage >= 0) & (stats.coverage <= 1)).all()
    assert (stats.coverage > 0).any(), "the cameras see the houses"
    next_values = torch.cat([batch.values[1:], batch.last_values[None]])
    time_outs = (stats.ep_length == cfg.max_episode_length).float()
    raw = batch.rewards - GAMMA * next_values * time_outs
    assert (raw >= 0).all(), "only_positive rewards are never negative"
    tri = batch.obs[..., 600:8600]
    assert ((tri == -1) | (tri == 0) | (tri == 1)).all()

    steps = N_ENVS * N_STEPS
    print(f"rollout: reset {t1 - t0:.3f} s, collect {N_STEPS} steps x {N_ENVS} "
          f"envs in {t2 - t1:.3f} s = {steps / (t2 - t1):.1f} env-steps/s "
          f"[{card}]; mean coverage at the last step "
          f"{float(stats.coverage[-1].mean()):.4f}, "
          f"{int(stats.num_dones.sum())} episodes ended, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return launches


def main() -> None:
    card = phase_device()
    phase_build()
    timing = phase_kernel()
    phase_golden()
    launches = phase_rollout(card)
    kernels = [{
        "name": "gather_image", "route": "cuda",
        "source": "gennbv_tpu_torch/csrc/gather_image.cu",
        "replaces": "gennbv_tpu/ops/pallas_gather.py:37",
        "launches": launches, **timing,
    }]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
