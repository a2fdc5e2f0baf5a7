"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --cache-pairs 10    # only the cache A/B, below

Phases, in order; any failure raises and the script exits non-zero:
1. a CUDA card must be present; print its name and power limit, the torch
   version and nvcc's;
2. build the eight kernels from gennbv_tpu_torch/csrc, one nvcc process per
   source, all started together (each timed), and print what ptxas says
   of each kernel (registers, shared memory, spills);
3. hold each kernel bit-equal to its plain PyTorch version at the shapes of
   the paths below and time both, with the bound of the card and one
   PyTorch library call where one computes the same function, warm
   (back-to-back calls) and cold (one call after an L2 flush that leaves
   clean lines, and one after a flush that leaves dirty lines; a trivial
   launch's cold time under each, measured once, is the floor); check
   under torch.profiler that each wrapper call is one device launch of its
   kernel:
   - the 400x400 held-out eval (50 envs, the 50 eval scenes' surface
     capacity Q, 20^3 grid): the fused splat z-buffer + visibility, the hit
     scatter, the carve gather and the exact scatter-min z-buffer;
   - the 128x128 flagship rollout (256 envs, Q = 11264): the same four;
   - the 128x128 DDA step of phase 9: the hit scatter of every pixel
     ([256, 16384] points) and the gather of the foreground mask (a {0,1}
     image, 256 x 128^2 x 8000);
   - phase 10's converted scenes: the three at the training set's Q
     (256 envs, 128x128) and at Q - 3 (the gather's scalar path), and at
     the held-out set's Q (50 envs, 400x400);
   - the flagship's 256 envs (Q = 11264) at the eval's 400x400 camera:
     the fused splat, the hit scatter and the carve gather;
   - tools/bench_scatter.py's defaults (256 x 11264 at 128x128, its
     numpy draws): the scatter-min z-buffer;
   - the PPO update's minibatch of 128: the Conv3d weight gradient of
     the encoder's two layers (the first's input a strided view of the
     observations, as in the update), which sums in its own fixed order,
     so it is held to the float64 gradient (within 2^-14 of the sum of
     the products' magnitudes) and to itself, bit for bit, call to call,
     at two device launches a call (the partial sums and their
     reduction), with torch.nn.grad.conv3d_weight under the port's
     deterministic cuDNN settings as the library call;
   - the DDA ray march at dda400.eval's step (50 eval scenes, 400x400,
     R=64) and at the DDA rollout's (256 envs, 128x128), held to the
     benchmark's exact march too;
   - the Bresenham carve at the same two steps (the hits of the march's
     depth in the 20^3 grid, from the camera voxels), a zero fill and one
     launch of its kernel a call, held to the benchmark's closed form too;
   - the nearest-neighbour kernel at the report's shapes (the 50 eval
     scenes' GT points, up to 8,192 a scene, and a scan of 3,000-4,500
     points near each surface, rounded to 1 cm and deduplicated): the
     three passes of batched_accuracy, one launch each, their bound from
     the benchmark's frozen count (benchmark/work/chamfer.py);
   and the gather once more on an image with planted values (bf16 ties,
   -0.0, a negative, empty pixels), and, without timing, at its edge
   cases at both image sizes: q of 1, 3 and 4, a ragged q and index
   arrays that are contiguous views off 16-byte alignment (the scalar
   path); the scatter-min once more on planted inputs (a pile-up on four
   pixels, an env with no valid point, negative depths, pixels that get
   only -0.0 or only +0.0, a pile-up on either side of a band edge) and,
   without timing, at Q of 1, 0 and a ragged Q, at env counts that do
   not divide over the card's CTAs (1, 133, 265 at 128x128, 51 at
   400x400) and at 37x53, 401x300 and 3000x1 (odd widths, env offsets off
   16-byte boundaries, a short last band);
4. run the mapping golden on the card (tests/goldens/mapping_golden.npz,
   tests/test_goldens.py's tolerances) through the three kernels of the
   splat path;
5. the rollout at the flagship size: 256 procedural scenes, 256 envs,
   128x128 camera, R=64 render grid, full-width HybridEncoder policy from a
   seeded generator, reset + collect(n_steps=128).  Checks the outputs and
   that each kernel of the splat path ran once per env step (the exact
   scatter-min never, here and in phases 4-14); prints env-steps/s and the
   device-time breakdown of 8 steps (torch.profiler);
6. the held-out eval at full size: 50 procedural scenes of seed 100, R=64,
   400x400 camera, eval_env_config (30-step episodes, coverage reward
   only), renderer.zbuf_impl=pallas and scatter_impl=pallas, the policy in
   deterministic mode.  Checks the exact launch count of each kernel
   (init-view cache, reset, 30 steps), the results, and that the same eval
   with zbuf_impl=mxu (no init-view cache; the same kernels) gives
   identical per-env coverage, AUC and rewards; prints eval env-steps/s and
   the device-time breakdown of one eval;
7. training at the flagship recipe's full size
   (reports/r5_refbudget128/config.json: 256 envs, 128x128 camera, R=64,
   PPO n_steps 128, batch 128, 5 epochs, target_kl 0.05, the linear
   schedule over 1000 iterations, 8 minibatch shards, seed 1), on phase
   5's scenes, with the 50 eval scenes of phase 6 under
   runner.eval_camera=400: Runner.train for 3 iterations (the first is
   the warm-up) with an eval and a checkpoint at the third.  Checks that
   the metrics are finite, the minibatch count and learning rate, that the
   parameters and both BatchNorms' running stats moved, each kernel's
   exact launch count, and that a fresh Runner restored from the
   checkpoint holds the same parameters, optimizer state and step bit for
   bit, and that two more Runners from the same seed on the same scenes,
   one at the recipe's runner.pipeline_depth (2) and one at depth 1, end
   with the same parameters, BatchNorm stats, Adam state, logged metrics
   (but time/*) and checkpoint files bit for bit; the first twin's
   dispatches after the first run under torch.profiler, and their CUDA
   runtime calls must hold no host wait (cudaStreamSynchronize,
   cudaDeviceSynchronize, cudaEventSynchronize, cudaMemcpy), each
   processed iteration exactly one event wait, its fetch; prints each
   iteration's fetch spacing and device seconds by phase (CUDA events),
   each depth's wall seconds, update minibatches/s and peak memory; then
   six more iterations of the loop, timing on the host each dispatch, the
   update's enqueue and each replay beside the CUDA-event spans, and a
   profiled window (the second of two unfenced iterations, to its 64th
   replay) giving the rollout's and the iteration's device-busy share;
   then the update alone, KL-gated and not, timed to the device's end,
   and the gated one's device-busy share, top device ops and device
   activities per minibatch over 32 minibatches; then the recipe at the
   400x400 camera (ref400.train's shape: constant learning rate, no eval,
   no checkpoint) on a Runner of its own: one Runner.train iteration with
   each kernel's launches held exactly, then one more under a
   device-only profile, where each kernel's device launches must equal
   the wrappers' counts, and the weight gradient's also the
   WGRAD_CALLS_PER_STEP launches of each replay of the update's graph;
8. the post-training report on phase 7's run directory:
   gennbv_tpu_torch/tools/post_run.py's main with --eval_cam 400
   --point_stride 8 --no-artifacts, at full size (held-out houses, objects
   zero-shot and the convex probe, 50 scenes each, reset + 30 steps, R=64,
   the full-width HybridEncoder from the phase-7 checkpoint).  Checks each
   kernel's exact launch count, that the report has the JAX report's keys
   (reports/r5_refbudget128/report.json) with finite values, and that each
   family's coverage, AUC and reward equal evaluate's without the accuracy
   scan on the same env and policy; holds batched_accuracy and the ray
   march on 2 envs bit-equal to the same functions on the CPU, and the
   card's accuracy to float64 scipy cKDTree nearest neighbours (1e-3
   relative); prints each family's evaluate seconds with and without the
   scan, the ray march's device time per view, the seconds of the host's
   dedupe and of batched_accuracy, and peak memory; holds the card's dedupe
   (dedupe_cm, one launch of each of its two kernels a call) bit-equal to
   its plain version on the card and to the host's np.unique on the
   held-out family's episode, and times the three.  Then train/play.py's main
   with --ply, --obj and --export on the card: the files are non-empty and
   the loaded torch.export program's actions equal the eager policy's.
9. the DDA, replay and callback env paths at full width: phase 5's 256
   scenes, 256 envs, 128x128, R=64, the full-width HybridEncoder from a
   seeded generator, reset + 16 collected steps with renderer.mode=dda,
   once with carve_mode=ztest and once with bresenham.  Checks each
   kernel's exact launches a step (the hit scatter once, the gather twice
   with ztest and never with bresenham, the Bresenham kernel once with
   bresenham and never with ztest, the splat never), holds 2 envs'
   step outputs and states to the port on the CPU over the same steps,
   records a replay bank at the visited poses with the card's DDA and
   requires a replay env to equal the dda env bit for bit, and a
   callback env over the same frames to agree too; prints env-steps/s,
   the DDA's and the Bresenham carve's device ms a step, device
   activities a step and peak memory;
10. the dataset pipeline at full width: 256 procedural houses of seed 0
   and 50 held-out ones of seed 100, meshed into OBJs in a temporary
   directory by the native mesher and converted by the port's
   convert_dataset (the voxelizer built into gennbv_tpu_torch/_build/);
   then 2 iterations of the flagship recipe on the training directory
   through train_eval_gennbv.main --eval_dataset <held-out directory>
   with an eval under runner.eval_camera=400, and post_run.main
   --eval_cam 400 --only held_out_houses --no-artifacts, which must take
   its held-out family from the run's config.json.  Checks each kernel's
   exact launch count and finite metrics; prints the convert's seconds,
   Q, iteration seconds, env-steps/s and peak memory.
11. the continuous-control path at the CLI's full width, which launches
   none of the kernels: train_rsl.main --task drone_velocity
   --num_envs 4096 --num_steps_per_env 24 --hidden 512 256 128 (the
   default ContinuousPPOConfig: 5 epochs x 4 minibatches of 24,576 rows,
   adaptive KL) for 3 iterations into a temporary log dir, saving each,
   then --resume to 4.  Checks that every logged metric is finite and
   the learning rate within [min_lr, max_lr], that the resumed run
   starts at iteration 3 from the parameters saved there, that no kernel
   launched, that two OnPolicyRunners from one seed end 2 iterations with
   the same parameters, optimizer state and logged metrics (but time/*)
   bit for bit, and that 256 drones stepped 8 times on the CPU from the
   card's state, with the same actions, agree with the card within
   tests/test_torch_drone.py's tolerance (the trained policy's forward
   within tests/test_torch_continuous.py's); prints each iteration's env-steps/s
   with its rollout and update seconds, the device-busy share and device
   activities per env step of an iteration under torch.profiler, and
   peak memory.
12. the legged robots, rough terrain, the recurrent family and the
   terrain scenes, each part's seconds printed:
   a. train_rsl.main --task a1_velocity (the CLI's default task) at phase
      11's width, 3 iterations then --resume to 4, as phase 11: finite
      metrics, the lr in range, the resume bit for bit, no kernel
      launched, two OnPolicyRunners from one seed bit-equal, and 256
      robots stepped 8 times on the CPU from the card's state (each step
      from a copy of the card's state before it) within
      tests/test_torch_legged.py's tolerance with equal contact, knee and
      done masks; prints each iteration's env-steps/s with its rollout and
      update seconds, the device activities and busy share of a rollout
      under torch.profiler, and peak memory;
   b. one iteration each of anymal_b_velocity, anymal_c_velocity and
      cassie_velocity at the same width: finite metrics, no kernel;
   c. a rough-terrain A1 with measure_heights (obs 235): the hash and
      the heights on the card against the CPU within the circular bound
      (CARD_HASH_BOUND), and 256 robots stepped on the card 8 times with
      the CPU's observation of each step's state held to the card's (the
      height grid to the bound);
   d. train_rsl.main --task a1_velocity --recurrent at 4,096 envs, 2
      iterations: finite metrics, lr in range, no kernel launched, two
      RecurrentOnPolicyRunners from one seed bit-equal, and
      export_recurrent_policy -> load_exported_policy equal to the
      runner's inference policy over 4 steps of carried hidden state;
      prints each iteration's rollout and update seconds;
   e. 256 terrain scenes (seed 0, R=64) through the flagship env on the
      splat path (256 envs, 128x128), reset + 16 steps of the seeded
      policy: each kernel launched exactly once a reset and a step,
      finite coverage, envs 0-1 bit-equal to the CPU step by step (as
      phase 9); prints Q, env-steps/s and peak memory.
13. the off-policy family and the all-families example, which launch
   none of the kernels, each part's seconds printed:
   a. SAC, TD3 and DDPG through OffPolicyRunner on 4,096 drones at the
      default OffPolicyConfig (MLPs 256-256, batch 256, a buffer of
      131,072 = 32 x 4,096, learning_starts 1,000, tau 0.005),
      learn(64, chunk=16): the first chunk random, then 48 gradient
      steps.  Checks that every metric and parameter is finite, that the
      actor, critic and targets moved (and SAC's alpha), the step count
      and the buffer's pos and size, that no kernel launched, that a
      second runner from the seed ends with the same parameters,
      targets, Adam states, log_alpha and buffer bit for bit with its
      actor moved on exactly the gradient steps where it should (TD3:
      step % 2 == 0), and that one update on the card agrees with the
      same update on the CPU within tests/test_torch_off_policy.py's
      tolerances; prints the random and the learning chunks' env-steps/s,
      gradient steps/s, ms an update, device activities, device busy and
      host time per env step of 4 learning steps (torch.profiler), the
      host's busiest operators, and peak memory;
   b. DQN through DQNRunner on IdentityEnvMultiDiscrete(nvec=(4,)) at
      4,096 envs and the default DQNConfig (batch 128, a buffer of
      65,536, a target sync every 250 gradient steps), learn(320,
      chunk=64): the same checks, the target equal to the online network
      just after the sync and unmoved between syncs;
   c. HER through HERRunner (the default SAC config) on
      GoalPointEnv(dim=2, ep_length=8, terminate_on_success=True) at 1,024
      envs, capacity_episodes 4,096, 6 rounds: the same checks, and
      segment_ends and one relabeled sample on the card equal to the
      CPU's bit for bit from the same draws;
   d. python -m gennbv_tpu_torch.examples.custom_env_families run whole
      on the card: every number it prints finite.
14. the mesh (parallel/mesh.py), each part's seconds printed:
   a. the flagship recipe of phase 7 for one iteration (256 envs x 128
      steps at 128x128, the 5-epoch update), first by a one-process
      Runner, then twice through the mesh path at runner.num_devices=1:
      a process group of one over nccl on a FileStore, the update's CUDA
      graph capturing its collectives.  Checks each kernel's exact launch
      count, that the rollout metrics equal the one-process run's bit for
      bit, the update's metrics finite with the same minibatch count, and
      the second mesh run equal to the first bit for bit; and, for one
      update of the full-width policy from a fixed 16-step rollout, that
      the first minibatch's summed gradients, BatchNorm stats and metrics
      on the mesh agree with one process within tests/test_torch_mesh.py's
      tolerance.  The whole update's sums in another order diverge over
      its 1,280 Adam steps, as a one-process run with every advantage one
      ulp up does: prints both divergences, the iteration's seconds and
      env-steps/s;
   b. graft_entry.dryrun_multichip(2) on two ranks sharing the card over
      gloo, and dryrun_multichip(4) (with its env 2 x model 2 tensor-
      parallel run) on four CPU ranks over gloo, as DTensor's collectives
      over gloo crashed on a shared card; prints their seconds.
15. the exact z-buffer path (renderer.zbuf_impl=scatter: the scatter-min
   kernel once a step, the gather twice, the hit scatter once, the fused
   splat never), each part's seconds printed:
   a. phase 5's 256 scenes, 256 envs, 128x128, R=64, the full-width
      HybridEncoder from a seeded generator: reset + 16 steps with each
      kernel's launches checked a step and envs 0-1 held to the port on
      the CPU (as phase 9), then reset + collect(n_steps=128) with exact
      launches and the outputs checked; prints env-steps/s, the device-
      busy share of 8 more steps and peak memory;
   b. phase 6's held-out eval (50 scenes of seed 100, 400x400, 30 steps;
      no init-view cache under scatter): exact launches, finite results;
      prints env-steps/s and the device-busy share;
   c. train_eval_gennbv.main on the flagship recipe with
      env.renderer.zbuf_impl=scatter, 2 iterations and an eval under
      runner.eval_camera=400: exact launches, finite metrics; prints each
      iteration's seconds;
   d. python -m gennbv_tpu_torch.tools.bench_scatter at its defaults:
      every form's line, the kernel bit-equal to the library scatter-min.
The meshes are converted before phase 3, which times the kernels at
their Q.  The last two lines of stdout are the kernel summary with the card's name
and power limit before them, then the result line
{"ok": true, "device": {...}}.  Imports nothing of JAX.

With --cache-pairs N the script runs phases 1-2 and then only N interleaved
pairs of the full-size eval with and without the init-view cache, and
prints their env-steps/s; it prints no result line.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from gennbv_tpu_torch import config, graft_entry, spec
from gennbv_tpu_torch.algo import (dqn, evaluation, gae, her, off_policy,
                                   on_policy_runner, ppo, rollout)
from gennbv_tpu_torch.algo import replay_buffer as rb
from gennbv_tpu_torch.algo import ppo_continuous as ppoc
from gennbv_tpu_torch.algo import ppo_recurrent
from gennbv_tpu_torch.algo.repro import first_difference, read_logged, snapshot
from gennbv_tpu_torch.algo.runner import _METRIC_KEYS, Runner
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.env import scene as scene_lib
from gennbv_tpu_torch.env import legged_robot
from gennbv_tpu_torch.env.drone_robot import DroneRobot
from gennbv_tpu_torch.env.legged_robot import LeggedRobot
from gennbv_tpu_torch.env.synthetic import GoalPointEnv, IdentityEnvMultiDiscrete
from gennbv_tpu_torch.env.depth_sources import (CallbackDepthSource,
                                                ReplayBank,
                                                ReplayDepthSource,
                                                record_replay_bank)
from gennbv_tpu_torch.models import actor_critic, gaussian
from gennbv_tpu_torch.models.actor_critic import GaussianActorCritic
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.models import distributions
from gennbv_tpu_torch.ops import (_cuda, backproject, bresenham, camera,
                                  carve, chamfer, conv3d_wgrad, dedupe, fp32,
                                  fused_splat, gather, nn_min, render,
                                  scatter, splat, voxel, zbuf_scatter)
from gennbv_tpu_torch.ops.kernels import WRAPPERS, launches, reset_launches
from gennbv_tpu_torch.examples import custom_env_families
from gennbv_tpu_torch.tools import bench_scatter, convert_dataset, post_run
from gennbv_tpu_torch.train import play, train_eval_gennbv, train_rsl
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.device import card_line

ROOT = os.path.dirname(os.path.abspath(__file__))
# phase 14 reuses tests/test_torch_mesh.py's update case (no jax there)
sys.path.append(os.path.join(ROOT, "tests"))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "mapping_golden.npz")
FLAGSHIP = os.path.join(ROOT, "reports", "r5_refbudget128", "config.json")
# the JAX package's report of the flagship run: the keys the port's must have
REFERENCE_REPORT = os.path.join(ROOT, "reports", "r5_refbudget128",
                                "report.json")
TRAIN_ITERS = 3
N_ENVS, HW, RES, N_STEPS, GAMMA = 256, 128, 64, 128, 0.99
# surface capacity Q of the 256 seed-0 scenes at R=64 (the fused splat's points)
ROLLOUT_Q = 11264
EVAL_HW, EVAL_SEED = 400, 100
POINT_STRIDE = 8                         # the accuracy scan's pixel stride
DDA_STEPS = 16                           # phase 9's collected steps a run
CPU_ENVS = 2                             # envs held to the CPU in phase 9
N_MESHES = 256                           # phase 10's training meshes
DATASET_ITERS = 2                        # phase 10's training iterations
G = spec.GRID_SIZE                       # the 20^3 grid; the carve gathers G^3
# phase 11: train_rsl's iterations before the resume, its width, and the
# drones and steps held to the CPU
RSL_ITERS, RSL_ENVS, RSL_STEPS, RSL_HIDDEN = 3, 4096, 24, (512, 256, 128)
RSL_CPU_ENVS, RSL_CPU_STEPS = 256, 8
# phase 12: the default legged task and the other robots, the recurrent
# run's iterations, and the terrain scenes and steps
LEGGED_TASK = "a1_velocity"
LEGGED_PROFILE_STEPS = 4
LEGGED_ZOO = ("anymal_b_velocity", "anymal_c_velocity", "cassie_velocity")
REC_ITERS = 2
TERRAIN_SCENES, TERRAIN_STEPS = 256, 16
# phase 15: the exact z-buffer path's steps held to the CPU, its training
# iterations
EXACT_CPU_STEPS, EXACT_ITERS = 16, 2
# tests/test_torch_legged.py's tolerance of a control step from the same
# state (of each field's largest magnitude), and the fields it holds
LEGGED_SCALE_TOL = 1e-3
LEGGED_FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd", "commands",
                 "torques", "contact_forces", "foot_anchor", "feet_air_time",
                 "ep_track", "ep_reward", "walked")
# the rough terrain's hash frac(sin(a) * 43758.5453) on the card against
# the CPU: CUDA's float32 sine is within 2 ulps (the CUDA math library's
# documented accuracy), the CPU's within 1, so the sines differ by at
# most 3 ulps of s (3 * 2^-24), which the gain turns into <= 7.9e-3, and
# each side rounds the product (ulp 2^-8) once: 2^-7 + 2^-8 on the circle
CARD_HASH_BOUND = 2.0 ** -7 + 2.0 ** -8
# phase 13: the off-policy runners' envs, env steps and chunk, the steps
# profiled; DQN's env steps and chunk (one target sync); HER's envs, buffer
# rounds and rounds
OFF_ENVS, OFF_STEPS, OFF_CHUNK, OFF_PROFILE_STEPS = 4096, 64, 16, 4
DQN_STEPS, DQN_CHUNK = 320, 64
HER_ENVS, HER_CAPACITY, HER_ROUNDS = 1024, 4096, 6
# tests/test_torch_off_policy.py's tolerances of an update: parameters,
# moments (relative, plus a share of the tensor's largest) and metrics
OP_PARAM_ATOL, OP_MOMENT_RTOL = 1e-6, 1e-4
OP_MOMENT_SHARE = {"mu": 2e-5, "nu": 4e-5}
OP_METRIC_RTOL, OP_METRIC_ATOL = 1e-5, 1e-6
# tests/test_torch_drone.py's tolerance of the drone's state and obs, and
# tests/test_torch_continuous.py's of the MLP forward
DRONE_RTOL, DRONE_ATOL = 1e-5, 1e-5
MLP_RTOL, MLP_ATOL = 1e-5, 1e-6
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s,
# and float32 operations/s outside the tensor cores, the rate the bounds
# below charge every arithmetic, compare and integer operation at
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# a cold call (_time_cold_ms): twice the H100's 50 MB L2 flushed before
# it, and a spin of this many cycles (~0.1 ms) ahead of it on the device
L2_FLUSH_BYTES = 100 * 2 ** 20
COLD_SPIN_CYCLES = 200_000
# the profiler's own kernels on each side of a profiled run, their
# length, the takes of a profile, and the most pads a profile lost on
# each side (see _profiled)
PROFILE_PADS, PAD_CYCLES, PROFILE_TAKES = 256, 50_000, 5
PADS_LOST = {"leading": 0, "trailing": 0}
# the CUDA runtime calls that make the host wait for the device (cudaMemcpy:
# the synchronous copy; PyTorch's copies to the host run cudaMemcpyAsync
# and cudaStreamSynchronize)
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")

# each kernel's source and the TPU kernel it replaces (the wrappers, by the
# same names: ops/kernels.WRAPPERS)
KERNELS = {
    "gather_image": ("gennbv_tpu_torch/csrc/gather_image.cu",
                     "gennbv_tpu/ops/pallas_gather.py:37"),
    "scatter_cells_any": ("gennbv_tpu_torch/csrc/scatter_cells_any.cu",
                          "gennbv_tpu/ops/pallas_scatter.py:47"),
    "zbuf_visible": ("gennbv_tpu_torch/csrc/zbuf_visible.cu",
                     "gennbv_tpu/ops/pallas_splat.py:80"),
    "zbuf_scatter_min": ("gennbv_tpu_torch/csrc/zbuf_scatter_min.cu",
                         "tools/bench_scatter.py:93"),
    # no TPU kernel: the JAX encoder's Conv3d gradients are XLA's
    "conv3d_wgrad": ("gennbv_tpu_torch/csrc/conv3d_wgrad.cu", None),
    # no TPU kernel: the JAX package's ray march is an XLA loop
    "raymarch": ("gennbv_tpu_torch/csrc/raymarch.cu", None),
    # no TPU kernel: the JAX package's Bresenham carve is an XLA loop
    "bresenham": ("gennbv_tpu_torch/csrc/bresenham.cu", None),
    # no TPU kernel: the JAX package's chamfer is plain jnp
    "nn_min": ("gennbv_tpu_torch/csrc/nn_min.cu", None),
    # no TPU kernel: the JAX package's 1 cm dedupe is np.unique on the host
    "dedupe_cm": ("gennbv_tpu_torch/csrc/dedupe_cm.cu", None),
}
assert set(KERNELS) == set(WRAPPERS)


# the __global__ function each wrapper launches, once a call (csrc/*.cu;
# conv3d_wgrad's second launch, its reduction, is WGRAD_REDUCE_FUNCTION;
# dedupe_cm's, after PyTorch's sort, DEDUPE_EMIT_FUNCTION)
PORT_KERNEL_FUNCTIONS = {
    "gather_image": "gather_image_kernel",
    "scatter_cells_any": "scatter_cells_any_kernel",
    "zbuf_visible": "zbuf_visible_cluster_kernel",
    "zbuf_scatter_min": "zbuf_scatter_min_kernel",
    "conv3d_wgrad": "conv3d_wgrad_partial_kernel",
    "raymarch": "raymarch_kernel",
    "bresenham": "bresenham_kernel",
    "nn_min": "nn_min_kernel",
    "dedupe_cm": "dedupe_key_kernel",
}
WGRAD_REDUCE_FUNCTION = "conv3d_wgrad_reduce_kernel"
DEDUPE_EMIT_FUNCTION = "dedupe_emit_kernel"
# batched_accuracy's passes (scan to GT, GT to scan, GT to GT), one launch
# of nn_min_kernel each on the card
NN_PASSES = 3
# the conv3d_wgrad wrapper's calls a minibatch step (the encoder's two
# Conv3d layers), and the eager steps of a Learner on a card before its
# graph's replays, which launch the kernel without a call
# (ppo.Learner._capture: two warm-ups and the captured step)
WGRAD_CALLS_PER_STEP = 2
EAGER_STEPS_PER_CAPTURE = 3
# the flagship update's minibatch (ppo.batch_size), phase 3's wgrad shapes
WGRAD_MINIBATCH = 128
# the float32 weight gradient against the float64 one: each output is a
# chain of fewer than 2^10 float32 additions (a chunk's positions, the
# CTA's parts, a reduce lane's chunks, the lanes), each rounding by at
# most 2^-24 of the running sum of the products' magnitudes
WGRAD_REL_TOL = 2.0 ** -14


def trained(expect: dict) -> dict:
    """`expect` with conv3d_wgrad's calls in a run whose updates ran on a
    card under one Learner, captured once."""
    return {**expect, "conv3d_wgrad": WGRAD_CALLS_PER_STEP
            * EAGER_STEPS_PER_CAPTURE}


def splat_expect(k: int) -> dict:
    """Each kernel's launches in a run of k env steps (resets and init-view
    caches counted as steps) on the splat path under zbuf_impl mxu or
    pallas: the fused splat, the hit scatter and the carve gather once a
    step; the exact scatter-min z-buffer, the ray march, the Bresenham
    carve, the nearest-neighbour passes and the dedupe never."""
    return {"gather_image": k, "scatter_cells_any": k, "zbuf_visible": k,
            "zbuf_scatter_min": 0, "conv3d_wgrad": 0, "raymarch": 0,
            "bresenham": 0, "nn_min": 0, "dedupe_cm": 0}


def exact_zbuf_expect(k: int) -> dict:
    """The same under zbuf_impl=scatter (ops/splat.py::zbuf_scatter_vis_px):
    the scatter-min z-buffer once a step, the gather twice (the visibility
    and the carve), the hit scatter once, the fused splat never."""
    return {"gather_image": 2 * k, "scatter_cells_any": k, "zbuf_visible": 0,
            "zbuf_scatter_min": k, "conv3d_wgrad": 0, "raymarch": 0,
            "bresenham": 0, "nn_min": 0, "dedupe_cm": 0}


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


def phase_build() -> dict:
    """Each kernel's library built afresh from the checkout, one nvcc
    process a source, all at once; returns the seconds each build took."""
    def build(name: str) -> float:
        so = _cuda.library_path(name)
        if so.exists():
            so.unlink()
        t0 = time.perf_counter()
        _cuda.load_library(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        secs = dict(zip(KERNELS, pool.map(build, KERNELS)))
    for name, s in secs.items():
        print(f"build: {name}.cu in {s:.2f} s ({len(KERNELS)} builds at once)")
        # ptxas -v: each kernel's registers, shared memory and spills
        for line in _cuda.BUILD_LOG[name].splitlines():
            if re.search(r"Used \d+ registers|spill", line):
                print(f"build: {name}.cu: ptxas: {line.strip()}")
    return secs


def _time_ms(fn, trials: int = 21, calls: int = 10) -> float:
    """Median over trials of the mean time of `calls` back-to-back calls,
    from CUDA events, after a warm-up.  Back to back, the inputs stay in
    L2 where they fit, as they do when the env step has just made them."""
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


def _l2_flush(kind: str):
    """A call that flushes the L2: "read" reads L2_FLUSH_BYTES written once
    before (a sum into a scalar), so the L2 is left holding clean lines
    that any later call evicts for free; "zero" writes them, so the L2 is
    left full of dirty lines and each line a later call allocates first
    writes one back to HBM."""
    buf = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    if kind == "zero":
        return buf.zero_
    sink = torch.empty((), device="cuda")
    return lambda: torch.sum(buf, 0, out=sink)


def _time_cold_ms(fn, trials: int = 21, flush: str = "read") -> float:
    """Median over trials of one call's time from CUDA events, each call
    made after an L2 flush (_l2_flush(flush)) and behind a spin kernel
    that keeps the device busy while the host enqueues the call: the
    events time the device's work on inputs that must come from HBM, as
    the bound assumes."""
    flush_l2 = _l2_flush(flush)
    fn()
    times = []
    for _ in range(trials):
        flush_l2()
        torch.cuda._sleep(COLD_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cold_floor_ms(flush: str = "read") -> float:
    """_time_cold_ms of a trivial launch (one float incremented): what any
    cold call costs on this card, whatever its work."""
    one = torch.zeros(1, device="cuda")
    return _time_cold_ms(lambda: one.add_(1.0), flush=flush)


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms: the larger of the bytes over the HBM rate and
    the operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _equal(label, got, want) -> float:
    """Raises unless the kernel's outputs equal the plain version's bit
    for bit; returns the largest difference (0.0)."""
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"{label}: kernel differs from plain: max "
                f"{float((g.float() - w.float()).abs().max())}")
        err = max(err, float((g.float() - w.float()).abs().max()))
    return err


class Span(NamedTuple):
    """A device record as ``_profiled(..., raw=True)`` returns it."""
    name: str
    start_ns: int


def _device_spans(prof, raw: bool) -> list:
    """The profile's device activities (user annotations excluded) in the
    order of their device start: FunctionEvents, or with `raw` Spans read
    straight from kineto's records (no event tree is built)."""
    from torch.autograd import DeviceType
    if raw:
        return sorted((Span(e.name(), e.start_ns())
                       for e in prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA
                       and not e.is_user_annotation()),
                      key=lambda s: s.start_ns)
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation),
                  key=lambda e: e.time_range.start)


def _profiled(label: str, run, raw: bool = False):
    """Runs `run` under torch.profiler; returns its value and its device
    activities (user annotations excluded) in the order of their device
    start.  With `raw` (a run of hundreds of thousands of kernels: a whole
    training iteration) the profile records no host activity and returns
    the device's as Spans.

    On the card, a profile taken in a process that has worked for a while
    can lose device records at either end of its session, more of them
    the older the process, now and then all of them (as measured on an
    NVIDIA H100 80GB HBM3).  So PROFILE_PADS spin
    kernels of the profiler's own, each spinning PAD_CYCLES, are launched
    and finished on each side of `run`: its activities are those between
    the last leading pad and the first trailing one.  A profile that kept
    no pad on one side lost more than that: the profiler's fault, not the
    program's, so it is taken again, up to PROFILE_TAKES times, each take
    printed.  PADS_LOST keeps the most pads lost on each side."""
    from torch.profiler import ProfilerActivity

    def pads():
        for _ in range(PROFILE_PADS):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()

    activities = [ProfilerActivity.CUDA]
    if not raw:
        activities.append(ProfilerActivity.CPU)
    for take in range(1, PROFILE_TAKES + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            pads()
            value = run()
            torch.cuda.synchronize()
            pads()
        spans = _device_spans(prof, raw)
        is_pad = ["spin_kernel" in e.name for e in spans]
        lead = next((i for i, p in enumerate(is_pad) if not p), len(spans))
        tail = len(spans) - next((i for i, p in enumerate(reversed(is_pad))
                                  if not p), len(spans))
        if 0 < lead <= tail < len(spans) and not any(is_pad[lead:tail]):
            PADS_LOST["leading"] = max(PADS_LOST["leading"], PROFILE_PADS - lead)
            PADS_LOST["trailing"] = max(PADS_LOST["trailing"],
                                        PROFILE_PADS - (len(spans) - tail))
            return value, spans[lead:tail]
        print(f"{label}: profile {take} of {PROFILE_TAKES} lost the device's "
              f"records: {len(spans)} device activities, {sum(is_pad)} of "
              f"the {2 * PROFILE_PADS} pads, {lead} leading, "
              f"{len(spans) - tail} trailing")
    raise AssertionError(f"{label}: the profiler lost the device's records "
                         f"{PROFILE_TAKES} times")


def profile_calls(fn, calls: int = 20) -> tuple[float, float, set]:
    """Runs fn `calls` times back to back under torch.profiler, after one
    call outside it; returns the device activities per call, their device
    time per call in ms, and their names."""
    def run():
        for _ in range(calls):
            fn()

    fn()
    _, spans = _profiled("profile_calls", run)
    return (len(spans) / calls,
            sum(e.time_range.end - e.time_range.start for e in spans) / calls / 1e3,
            {e.name for e in spans})


def _case(label, name, kernel, plain, library, nbytes, ops) -> dict:
    """Kernel vs plain version, bit for bit; one device launch of the
    kernel per wrapper call; then timed beside the library call and the
    bound: warm (back-to-back calls, the inputs in L2 where they fit) and
    cold (one call after an L2 flush)."""
    err = _equal(label, kernel(), plain())
    per_call, device_ms, names = profile_calls(kernel)
    if per_call != 1 or not all(PORT_KERNEL_FUNCTIONS[name] in n for n in names):
        raise AssertionError(
            f"{label}: {per_call} device launches a call ({sorted(names)}), "
            f"expected one launch of {PORT_KERNEL_FUNCTIONS[name]}")
    bound_ms, bound_by = _bound(nbytes, ops)
    res = {"max_abs_err": err, "ms": _time_ms(kernel), "plain_ms": _time_ms(plain),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None if library is None else _time_ms(library),
           # cold: after a clean flush (read), and after a dirty one (zero)
           "cold_ms": _time_cold_ms(kernel),
           "library_cold_ms": None if library is None else _time_cold_ms(library),
           "cold_dirty_ms": _time_cold_ms(kernel, flush="zero"),
           "library_cold_dirty_ms": (None if library is None else
                                     _time_cold_ms(library, flush="zero")),
           "device_launches_per_call": per_call, "kernel_device_ms": device_ms,
           # the library call's own device time, profiled as the kernel's
           "library_device_ms": (None if library is None
                                 else profile_calls(library)[1])}
    lib = ("none" if library is None else
           f"{res['library_ms']:.4f} ms (device {res['library_device_ms']:.4f} "
           f"ms, cold {res['library_cold_ms']:.4f} ms, dirty "
           f"{res['library_cold_dirty_ms']:.4f} ms)")
    print(f"{label}: kernel {res['ms']:.4f} ms (cold {res['cold_ms']:.4f} ms, "
          f"dirty {res['cold_dirty_ms']:.4f} ms), plain {res['plain_ms']:.4f} "
          f"ms, library {lib}, bound {bound_ms:.4f} ms ({bound_by}) (median, "
          f"CUDA events; cold after a clean L2 flush, dirty after a dirty "
          f"one); {per_call:g} device launch a call, {device_ms:.4f} ms of "
          "device time (profiler)")
    return res


def gather_case(label, img, vi, ui) -> dict:
    n, h, w = img.shape
    flat = vi.long() * w + ui.long()
    img16 = img.to(torch.bfloat16).float().reshape(n, h * w)
    return _case(
        label, "gather_image",
        lambda: (gather.gather_image(img, vi, ui),),
        lambda: (gather.gather_image_ref(img, vi, ui),),
        # library: one torch.gather on the image already rounded to bf16,
        # with the flat indices precomputed (excludes both)
        lambda: torch.gather(img16, 1, flat),
        *gather.work(img, vi, ui))


def scatter_case(label, idx, valid) -> dict:
    n = idx.shape[0]
    flat = (idx[..., 0].long() * G + idx[..., 1]) * G + idx[..., 2]
    flat = torch.where(valid, flat, G ** 3)
    grid = torch.zeros(n, G ** 3 + 1, device=idx.device)
    return _case(
        label, "scatter_cells_any",
        lambda: (scatter.scatter_cells_any(idx, valid, G),),
        lambda: (scatter.scatter_cells_any_ref(idx, valid, G),),
        # library: one scatter_ of 1.0 into a zeroed grid with a spare
        # cell, the flat indices precomputed (excludes both)
        lambda: grid.scatter_(1, flat, 1.0),
        *scatter.work(idx, valid, G))


def splat_case(label, vic, uic, z, ok, veps, h, w, depth_max) -> dict:
    return _case(
        label, "zbuf_visible",
        lambda: fused_splat.zbuf_visible(vic, uic, z, ok, veps, h, w, depth_max),
        lambda: fused_splat.zbuf_visible_ref(vic, uic, z, ok, veps, h, w,
                                             depth_max),
        None,            # no single PyTorch call computes this function
        *fused_splat.work(vic, uic, z, ok, veps, h, w))


def zbuf_geometry(n: int, q: int, h: int, w: int):
    """The scatter-min's geometry on this card and its description."""
    geo = zbuf_scatter.geometry(n, q, h, w, zbuf_scatter.sm_count(0))
    return geo, (f"{geo.bands} bands of {geo.rows} rows, {n * geo.bands} "
                 f"items on {geo.ctas} CTAs")


def zbuf_scatter_case(label, flat, zz, h, w, fill) -> dict:
    n, q = flat.shape
    flat64 = flat.long()
    image = torch.full((n, h * w), fill, device=flat.device)
    _, text = zbuf_geometry(n, q, h, w)
    return _case(
        f"{label} ({text})", "zbuf_scatter_min",
        # compared as bits, so that -0.0 and +0.0 differ
        lambda: (zbuf_scatter.zbuf_scatter_min(flat, zz, h, w, fill)
                 .view(torch.int32),),
        lambda: (zbuf_scatter.zbuf_scatter_min_ref(flat, zz, h, w, fill)
                 .view(torch.int32),),
        # library: one scatter_reduce_ (amin) into a filled image, the int64
        # indices precomputed (excludes both; a min is idempotent, so the
        # image is not refilled)
        lambda: image.scatter_reduce_(1, flat64, zz, reduce="amin"),
        *zbuf_scatter.work(flat, zz, h, w))


def wgrad_inputs(n: int, seed: int):
    """The update's two weight gradients' inputs at a minibatch of n: the
    first layer's X a strided view of observations with a tri-class grid
    (as the update slices it), the second's a ReLU's output; dY normal."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    obs = torch.randn(n, spec.OBS_DIM, device="cuda", generator=gen)
    grid = obs[:, spec.STATE_DIM: spec.STATE_DIM + spec.GRID_DIM]
    grid.copy_(torch.randint(-1, 2, grid.shape, device="cuda",
                             generator=gen).float())
    x1 = grid.reshape(n, 1, G, G, G)
    g1 = conv3d_wgrad.out_size(G)
    g2 = conv3d_wgrad.out_size(g1)
    c = config.ModelConfig().grid_channels
    x2 = torch.rand(n, c, g1, g1, g1, device="cuda", generator=gen)
    return ((x1, torch.randn(n, c, g1, g1, g1, device="cuda", generator=gen)),
            (x2, torch.randn(n, c, g2, g2, g2, device="cuda", generator=gen)))


def wgrad_held(label: str, x, dy) -> float:
    """Raises unless conv3d_wgrad's dW and db lie within WGRAD_REL_TOL of
    the sum of the products' magnitudes from the float64 gradient, and two
    calls give the same bits; returns the largest error over that sum."""
    dw, db = conv3d_wgrad.conv3d_wgrad(x, dy)
    again = conv3d_wgrad.conv3d_wgrad(x, dy)
    if not (torch.equal(dw, again[0]) and torch.equal(db, again[1])):
        raise AssertionError(f"{label}: two calls differ")
    want = conv3d_wgrad.conv3d_wgrad_ref(x.double(), dy.double())
    scale = conv3d_wgrad.conv3d_wgrad_ref(x.double().abs(), dy.double().abs())
    err = max(float(((g.double() - w).abs() / s.clamp_min(1e-300)).max())
              for g, w, s in zip((dw, db), want, scale))
    if not err <= WGRAD_REL_TOL:
        raise AssertionError(f"{label}: {err:.3g} of the magnitudes' sum "
                             f"from the float64 gradient (limit "
                             f"{WGRAD_REL_TOL:.3g})")
    return err


def wgrad_case(label: str, x, dy) -> dict:
    """conv3d_wgrad held (wgrad_held), two device launches a call (its
    partial sums, then their reduction), timed as _case times a kernel
    beside the plain version and torch.nn.grad.conv3d_weight under the
    port's deterministic cuDNN settings (the library)."""
    fp32.deterministic_fp32()
    err = wgrad_held(label, x, dy)
    kernel = lambda: conv3d_wgrad.conv3d_wgrad(x, dy)
    plain = lambda: conv3d_wgrad.conv3d_wgrad_ref(x, dy)
    w_shape = (dy.shape[1], x.shape[1], 3, 3, 3)
    library = lambda: torch.nn.grad.conv3d_weight(x, w_shape, dy, stride=2)
    per_call, device_ms, names = profile_calls(kernel)
    fns = (PORT_KERNEL_FUNCTIONS["conv3d_wgrad"], WGRAD_REDUCE_FUNCTION)
    if per_call != 2 or not all(any(f in n for f in fns) for n in names) \
            or not all(any(f in n for n in names) for f in fns):
        raise AssertionError(f"{label}: {per_call} device launches a call "
                             f"({sorted(names)}), expected {fns} once each")
    bound_ms, bound_by = _bound(*conv3d_wgrad.work(x, dy))
    res = {"max_rel_err": err, "ms": _time_ms(kernel),
           "plain_ms": _time_ms(plain), "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": _time_ms(library),
           "cold_ms": _time_cold_ms(kernel),
           "library_cold_ms": _time_cold_ms(library),
           "cold_dirty_ms": _time_cold_ms(kernel, flush="zero"),
           "library_cold_dirty_ms": _time_cold_ms(library, flush="zero"),
           "device_launches_per_call": per_call, "kernel_device_ms": device_ms,
           "library_device_ms": profile_calls(library)[1],
           "geometry": conv3d_wgrad.geometry(
               x.shape[0], dy[0, 0].numel(), x.shape[1], dy.shape[1],
               zbuf_scatter.sm_count(x.get_device()))._asdict()}
    print(f"{label}: kernel {res['ms']:.4f} ms (cold {res['cold_ms']:.4f} "
          f"ms, dirty {res['cold_dirty_ms']:.4f} ms), plain "
          f"{res['plain_ms']:.4f} ms, library {res['library_ms']:.4f} ms "
          f"(device {res['library_device_ms']:.4f} ms, cold "
          f"{res['library_cold_ms']:.4f} ms, dirty "
          f"{res['library_cold_dirty_ms']:.4f} ms), bound {bound_ms:.4f} ms "
          f"({bound_by}) (median, CUDA events); {per_call:g} device "
          f"launches a call, {device_ms:.4f} ms of device time (profiler); "
          f"{err:.3g} of the magnitudes' sum from float64; geometry "
          f"{res['geometry']}")
    return res


def march_args(scenes, cam: config.CameraConfig):
    """The ray march's arguments at a step of every scene of `scenes` under
    `cam`, each seen from a pose of _step_poses: (occ, box_lo, box_hi,
    origin, dirs, R, 3R, depth_max), dirs the camera rays rotated as
    render_depth rotates them."""
    _, r, t, _ = _step_poses(scenes, cam)
    rays = torch.as_tensor(camera.camera_rays(cam.height, cam.width,
                                              cam.horizontal_fov_deg),
                           device=r.device)
    dirs = fp32.rotate_fma(rays, r.transpose(-1, -2))
    return (scenes.render_occ, scenes.box_lo, scenes.box_hi, t, dirs,
            scenes.grid_res, 3 * scenes.grid_res, cam.depth_max)


def march_held(label: str, args) -> torch.Tensor:
    """Raises unless the kernel's depth and hit equal the plain loop's on
    the card bit for bit, and the benchmark's own march
    (benchmark/reference/env_exact.py), and unless a traced call counts
    the exact march's voxel reads; returns the reads [N, P]."""
    from benchmark.reference import env_exact
    got = render.raymarch(*args)
    want = render.raymarch_ref(*args)
    _equal(label, (got[0].view(torch.int32), got[1]),
           (want[0].view(torch.int32), want[1]))
    depth, hit, reads = env_exact.march(*args)
    if not (torch.equal(got[0], depth) and torch.equal(got[1], hit)):
        raise AssertionError(f"{label}: kernel differs from the benchmark's "
                             "exact march")
    before = profiling.counters("raymarch/").get("raymarch/voxel_reads", 0)
    with profiling.tracing():
        render.raymarch(*args)
    counted = profiling.counters("raymarch/")["raymarch/voxel_reads"] - before
    if counted != int(reads.sum()):
        raise AssertionError(f"{label}: raymarch/voxel_reads counted "
                             f"{counted}, the exact march read "
                             f"{int(reads.sum())}")
    return reads


def march_case(label: str, scenes, cam: config.CameraConfig) -> dict:
    """The ray march's kernel on march_args(scenes, cam): held
    (march_held), one device launch of raymarch_kernel a call (while the
    profiler records, the fill and the sum of its reads counter beside
    it), timed as _case times a kernel beside the plain loop and the whole
    render_depth (the rotation of the rays in PyTorch, then the kernel);
    the bound is the benchmark's own count of the march's work
    (benchmark/work/raymarch.py) at the exact march's reads."""
    from benchmark.work import raymarch as march_work
    args = march_args(scenes, cam)
    reads = march_held(label, args)
    kernel = lambda: render.raymarch(*args)
    plain = lambda: render.raymarch_ref(*args)
    _, r, t, _ = _step_poses(scenes, cam)
    rays = torch.as_tensor(camera.camera_rays(cam.height, cam.width,
                                              cam.horizontal_fov_deg),
                           device=r.device)
    whole = lambda: render.render_depth(args[0], args[1], args[2], rays, r, t,
                                        *args[5:])
    calls = 10

    def run():
        for _ in range(calls):
            kernel()

    kernel()
    _, spans = _profiled(label, run)
    fn = PORT_KERNEL_FUNCTIONS["raymarch"]
    marches = [e for e in spans if fn in e.name]
    if len(marches) != calls:
        raise AssertionError(f"{label}: {len(marches)} launches of {fn} in "
                             f"{calls} calls ({sorted({e.name for e in spans})})")
    device_ms = sum(e.time_range.end - e.time_range.start
                    for e in marches) / calls / 1e3
    n, p = args[4].shape[:2]
    bound_ms, bound_by = _bound(*march_work.work(int(reads.sum()), n * p, n,
                                                 args[5]))
    res = {"max_abs_err": 0.0, "ms": _time_ms(kernel),
           "plain_ms": _time_ms(plain, trials=3, calls=1),
           "render_depth_ms": _time_ms(whole),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "cold_ms": _time_cold_ms(kernel),
           "cold_dirty_ms": _time_cold_ms(kernel, flush="zero"),
           "device_launches_per_call": 1, "kernel_device_ms": device_ms,
           "reads_per_ray": int(reads.sum()) / (n * p),
           "longest_ray": int(reads.max())}
    print(f"{label}: kernel {res['ms']:.4f} ms (cold {res['cold_ms']:.4f} ms, "
          f"dirty {res['cold_dirty_ms']:.4f} ms), plain loop "
          f"{res['plain_ms']:.4f} ms, render_depth {res['render_depth_ms']:.4f}"
          f" ms, bound {bound_ms:.4f} ms ({bound_by}) (median, CUDA events); "
          f"1 device launch a call, {device_ms:.4f} ms of device time "
          f"(profiler); {res['reads_per_ray']:.2f} voxel reads a ray, the "
          f"longest {res['longest_ray']}; bit-equal to the plain loop and to "
          "the benchmark's exact march, its reads counted")
    return res


def carve_args(scenes, cam: config.CameraConfig):
    """The Bresenham carve's arguments at a DDA step of every scene of
    `scenes` under `cam`, each seen from a pose of _step_poses, as
    carve_bresenham builds them: (camera voxels [N, 3], the G^3 grid's
    voxels [G^3, 3], the hit voxels of the march's depth [N, G^3], G)."""
    poses, _, _, _ = _step_poses(scenes, cam)
    (idx, in_bounds), _ = _dda_step_inputs(scenes, cam)
    hit = voxel.scatter_hits(G, idx, in_bounds)
    src = voxel.pose_to_voxel_idx(poses[:, :3], scenes.range_gt,
                                  scenes.voxel_size)
    return (src, carve.grid_voxels(G, src.device),
            hit.reshape(hit.shape[0], -1) > 0.5, G)


def carve_case(label: str, scenes, cam: config.CameraConfig) -> dict:
    """The Bresenham carve's kernel on carve_args(scenes, cam): bit-equal
    to the plain loop on the card and to the benchmark's closed form
    (benchmark/reference/env_exact.bresenham); a call is one zero fill and
    one launch of bresenham_kernel (torch.profiler); timed as _case times
    a kernel beside the plain loop, the bound ops/bresenham.work's."""
    from benchmark.reference import env_exact
    args = carve_args(scenes, cam)
    src, _, valid, g = args
    n = src.shape[0]
    kernel = lambda: bresenham.bresenham(*args)
    plain = lambda: carve.bresenham_traversed_ref(*args)
    got = kernel()
    _equal(label, (got,), (plain(),))
    closed = env_exact.bresenham(valid.float().reshape(n, g, g, g),
                                 src.long(), g)
    if not torch.equal(got, closed):
        raise AssertionError(f"{label}: kernel differs from the benchmark's "
                             "closed form")
    calls = 10

    def run():
        for _ in range(calls):
            kernel()

    kernel()
    _, spans = _profiled(label, run)
    fn = PORT_KERNEL_FUNCTIONS["bresenham"]
    carves = [e for e in spans if fn in e.name]
    if len(carves) != calls or len(spans) != 2 * calls:
        raise AssertionError(f"{label}: {len(spans)} device records and "
                             f"{len(carves)} launches of {fn} in {calls} "
                             f"calls ({sorted({e.name for e in spans})}), "
                             "expected a fill and a launch a call")

    def device_ms(records):
        return sum(e.time_range.end - e.time_range.start
                   for e in records) / calls / 1e3

    bound_ms, bound_by = _bound(*bresenham.work(*args))
    res = {"max_abs_err": 0.0, "ms": _time_ms(kernel),
           "plain_ms": _time_ms(plain, trials=5, calls=2),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "cold_ms": _time_cold_ms(kernel),
           "cold_dirty_ms": _time_cold_ms(kernel, flush="zero"),
           "device_launches_per_call": 2, "kernel_device_ms": device_ms(carves),
           "call_device_ms": device_ms(spans),
           "rays": int(valid.sum()), "cells_carved": int(got.sum())}
    print(f"{label}: kernel {res['ms']:.4f} ms (cold {res['cold_ms']:.4f} ms, "
          f"dirty {res['cold_dirty_ms']:.4f} ms), plain loop "
          f"{res['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
          f"(median, CUDA events); a zero fill and 1 launch a call, "
          f"{res['kernel_device_ms']:.4f} ms of the kernel's device time, "
          f"{res['call_device_ms']:.4f} ms with the fill (profiler); "
          f"{res['rays']} rays, {res['cells_carved']} cells carved; "
          "bit-equal to the plain loop and to the benchmark's closed form")
    return res


def nn_scans(scenes, seed: int = 25):
    """batched_accuracy's inputs at the report's shapes on `scenes`: for
    each scene a scan of 3,000-4,500 points near its surface (GT points
    moved by 2 cm of noise), rounded to 1 cm and deduplicated as the eval
    dedupes its views; the GT points and mask, and each scene's render
    voxel, on the host."""
    gt = scenes.gt_points.cpu().numpy()
    gt_mask = scenes.gt_points_mask.cpu().numpy()
    rng = np.random.default_rng(seed)
    scans = []
    for e in range(gt.shape[0]):
        pts = gt[e][gt_mask[e]]
        pick = pts[rng.integers(0, len(pts), rng.integers(3000, 4500))]
        seen = pick + rng.normal(size=pick.shape).astype(np.float32) * 0.02
        scans.append(np.unique(np.round(seen, 2), axis=0))
    vox = ((scenes.box_hi - scenes.box_lo).cpu().numpy().max(axis=1)
           / scenes.grid_res)
    return scans, gt, gt_mask, vox


def nn_passes(scenes):
    """The report's three nearest-neighbour passes on nn_scans(scenes),
    padded as batched_accuracy pads them.  Returns (each pass's arguments
    of nn_min.nn_min on the card, each env's (scan points, GT points) for
    the frozen count)."""
    scans, gt, gt_mask, _ = nn_scans(scenes)
    pmax = -(-max(map(len, scans)) // 1024) * 1024
    scan = np.zeros((len(scans), pmax, 3), np.float32)
    smask = np.zeros((len(scans), pmax), bool)
    for e, p in enumerate(scans):
        scan[e, :len(p)], smask[e, :len(p)] = p, True
    s, sm, g, gm = (torch.as_tensor(x, device="cuda")
                    for x in (scan, smask, gt, gt_mask))
    passes = ((s, sm, g, gm, False), (g, gm, s, sm, False),
              (g, gm, g, gm, True))
    return passes, [(len(p), int(m)) for p, m in zip(scans, gt_mask.sum(1))]


def nn_case(label: str, scenes) -> dict:
    """The nearest-neighbour kernel on nn_passes(scenes): each pass
    bit-equal to the plain loop (chamfer._row_mins_ref, 128 query rows a
    step over every env) on the card; a call of the three passes is three
    launches of nn_min_kernel and nothing else (torch.profiler); timed as
    _case times a kernel beside the plain loop, the bound the benchmark's
    frozen count of the three passes (benchmark/work/chamfer.py)."""
    from benchmark.work import chamfer as work_chamfer
    passes, counts = nn_passes(scenes)
    kernel = lambda: [nn_min.nn_min(*p) for p in passes]
    plain = lambda: [chamfer._row_mins_ref(a, am, b, bm, 128, ex)
                     for a, am, b, bm, ex in passes]
    _equal(label, kernel(), plain())
    calls = 10

    def run():
        for _ in range(calls):
            kernel()

    kernel()
    _, spans = _profiled(label, run)
    fn = PORT_KERNEL_FUNCTIONS["nn_min"]
    if len(spans) != NN_PASSES * calls or not all(fn in e.name for e in spans):
        raise AssertionError(f"{label}: {len(spans)} device records in "
                             f"{calls} calls ({sorted({e.name for e in spans})}"
                             f"), expected {NN_PASSES} launches of {fn} a call")
    device_ms = sum(e.time_range.end - e.time_range.start
                    for e in spans) / calls / 1e3
    bound_ms = work_chamfer.least_seconds(counts, F32_OPS_PER_S,
                                          HBM_BYTES_PER_S) * 1e3
    computed = sum(nn_min.pairs(am.cpu().numpy(), bm.cpu().numpy())
                   for _, am, _, bm, _ in passes)
    res = {"max_abs_err": 0.0, "ms": _time_ms(kernel),
           "plain_ms": _time_ms(plain, trials=3, calls=1),
           "bound_ms": bound_ms, "bound_by": "operations", "library_ms": None,
           "cold_ms": _time_cold_ms(kernel),
           "cold_dirty_ms": _time_cold_ms(kernel, flush="zero"),
           "device_launches_per_call": NN_PASSES,
           "kernel_device_ms": device_ms,
           "least_pairs": work_chamfer.pairs(counts),
           "pairs_computed": computed}
    print(f"{label}: kernel {res['ms']:.4f} ms (cold {res['cold_ms']:.4f} ms, "
          f"dirty {res['cold_dirty_ms']:.4f} ms), plain loop "
          f"{res['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms (operations: "
          f"the frozen count's {res['least_pairs']:.4g} pairs) (median, CUDA "
          f"events); {NN_PASSES} launches a call, {device_ms:.4f} ms of "
          f"device time (profiler), {100 * bound_ms / device_ms:.1f}% of the "
          f"bound; {computed:.4g} pairs computed "
          f"({computed / res['least_pairs']:.4f} of the least); bit-equal to "
          "the plain loop")
    return res


def exact_zbuf_inputs(vic, uic, z, ok, w, depth_max):
    """What zbuf_scatter_vis_px hands the scatter-min: each point's pixel
    in its env's image and its depth, depth_max where it is not valid."""
    return vic * w + uic, torch.where(ok, z, depth_max)


def tool_zbuf_inputs(n: int = 256, q: int = 11264, cam: int = 128):
    """tools/bench_scatter.py's z-buffer inputs at its defaults, from
    numpy's RandomState(0) as there: (flat, zz) on the card."""
    rng = np.random.RandomState(0)
    vi, ui = (rng.randint(0, cam, (n, q)) for _ in range(2))
    z = rng.uniform(1.0, 30.0, (n, q)).astype(np.float32)
    ok = rng.rand(n, q) < 0.7
    zz = np.where(ok, z, np.float32(bench_scatter.DMAX))
    return (torch.as_tensor(vi * cam + ui, dtype=torch.int32, device="cuda"),
            torch.as_tensor(zz, device="cuda"))


def planted_zbuf_inputs(n: int, q: int, h: int, w: int, depth_max: float):
    """Random pixels and depths in [1, 30) at [n, q] on an h x w image,
    25% at depth_max (not valid), with planted envs (those of the first
    four that n keeps): env 0 piles its points on four pixels, env 1 has
    no valid point, env 2's depths are in [-30, 30) with a pixel that gets
    only -0.0 and one that gets only +0.0, env 3 piles half its points on
    the two pixels on either side of the kernel's first band edge (the
    image's middle where an env is one band)."""
    m, hw = max(n, 4), h * w
    gen = torch.Generator(device="cuda").manual_seed(n + q + hw)
    flat = torch.randint(0, hw, (m, q), device="cuda", dtype=torch.int32,
                         generator=gen)
    zz = torch.rand(m, q, device="cuda", generator=gen) * 29.0 + 1.0
    zz[torch.rand(m, q, device="cuda", generator=gen) < 0.25] = depth_max
    flat[0] %= 4
    zz[1] = depth_max
    zz[2] = zz[2] * (60.0 / 29.0) - 32.0
    k = min(q, 2)
    flat[2, :k] = torch.tensor([7, 8], dtype=torch.int32)[:k]
    zz[2][flat[2] == 7] = -0.0
    zz[2][flat[2] == 8] = 0.0
    if n > 0 and hw > 1:
        geo = zbuf_scatter.geometry(n, q, h, w, zbuf_scatter.sm_count(0))
        edge = geo.rows * w if geo.bands > 1 else hw // 2
        flat[3, : q // 2] = edge - 1 + torch.arange(
            q // 2, device="cuda", dtype=torch.int32) % 2
    return flat[:n].contiguous(), zz[:n].contiguous()


# the scatter-min's edge cases: (envs, image height, width, points an env):
# one point, no point, a ragged Q, one env; env counts that do not divide
# over the card's CTAs (1, 133, 265 at 128x128, 51 at 400x400); odd widths
# and env offsets off 16-byte boundaries (37x53), bands of 91 pixels
# (3000x1 on 132 SMs), a short last band (401 rows); every case with four
# envs or more piles points on either side of a band edge
ZBUF_EDGES = [(spec.EVAL_NUM_ENVS, EVAL_HW, EVAL_HW, 1),
              (spec.EVAL_NUM_ENVS, EVAL_HW, EVAL_HW, 0),
              (N_ENVS, HW, HW, ROLLOUT_Q - 3), (1, EVAL_HW, EVAL_HW, 9215),
              (1, HW, HW, ROLLOUT_Q), (133, HW, HW, ROLLOUT_Q),
              (265, HW, HW, ROLLOUT_Q),
              (spec.EVAL_NUM_ENVS + 1, EVAL_HW, EVAL_HW, 9216),
              (5, 37, 53, 700), (5, 401, 300, 5000), (4, 3000, 1, 3000)]


def zbuf_scatter_edge_case(n: int, h: int, w: int, q: int) -> None:
    """The wrapper bit-equal to zbuf_scatter_min_ref on planted inputs at
    one edge case, with one launch a call (counted, and one device launch
    under the profiler)."""
    flat, zz = planted_zbuf_inputs(n, q, h, w, 50.0)
    label = f"zbuf_scatter_min [{n}x{q}] -> [{n}x{h}x{w}]"
    want = zbuf_scatter.zbuf_scatter_min_ref(flat, zz, h, w, 50.0)
    label += f" ({zbuf_geometry(n, q, h, w)[1]})"
    before = launches()["zbuf_scatter_min"]
    got = zbuf_scatter.zbuf_scatter_min(flat, zz, h, w, 50.0)
    if launches()["zbuf_scatter_min"] != before + 1:
        raise AssertionError(f"{label}: counted "
                             f"{launches()['zbuf_scatter_min'] - before} "
                             "launches")
    _equal(label, (got.view(torch.int32),), (want.view(torch.int32),))
    per_call, _, names = profile_calls(
        lambda: zbuf_scatter.zbuf_scatter_min(flat, zz, h, w, 50.0), calls=3)
    if per_call != 1 or not all("zbuf_scatter_min_kernel" in x for x in names):
        raise AssertionError(f"{label}: {per_call} device launches a call "
                             f"({sorted(names)})")


def _step_poses(scenes, cam: config.CameraConfig):
    """Every scene seen from a pose of the discrete action grid drawn from
    a seeded numpy generator: (poses, r_c2w, t_c2w, intrinsics)."""
    n = scenes.num_scenes
    dev = scenes.surf_pts.device
    rng = np.random.default_rng(0)
    acts = np.stack([rng.integers(0, k, n) for k in spec.NVEC], -1)
    poses = fp32.fma(torch.as_tensor(acts, dtype=torch.float32, device=dev),
                     torch.as_tensor(spec.ACTION_UNIT, device=dev),
                     torch.as_tensor(spec.CLIP_POSE_LOW, device=dev))
    r, t = camera.pose_to_c2w(poses, cam.z_offset)
    k = torch.as_tensor(camera.intrinsics(cam.height, cam.width,
                                          cam.horizontal_fov_deg), device=dev)
    return poses, r, t, k


def _step_inputs(scenes, cam: config.CameraConfig):
    """What a splat env step hands its three kernels (_step_poses)."""
    n = scenes.num_scenes
    _, r, t, k = _step_poses(scenes, cam)
    vic, uic, z, ok = splat.project_px(scenes.surf_pts, scenes.surf_mask, k,
                                       r, t, cam.height, cam.width)
    z = z.contiguous()
    veps = fp32.mean3_of_scaled(scenes.box_hi - scenes.box_lo, scenes.grid_res)
    zbuf, visible = fused_splat.zbuf_visible_ref(vic, uic, z, ok, veps,
                                                 cam.height, cam.width,
                                                 cam.depth_max)
    idx, in_bounds = voxel.points_to_voxel_idx(
        scenes.surf_pts, visible, scenes.range_gt, scenes.voxel_size)
    centers = scene_lib.voxel_centers(scenes.range_gt, scenes.voxel_size, G)
    cvi, cui, _, _ = carve.project_centers_px(centers, k, r, t, cam.height,
                                              cam.width)
    return ((vic, uic, z, ok, veps), (idx.contiguous(), in_bounds.contiguous()),
            (zbuf.reshape(n, cam.height, cam.width), cvi, cui))


def _dda_step_inputs(scenes, cam: config.CameraConfig):
    """What a DDA env step (renderer.mode=dda, carve_mode=ztest) hands the
    hit scatter and the foreground gather (_step_poses): the cells of all
    H*W back-projected pixels, and the ray march's hit mask as a {0,1}
    float image with the carve's G^3 voxel pixels."""
    n = scenes.num_scenes
    _, r, t, k = _step_poses(scenes, cam)
    rays = torch.as_tensor(camera.camera_rays(cam.height, cam.width,
                                              cam.horizontal_fov_deg),
                           device=r.device)
    depth, fg = render.render_depth(scenes.render_occ, scenes.box_lo,
                                    scenes.box_hi, rays, r, t, scenes.grid_res,
                                    3 * scenes.grid_res, cam.depth_max)
    pts, valid = backproject.backproject(depth, fg, rays, r, t)
    idx, in_bounds = voxel.points_to_voxel_idx(pts, valid, scenes.range_gt,
                                               scenes.voxel_size)
    centers = scene_lib.voxel_centers(scenes.range_gt, scenes.voxel_size, G)
    cvi, cui, _, _ = carve.project_centers_px(centers, k, r, t, cam.height,
                                              cam.width)
    return ((idx.contiguous(), in_bounds.contiguous()),
            (fg.float().reshape(n, cam.height, cam.width), cvi, cui))


def planted_gather_inputs(q: int):
    """The rollout's image shape [256, 128, 128] and q random in-range
    pixels, on an image with planted values: bf16 round-to-even ties
    (1 + 2^-8, 1 + 3 * 2^-8), -0.0, a negative, and a block of empty
    pixels at depth_max."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand(N_ENVS, HW, HW, device="cuda", generator=gen) * 30.0
    img[:, :8, :8] = 50.0                                    # empty pixels
    img[:, 8, :4] = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0, -3.7])
    vi, ui = (torch.randint(0, HW, (N_ENVS, q), device="cuda",
                            dtype=torch.int32, generator=gen) for _ in range(2))
    # every env reads an empty pixel and each planted value
    vi[:, :5] = torch.tensor([0, 8, 8, 8, 8], dtype=torch.int32)
    ui[:, :5] = torch.tensor([0, 0, 1, 2, 3], dtype=torch.int32)
    return img, vi, ui


def planted_gather_case(q: int) -> dict:
    return gather_case(f"gather_image [{N_ENVS}x{HW}x{HW}] x [{N_ENVS}x{q}] "
                       "(planted values)", *planted_gather_inputs(q))


# the gather's edge cases at both paths' image shapes: (envs, image side,
# queries an env, offset of the index arrays in int32s); a ragged q and an
# offset view take the scalar path, the rest the vector path
GATHER_EDGES = [(n, hw, q, offset)
                for n, hw in ((spec.EVAL_NUM_ENVS, EVAL_HW), (N_ENVS, HW))
                for q, offset in ((1, 0), (3, 0), (4, 0), (G ** 3 + 1, 0),
                                  (G ** 3, 1), (ROLLOUT_Q, 1), (ROLLOUT_Q, 0))]


def gather_edge_inputs(n: int, hw: int, q: int, offset: int):
    """Planted-style images [n, hw, hw] and random in-range indices, the
    index arrays `offset` int32s into their buffers (contiguous views that
    are not 16-byte aligned where offset % 4 != 0)."""
    gen = torch.Generator(device="cuda").manual_seed(n * q + hw + offset)
    img = torch.rand(n, hw, hw, device="cuda", generator=gen) * 30.0
    img[:, 0, :4] = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0, 50.0])

    def indices():
        buf = torch.randint(0, hw, (n * q + offset,), device="cuda",
                            dtype=torch.int32, generator=gen)
        return buf[offset:].view(n, q)

    vi, ui = indices(), indices()
    vi[:, : min(q, 4)] = 0
    ui[:, : min(q, 4)] = torch.arange(min(q, 4), dtype=torch.int32)
    return img, vi, ui


def gather_edge_case(n: int, hw: int, q: int, offset: int) -> str:
    """The wrapper bit-equal to gather_image_ref on one edge case, with
    one launch a call (counted, and one device launch under the
    profiler); returns the path the geometry took."""
    img, vi, ui = gather_edge_inputs(n, hw, q, offset)
    geo = gather.launch_geometry(n, q, vi.data_ptr(), ui.data_ptr())
    label = (f"gather_image [{n}x{hw}x{hw}] x [{n}x{q}], index offset "
             f"{offset} ({geo.path} path)")
    if geo.path != ("scalar" if q % gather.VECTOR or offset % 4 else "vector"):
        raise AssertionError(f"{label}: the wrong path")
    before = launches()["gather_image"]
    got = gather.gather_image(img, vi, ui)
    if launches()["gather_image"] != before + 1:
        raise AssertionError(f"{label}: counted "
                             f"{launches()['gather_image'] - before} launches")
    _equal(label, (got,), (gather.gather_image_ref(img, vi, ui),))
    per_call, _, names = profile_calls(lambda: gather.gather_image(img, vi, ui),
                                       calls=3)
    if per_call != 1 or not all("gather_image_kernel" in x for x in names):
        raise AssertionError(f"{label}: {per_call} device launches a call "
                             f"({sorted(names)})")
    return geo.path


def _ragged(inputs, q: int):
    """The first q points of [N, Q, ...] step inputs (a [N] slack kept)."""
    return tuple(x if x.dim() == 1 else x[:, :q].contiguous() for x in inputs)


def phase_kernels(eval_scenes, rollout_scenes,
                  dataset_scenes) -> tuple[dict, dict]:
    """Each kernel against its plain version on the inputs of a step of
    the eval, of the rollout, of the rollout at 400x400, of the DDA step
    and of the converted scenes (dataset_scenes: {label: (scenes, image
    side)}); returns
    {kernel: {path: timings}} and the floor of the cold times (a trivial
    launch's, after each flush).  The gather is also held bit-equal on an
    image with planted values."""
    floor = {"cold_floor_ms": cold_floor_ms(),
             "cold_floor_dirty_ms": cold_floor_ms("zero")}
    print(f"a trivial launch cold: {floor['cold_floor_ms']:.4f} ms after a "
          f"clean L2 flush, {floor['cold_floor_dirty_ms']:.4f} ms after a "
          "dirty one (median, CUDA events): the floor of every cold time")
    out = {name: {} for name in KERNELS}
    cam = config.CameraConfig(height=HW, width=HW)
    n = rollout_scenes.num_scenes
    scatter_in, fg_in = _dda_step_inputs(rollout_scenes, cam)
    out["scatter_cells_any"]["dda"] = scatter_case(
        f"dda: scatter_cells_any [{n}x{HW * HW}] -> [{n}x{G}^3]", *scatter_in)
    out["gather_image"]["dda_fg"] = gather_case(
        f"dda: gather_image of the fg mask [{n}x{HW}x{HW}] x [{n}x{G ** 3}]",
        *fg_in)
    for path, (scenes, hw) in dataset_scenes.items():
        cam = config.CameraConfig(height=hw, width=hw)
        n, q = scenes.surf_mask.shape
        splat_in, scatter_in, (zbuf, _, _) = _step_inputs(scenes, cam)
        for label, qq in ((path, q), (f"{path}_ragged", q - 3)):
            if qq != q and hw != HW:
                continue           # the ragged Q on the training set only
            sp = _ragged(splat_in, qq)
            sc = _ragged(scatter_in, qq)
            out["zbuf_visible"][label] = splat_case(
                f"{label}: zbuf_visible [{n}x{qq}] -> [{n}x{hw}x{hw}]", *sp,
                hw, hw, cam.depth_max)
            out["scatter_cells_any"][label] = scatter_case(
                f"{label}: scatter_cells_any [{n}x{qq}] -> [{n}x{G}^3]", *sc)
            # the visibility gather's shape: the points' own pixels
            out["gather_image"][label] = gather_case(
                f"{label}: gather_image [{n}x{hw}x{hw}] x [{n}x{qq}]", zbuf,
                sp[0], sp[1])
    # bench400: the flagship scenes at the eval's camera, the 400x400
    # training shape (the exact z-buffer does not run there)
    for path, scenes, hw in (("eval", eval_scenes, EVAL_HW),
                             ("rollout", rollout_scenes, HW),
                             ("bench400", rollout_scenes, EVAL_HW)):
        cam = config.CameraConfig(height=hw, width=hw)
        n, q = scenes.surf_mask.shape
        splat_in, scatter_in, gather_in = _step_inputs(scenes, cam)
        out["zbuf_visible"][path] = splat_case(
            f"{path}: zbuf_visible [{n}x{q}] -> [{n}x{hw}x{hw}]", *splat_in,
            hw, hw, cam.depth_max)
        out["scatter_cells_any"][path] = scatter_case(
            f"{path}: scatter_cells_any [{n}x{q}] -> [{n}x{G}^3]", *scatter_in)
        out["gather_image"][path] = gather_case(
            f"{path}: gather_image [{n}x{hw}x{hw}] x [{n}x{G ** 3}]", *gather_in)
        if path == "bench400":
            continue
        vic, uic, z, ok, _ = splat_in
        out["zbuf_scatter_min"][path] = zbuf_scatter_case(
            f"{path}: zbuf_scatter_min [{n}x{q}] -> [{n}x{hw}x{hw}]",
            *exact_zbuf_inputs(vic, uic, z, ok, hw, cam.depth_max), hw, hw,
            cam.depth_max)
    out["zbuf_scatter_min"]["tool"] = zbuf_scatter_case(
        "tools/bench_scatter.py's defaults: zbuf_scatter_min [256x11264] -> "
        "[256x128x128]", *tool_zbuf_inputs(), HW, HW, bench_scatter.DMAX)
    out["zbuf_scatter_min"]["planted"] = zbuf_scatter_case(
        f"zbuf_scatter_min [{N_ENVS}x{ROLLOUT_Q}] -> [{N_ENVS}x{HW}x{HW}] "
        "(planted: a pile-up, an empty env, negative depths, signed zeros, "
        "a pile-up across a band edge)",
        *planted_zbuf_inputs(N_ENVS, ROLLOUT_Q, HW, HW, 50.0), HW, HW, 50.0)
    for case in ZBUF_EDGES:
        zbuf_scatter_edge_case(*case)
    print(f"zbuf_scatter_min: bit-equal to the plain version with one device "
          f"launch a call at {len(ZBUF_EDGES)} edge cases (Q 1, 0, "
          f"{ROLLOUT_Q - 3}, 9215 in one env; 1, 133, 265 envs at {HW}x{HW}, "
          f"{spec.EVAL_NUM_ENVS + 1} at {EVAL_HW}x{EVAL_HW}; 37x53, 401x300, "
          "3000x1; pile-ups on either side of a band edge)")
    for layer, (x, dy) in enumerate(wgrad_inputs(WGRAD_MINIBATCH, 0), 1):
        out["conv3d_wgrad"][f"update_conv{layer}"] = wgrad_case(
            f"update: conv3d_wgrad, layer {layer}: x {list(x.shape)}, dy "
            f"{list(dy.shape)}", x, dy)
    # the ray march and the Bresenham carve at dda400.eval's step (50
    # envs, 400x400, R=64) and at the DDA rollout's (256 envs, 128x128)
    for path, scenes, hw in (("eval", eval_scenes, EVAL_HW),
                             ("rollout", rollout_scenes, HW)):
        out["raymarch"][path] = march_case(
            f"{path}: raymarch [{scenes.num_scenes}x{hw * hw}] rays, "
            f"R={scenes.grid_res}", scenes,
            config.CameraConfig(height=hw, width=hw))
        out["bresenham"][path] = carve_case(
            f"{path}: bresenham [{scenes.num_scenes}x{G ** 3}] target slots "
            f"of the hits at {hw}x{hw}", scenes,
            config.CameraConfig(height=hw, width=hw))
    # the report's three nearest-neighbour passes over the eval's scenes
    out["nn_min"]["eval"] = nn_case(
        f"eval: nn_min, the report's 3 passes over {eval_scenes.num_scenes} "
        f"envs of up to {eval_scenes.gt_points.shape[1]} GT points",
        eval_scenes)
    planted_gather_case(G ** 3)
    paths = [gather_edge_case(*case) for case in GATHER_EDGES]
    print(f"gather_image: bit-equal to the plain version with one device "
          f"launch a call at {len(GATHER_EDGES)} edge cases (q 1, 3, 4, "
          f"{G ** 3 + 1}, offset views; {paths.count('scalar')} on the scalar "
          "path) at both image sizes")
    return out, floor


def phase_golden() -> None:
    """tools/make_goldens.py's run on the card, held to the golden."""
    cfg = config.EnvConfig(
        num_envs=4, camera=config.CameraConfig(height=24, width=24),
        renderer=config.RendererConfig(resolution=24),
        scene=config.SceneConfig(num_scenes=2, seed=7), max_episode_length=6)
    env = ReconEnv(cfg, make_scenes(cfg.scene, cfg.renderer.resolution))
    want = np.load(GOLDEN)
    reset_launches()
    state, out = env.reset(4)
    obs, rew, cov = [out.obs], [], []
    for a in want["actions"]:
        state, out = env.step(state, torch.as_tensor(a, device="cuda")[None]
                              .repeat(4, 1))
        obs.append(out.obs)
        rew.append(out.reward)
        cov.append(out.coverage)
    torch.cuda.synchronize()
    expect = splat_expect(1 + len(want["actions"]))
    if launches() != expect:
        raise AssertionError(f"golden run launched {launches()}, expected {expect}")
    got = {"obs": obs, "rewards": rew, "coverage": cov}
    for name, tol in (("coverage", 1e-6), ("rewards", 1e-4), ("obs", 1e-4)):
        np.testing.assert_allclose(torch.stack(got[name]).cpu().numpy(),
                                   want[name], rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(state.prob_grid.cpu().numpy(), want["prob_grid"],
                               rtol=0, atol=1e-6, err_msg="prob_grid")
    print("golden: matches tests/goldens/mapping_golden.npz on the card")


def profile(label: str, fn, unprofiled_s: float | None = None) -> dict:
    """Runs fn once under torch.profiler and prints the device's busy
    share of the wall time and the kernels that took the most of it.  The
    profiler slows the host; given the wall time of fn without it, the
    busy share is also printed against that.  Returns the device time in
    microseconds of each of the port's kernels, by kernel function
    ("kernels"), the number of device activities ("activities") and the
    busy and wall milliseconds."""
    def run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    # fn is run again only where its first profile lost the device's records
    wall_us, events = _profiled(label, run)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events]
    busy, end = 0.0, float("-inf")
    by_name: dict[str, float] = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    unprofiled = ("" if unprofiled_s is None else
                  f"; {100 * busy / (unprofiled_s * 1e6):.1f}% of the "
                  f"{unprofiled_s * 1e3:.3f} ms it takes unprofiled")
    print(f"{label}: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"wall ({100 * busy / wall_us:.1f}%{unprofiled}), {len(spans)} device "
          "activities; top by device time:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  {name[:90]}")
    # the port's own kernels, demangled as "(anonymous namespace)::fn(args)"
    # or, for a template, "void (anonymous namespace)::fn<...>(args)";
    # some of PyTorch's kernels sit in anonymous namespaces too
    ports = set(PORT_KERNEL_FUNCTIONS.values())
    ours: dict[str, list[float]] = {}
    for s, e, name in spans:
        fn = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
        fn = fn.split("(")[0].split("<")[0]
        if fn in ports:
            ours.setdefault(fn, []).append(e - s)
    for name, times in ours.items():
        print(f"  port kernel {name}: {len(times)} launches, "
              f"{sum(times) / 1e3:.3f} ms device time, "
              f"{sum(times) / len(times) / 1e3:.4f} ms each")
    return {"kernels": {name: sum(times) for name, times in ours.items()},
            "activities": len(spans), "busy_ms": busy / 1e3,
            "wall_ms": wall_us / 1e3}


def _device_ms_per_call(device_us: dict, calls: int) -> dict:
    """The profiled device time of each wrapper over `calls` calls, per
    call; a wrapper whose kernel left no record is left out."""
    return {name: device_us[fn] / calls / 1e3
            for name, fn in PORT_KERNEL_FUNCTIONS.items() if fn in device_us}


def flagship_config() -> config.EnvConfig:
    return config.EnvConfig(
        num_envs=N_ENVS, camera=config.CameraConfig(height=HW, width=HW),
        renderer=config.RendererConfig(resolution=RES),
        scene=config.SceneConfig(num_scenes=N_ENVS, seed=0))


def make_path_scenes(cfg: config.EnvConfig, label: str):
    t0 = time.perf_counter()
    scenes = make_scenes(cfg.scene, RES)
    print(f"scenes: {scenes.num_scenes} {label} procedural (seed "
          f"{cfg.scene.seed}) at R={RES}, Q={scenes.surf_pts.shape[1]} in "
          f"{time.perf_counter() - t0:.1f} s")
    return scenes


def phase_rollout(card: str, scenes) -> tuple[dict, dict]:
    if scenes.surf_pts.shape[1] != ROLLOUT_Q:
        raise AssertionError(f"the flagship scenes' Q is "
                             f"{scenes.surf_pts.shape[1]}, not {ROLLOUT_Q}")
    env = ReconEnv(flagship_config(), scenes)
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    return timed_rollout(card, "rollout", env, policy,
                         splat_expect(1 + N_STEPS))


def timed_rollout(card: str, label: str, env, policy,
                  expect: dict) -> tuple[dict, dict]:
    """Reset + collect(n_steps=N_STEPS) of N_ENVS envs after a warm-up,
    timed; each kernel launched exactly `expect` times; the outputs finite
    and in range.  Prints env-steps/s and peak memory, then profiles 8
    more steps (device-busy share, top kernels).  Returns the launches and
    each kernel's device ms a step."""
    cfg = env.cfg
    # warm-up (allocator, cuDNN algorithm choice), outside the counted run
    state, out = env.reset(N_ENVS)
    rollout.collect(env, policy, state, out.obs,
                    torch.Generator(device="cuda").manual_seed(3), 2, GAMMA)
    torch.cuda.synchronize()

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, out = env.reset(N_ENVS)
    t1 = time.perf_counter()
    state, obs, batch, stats = rollout.collect(
        env, policy, state, out.obs, torch.Generator(device="cuda").manual_seed(2),
        N_STEPS, GAMMA)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = launches()

    if counts != expect:
        raise AssertionError(f"{label} launched {counts}, expected {expect}")
    for name, x in (*batch._asdict().items(), *stats._asdict().items()):
        if x.is_floating_point() and not torch.isfinite(x).all():
            raise AssertionError(f"{label}: non-finite {name}")
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

    n_env_steps = N_ENVS * N_STEPS
    print(f"{label}: reset {t1 - t0:.3f} s, collect {N_STEPS} steps x {N_ENVS} "
          f"envs in {t2 - t1:.3f} s = {n_env_steps / (t2 - t1):.1f} env-steps/s "
          f"[{card}]; mean coverage at the last step "
          f"{float(stats.coverage[-1].mean()):.4f}, "
          f"{int(stats.num_dones.sum())} episodes ended, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    device_us = profile(f"{label}, 8 collect steps", lambda: rollout.collect(
        env, policy, state, obs, torch.Generator(device="cuda").manual_seed(4),
        8, GAMMA), (t2 - t1) * 8 / N_STEPS)
    return counts, _device_ms_per_call(device_us["kernels"], 8)


def eval_config(zbuf_impl: str) -> config.EnvConfig:
    """The held-out eval of the flagship recipe under the reference's
    400x400 camera (train_eval_gennbv.py, runner.eval_camera)."""
    train = config.EnvConfig(
        camera=config.CameraConfig(height=EVAL_HW, width=EVAL_HW),
        renderer=config.RendererConfig(resolution=RES, zbuf_impl=zbuf_impl,
                                       scatter_impl="pallas"),
        scene=config.SceneConfig(num_scenes=spec.EVAL_NUM_ENVS, seed=EVAL_SEED))
    return config.eval_env_config(train)


def run_eval(cfg: config.EnvConfig, scenes, policy):
    """Builds the env (and its init-view cache) and evaluates; returns
    (result, kernel launches, seconds of the evaluate call)."""
    reset_launches()
    env = ReconEnv(cfg, scenes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluation.evaluate(env, policy, compute_accuracy=False)
    secs = time.perf_counter() - t0            # evaluate ends on the host
    return res, launches(), secs


def check_eval(res: evaluation.EvalResult, max_len: int) -> None:
    for name, x in res._asdict().items():
        if name.startswith("accuracy") or name in ("mean_accuracy_cm",
                                                    "gt_unseen_frac"):
            continue
        if not np.isfinite(x).all():
            raise AssertionError(f"eval: non-finite {name}")
    cov = res.per_env_coverage
    assert ((cov >= 0) & (cov <= 1)).all(), "coverage in [0, 1]"
    assert 0 < res.mean_init_coverage <= res.mean_final_coverage <= 1
    assert 1 <= res.mean_ep_length <= max_len
    # the eval reward is the coverage gain; the init step's is not counted
    assert res.mean_reward <= res.mean_final_coverage + 1e-4


def phase_eval(card: str, scenes) -> tuple[dict, dict]:
    cfg = eval_config("pallas")
    max_len = cfg.max_episode_length
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    run_eval(cfg, scenes, policy)                  # warm-up, not counted
    res, counts, secs = run_eval(cfg, scenes, policy)
    # init-view cache, reset, and one launch per step
    expect = splat_expect(2 + max_len)
    if counts != expect:
        raise AssertionError(f"eval launched {counts}, expected {expect}")
    check_eval(res, max_len)
    steps = 1 + max_len
    n_env_steps = cfg.num_envs * steps
    print(f"eval: {cfg.num_envs} envs x (reset + {max_len} steps) at "
          f"{EVAL_HW}x{EVAL_HW}, R={RES}, in {secs:.3f} s = "
          f"{n_env_steps / secs:.1f} env-steps/s [{card}]; mean reward "
          f"{res.mean_reward:.4f}, AUC {res.mean_auc:.4f}, final coverage "
          f"{res.mean_final_coverage:.4f}, init coverage "
          f"{res.mean_init_coverage:.4f}, curve AUC {res.mean_curve_auc:.4f}, "
          f"episode length {res.mean_ep_length:.1f}")

    # without the init-view cache: the same kernels, once per step
    mxu, mxu_counts, mxu_secs = run_eval(eval_config("mxu"), scenes, policy)
    expect = splat_expect(steps)
    if mxu_counts != expect:
        raise AssertionError(f"mxu eval launched {mxu_counts}, expected {expect}")
    for name in ("per_env_coverage", "per_env_auc", "mean_reward",
                 "std_reward", "mean_ep_length", "mean_init_coverage"):
        if not np.array_equal(getattr(res, name), getattr(mxu, name)):
            raise AssertionError(f"eval: zbuf_impl=pallas and mxu differ in "
                                 f"{name}")
    print(f"eval: zbuf_impl=mxu (no init-view cache) on the same scenes and "
          f"weights gives identical per-env coverage, AUC and rewards "
          f"({n_env_steps / mxu_secs:.1f} env-steps/s [{card}])")

    env = ReconEnv(cfg, scenes)
    device_us = profile(
        "eval, one evaluate call (pallas)",
        lambda: evaluation.evaluate(env, policy, compute_accuracy=False), secs)
    return counts, _device_ms_per_call(device_us["kernels"], steps)


def train_config() -> config.Config:
    """The flagship recipe, reports/r5_refbudget128/config.json, with an
    eval and a checkpoint every TRAIN_ITERS iterations."""
    with open(FLAGSHIP) as f:
        raw = json.load(f)

    def leaves(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}={v}"

    return config.apply_overrides(config.Config(), (
        *leaves(raw, ""), f"runner.eval_freq={TRAIN_ITERS}",
        f"runner.save_freq={TRAIN_ITERS}"))


def _profile_update(card: str, runner: Runner) -> dict:
    """The update alone over 32 minibatches of 128 rows (a 16-step rollout
    of the 256 envs, one epoch), each config on a Learner of its own whose
    first call captures its step: the flagship's KL-gated step and the
    step without a target KL, timed to the device's end, then the gated
    one under the profiler."""
    gated = dataclasses.replace(runner.cfg.ppo, n_steps=16, n_epochs=1)
    _, _, batch, _ = rollout.collect(
        runner.env, runner.policy, runner._final_env_state, runner._final_obs,
        runner.generator, gated.n_steps, gated.gamma, runner.obs_dtype)
    adv, ret = gae.compute_gae(batch.rewards, batch.values, batch.dones.float(),
                               batch.last_values, gated.gamma, gated.gae_lambda)
    m = N_ENVS * gated.n_steps
    args = [x.reshape((m,) + x.shape[2:]) for x in (
        batch.obs, batch.actions, batch.log_probs, batch.values, adv, ret)]
    runs = {}
    for label, cfg in (("KL-gated", gated),
                       ("no target KL", dataclasses.replace(gated,
                                                            target_kl=None))):
        learner = ppo.Learner(runner.policy, runner.opt, cfg)

        def run(cfg=cfg, learner=learner):
            return ppo.update(runner.policy, runner.opt, cfg,
                              runner.opt_state, *args, runner.generator,
                              num_envs=N_ENVS, learner=learner)

        run()                                       # the capture
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, upd = run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        n_mb = m // cfg.batch_size
        assert 1 <= float(upd.n_minibatches_done) <= n_mb
        runs[label] = (run, min(secs), n_mb)
        print(f"update ({label} step, {n_mb} replays of its graph): "
              + ", ".join(f"{s * 1e3 / n_mb:.3f}" for s in secs)
              + f" ms a minibatch to the device's end [{card}]")
    run, secs, n_mb = runs["KL-gated"]
    res = profile(f"update, {n_mb} minibatches of {gated.batch_size} rows",
                  run, secs)
    print(f"update: {res['activities'] / n_mb:.1f} device activities a "
          f"minibatch [{card}]")
    return res


def _pipeline_window(card: str, runner: Runner, iters: int = 6,
                     replays: int = 64) -> None:
    """Where an iteration of the pipelined loop spends its time, on a
    trained runner with its eval and checkpoints off.  First `iters`
    iterations unprofiled, timing on the host each dispatch, its update's
    enqueue (``Learner.run``) and each replay of the captured step, beside
    the update's device span (CUDA events).  Then two more, profiled from
    the second one's dispatch to the end of its update's `replays`-th
    replay, without a fence between the two: the device records before the
    first replay are the rollout's (with GAE and the snapshot), and give
    its device-busy share in the loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    steps = runner.cfg.ppo.n_steps * N_ENVS
    learner, saved = runner.learner, (runner.cfg, runner.ckpt, runner.logger)
    runner.cfg = config.apply_overrides(runner.cfg, (
        "runner.eval_freq=0", "runner.save_freq=0"))
    runner.ckpt = runner.logger = None
    graph, run = learner.graph, learner.run
    dispatch, process = runner._dispatch, runner._process_iter
    seen = {"dispatch": [], "run": [], "stamps": [], "metrics": []}
    window = {"on": False, "dispatches": 0, "prof": None}

    def pads():
        for _ in range(PROFILE_PADS):
            torch.cuda._sleep(PAD_CYCLES)

    class Timed:
        def replay(self):
            graph.replay()
            seen["stamps"][-1].append(time.perf_counter())
            if window["on"] and len(seen["stamps"][-1]) == replays + 1:
                pads()
                torch.cuda.synchronize()
                window["prof"].stop()
                window["on"] = False

    def timed_run(*args):
        seen["stamps"].append([time.perf_counter()])
        run(*args)
        seen["run"].append(time.perf_counter() - seen["stamps"][-1][0])

    def timed_dispatch(*args):
        window["dispatches"] += 1
        if window["prof"] is not None and window["dispatches"] == 2:
            window["prof"].start()
            window["on"] = True
            pads()
        t0 = time.perf_counter()
        out = dispatch(*args)
        seen["dispatch"].append(time.perf_counter() - t0)
        return out

    def kept_process(entry):
        metrics = process(entry)
        seen["metrics"].append(metrics)
        return metrics

    learner.graph, learner.run = Timed(), timed_run
    runner._dispatch, runner._process_iter = timed_dispatch, kept_process
    try:
        runner.train(runner.iteration + iters, log=False)
        torch.cuda.synchronize()
        timed = {k: list(v) for k, v in seen.items()}
        for take in range(1, PROFILE_TAKES + 1):
            window["prof"] = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["dispatches"] = 0
            runner.train(runner.iteration + 2, log=False)
            torch.cuda.synchronize()
            events = window["prof"].profiler.kineto_results.events()
            launches = {e.correlation_id() for e in events
                        if e.device_type() == DeviceType.CPU
                        and e.name() == "cudaGraphLaunch"}
            spans = sorted(((e.start_ns(), e.end_ns(), e.name(),
                             e.correlation_id() in launches) for e in events
                            if e.device_type() == DeviceType.CUDA
                            and not e.is_user_annotation()))
            is_pad = ["spin_kernel" in name for _, _, name, _ in spans]
            lead = max((i + 1 for i, p in enumerate(is_pad[:len(spans) // 2])
                        if p), default=0)
            tail = next((i for i, p in enumerate(is_pad) if p and i >= lead),
                        len(spans))
            inside = spans[lead:tail]
            first = next((i for i, s in enumerate(inside) if s[3]), None)
            if lead and tail < len(spans) and first:
                break
            print(f"train: window profile {take} of {PROFILE_TAKES} lost the "
                  f"device's records ({len(spans)} device activities, "
                  f"{sum(is_pad)} pads, first graph kernel at {first})")
        else:
            raise AssertionError("train: the profiler lost the window's device "
                                 f"records {PROFILE_TAKES} times")
    finally:
        learner.graph, learner.run = graph, run
        del runner._dispatch, runner._process_iter
        runner.cfg, runner.ckpt, runner.logger = saved

    def busy(part):
        total, end = 0, float("-inf")
        for s, e, _, _ in part:
            total += max(0, e - max(s, end))
            end = max(end, e)
        return total / 1e9, (max(e for _, e, _, _ in part) - part[0][0]) / 1e9

    rollout_busy, rollout_span = busy(inside[:first])
    update_busy, update_span = busy(inside[first:])
    for d, r, stamps, rec in zip(timed["dispatch"], timed["run"],
                                 timed["stamps"], timed["metrics"]):
        gaps = np.diff(stamps)
        per_mb = rec["time/update"] / len(gaps)
        ahead = next((i for i, g in enumerate(gaps) if g > per_mb / 2),
                     len(gaps))
        print(f"train: loop iteration {rec['global_step'] // steps}: "
              f"fetched {rec['time/iter_seconds']:.3f} s after the last fetch; "
              f"the host enqueued it in {d:.3f} s: the rollout, GAE and "
              f"snapshot {d - r:.3f} s, the update's {len(gaps)} replays "
              f"{r:.3f} s, against the device spans of the rollout "
              f"{rec['time/rollout']:.3f} s and the update "
              f"{rec['time/update']:.3f} s (CUDA events), "
              f"{rec['train/n_minibatches']:g} minibatches applied; {ahead} "
              f"replays "
              f"enqueued before the host's first wait "
              f"({1e3 * sum(gaps[:ahead]):.3f} ms), then one every "
              f"{1e3 * float(np.median(gaps[ahead:])):.3f} ms (median), "
              f"against {1e3 * per_mb:.3f} ms a minibatch on the device "
              f"[{card}]")
    print(f"train: the profiled window (the second of two unfenced "
          f"iterations): the rollout, GAE and snapshot busy the device "
          f"{rollout_busy:.3f} s of their {rollout_span:.3f} s device span "
          f"({100 * rollout_busy / rollout_span:.1f}%, {first} device "
          f"activities); the update's first {replays} replays "
          f"{update_busy * 1e3:.3f} ms of {update_span * 1e3:.3f} ms "
          f"({100 * update_busy / update_span:.1f}%) [{card}]")
    # fetched while later iterations were in flight: neither the first
    # (its own span) nor those drained at the end
    steady = timed["metrics"][1:iters - runner.cfg.runner.pipeline_depth]
    shares = [(rollout_busy + rec["time/update"] * update_busy / update_span)
              / rec["time/iter_seconds"] for rec in steady]
    print(f"train: the device's busy share of the steady loop iterations "
          f"{', '.join(str(rec['global_step'] // steps) for rec in steady)} "
          f"(the window's rollout busy seconds, plus each update's span at "
          f"the window's busy share, over the fetch spacing): "
          f"{', '.join(f'{100 * x:.1f}%' for x in shares)} [{card}]")


@contextlib.contextmanager
def _host_waits(runner: Runner):
    """Counts the host's waits for the device in a runner's train():
    every dispatch after the first runs under torch.profiler, which
    records each CUDA runtime call, and the HOST_WAITS calls inside its
    ``runner/dispatch`` range are counted; each processed iteration's
    ``torch.cuda.Event.synchronize`` calls (its fetch) are counted.
    Yields {"dispatch": [waits of each profiled dispatch], "calls":
    [runtime calls of each], "fetch": [event waits of each processed
    iteration]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    seen = {"dispatch": [], "calls": [], "fetch": []}
    dispatch, process = runner._dispatch, runner._process_iter
    start = runner.iteration
    event_sync = torch.cuda.Event.synchronize
    syncs = [0]

    def counted_sync(event):
        syncs[0] += 1
        return event_sync(event)

    def profiled_dispatch(*args):
        if runner.iteration == start:
            return dispatch(*args)
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            out = dispatch(*args)
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU]
        span = next(e for e in events if e.name() == "runner/dispatch")
        calls = sorted((e.start_ns(), e.name()) for e in events
                       if e.name().startswith("cuda")
                       and span.start_ns() <= e.start_ns() <= span.end_ns())
        # the dispatch records the timer's first event before its first
        # launch and ends with the fetch's event record: a profile that
        # lost runtime records at an end misses one of the two
        names = [name for _, name in calls]
        first = next((i for i, n in enumerate(names)
                      if n.startswith("cudaLaunch")), len(names))
        if not (any(n.startswith("cudaEventRecord") for n in names[:first])
                and names and names[-1].startswith("cudaEventRecord")):
            raise AssertionError(
                f"train: the profile of dispatch {runner.iteration + 1} lost "
                f"runtime records at its ends ({names[:first + 1]}, "
                f"{names[-1:]})")
        seen["dispatch"].append(sum(name in HOST_WAITS for _, name in calls))
        seen["calls"].append(len(calls))
        return out

    def counted_process(entry):
        before = syncs[0]
        metrics = process(entry)
        seen["fetch"].append(syncs[0] - before)
        return metrics

    runner._dispatch, runner._process_iter = profiled_dispatch, counted_process
    torch.cuda.Event.synchronize = counted_sync
    try:
        yield seen
    finally:
        torch.cuda.Event.synchronize = event_sync
        del runner._dispatch, runner._process_iter


def _same_checkpoints(label: str, dir_a: str, dir_b: str) -> int:
    """Raises unless two models directories hold the same checkpoint files
    with the same tensors, counts and steps; returns the file count."""
    names = sorted(n for n in os.listdir(dir_a) if n.startswith("rl_model_"))
    if names != sorted(n for n in os.listdir(dir_b)
                       if n.startswith("rl_model_")):
        raise AssertionError(f"{label}: checkpoint files differ")

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

    for name in names:
        a, b = (torch.load(os.path.join(d, name), weights_only=True)
                for d in (dir_a, dir_b))
        if not same(a, b):
            raise AssertionError(f"{label}: checkpoint {name} differs")
    return len(names)


def reproduce(card: str, cfg: config.Config, scenes, eval_scenes,
              first: dict, first_dir: str, first_secs: float) -> None:
    """Two more Runners from the same seed train the same iterations on
    the same scenes: one at the same pipeline depth, with each dispatch
    after the first profiled for the host's waits, and one at
    runner.pipeline_depth=1.  Raises unless each one's parameters,
    BatchNorm statistics, Adam state, logged metrics (but time/*) and
    checkpoint files equal the first run's bit for bit, a profiled
    dispatch made a host wait, or a processed iteration waited for the
    device other than once (its fetch)."""
    depth = cfg.runner.pipeline_depth
    twins = {depth: cfg, 1: config.apply_overrides(
        cfg, ("runner.pipeline_depth=1",))}
    runs = {depth: (first["logged"], first_secs)}
    for d, twin_cfg in twins.items():
        log_dir = tempfile.mkdtemp(prefix="chip_smoke_repro_")
        try:
            twin = Runner(twin_cfg, scenes=scenes, eval_scenes=eval_scenes,
                          log_dir=log_dir)
            waits = contextlib.nullcontext()
            if d == depth:
                waits = _host_waits(twin)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with waits as seen:
                twin.train(TRAIN_ITERS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            second = snapshot(twin, read_logged(log_dir))
            files = _same_checkpoints(f"train: depth {d}",
                                      os.path.join(first_dir, "models"),
                                      os.path.join(log_dir, "models"))
            twin.close()
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
        diff = first_difference(first, second)
        if diff:
            raise AssertionError(f"train: a Runner from seed {cfg.runner.seed}"
                                 f" at pipeline depth {d} differs first in "
                                 f"{diff}")
        if d == depth:
            if any(seen["dispatch"]) or seen["fetch"] != [1] * TRAIN_ITERS:
                raise AssertionError(
                    f"train: host waits in the dispatches after the first "
                    f"{seen['dispatch']}, event waits of each processed "
                    f"iteration {seen['fetch']} (expected 0s and 1s)")
            print(f"train: dispatches {first['logged'][0]['step'] + 1}-"
                  f"{TRAIN_ITERS} made {seen['dispatch']} host waits among "
                  f"{seen['calls']} CUDA runtime calls (torch.profiler); each "
                  f"processed iteration waited once, for its fetch "
                  f"{seen['fetch']} [{card}]")
        else:
            runs[d] = (second["logged"], secs)
        print(f"train: a Runner from seed {cfg.runner.seed} at pipeline depth "
              f"{d} ends {TRAIN_ITERS} iterations with the same parameters, "
              f"BatchNorm stats, Adam state, logged metrics (but time/*) and "
              f"{files} checkpoint files, bit for bit [{card}]")
    def line(values, fmt=".3f"):
        return ", ".join(f"{v:{fmt}}" for v in values)

    for d, (logged, secs) in sorted(runs.items()):
        spans = [rec["time/rollout"] + rec["time/gae"] + rec["time/update"]
                 for rec in logged]
        rates = [rec["train/n_minibatches"] / rec["time/update"]
                 for rec in logged]
        print(f"train: pipeline depth {d}: {TRAIN_ITERS} iterations with the "
              f"eval and checkpoint in {secs:.3f} s; time/iter_seconds (the "
              f"spacing of fetches) "
              f"{line(rec['time/iter_seconds'] for rec in logged)} s; device "
              f"spans of rollout + gae + update (CUDA events) {line(spans)} "
              f"s; the update {line(rates, '.1f')} minibatches/s [{card}]")


def phase_train(card: str, scenes, eval_scenes, log_dir: str) -> dict:
    """Runner.train at the flagship recipe's full size, into the run
    directory log_dir; returns each kernel's launches in that run."""
    cfg = train_config()
    assert (cfg.env.num_envs, cfg.env.camera.height, cfg.env.renderer.resolution,
            cfg.ppo.lr_schedule, cfg.runner.eval_camera) == (
        N_ENVS, HW, RES, "linear", EVAL_HW)
    runner = Runner(cfg, scenes=scenes, eval_scenes=eval_scenes, log_dir=log_dir)
    try:
        before = {k: v.clone() for k, v in runner.variables().items()}
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = runner.train(TRAIN_ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launches()
        peak = torch.cuda.max_memory_allocated()

        # setup reset, 128 steps an iteration, one eval (reset + 30 steps;
        # zbuf_impl=mxu builds no init-view cache)
        n_eval = 1 + runner.eval_env.cfg.max_episode_length
        expect = trained(splat_expect(1 + TRAIN_ITERS * cfg.ppo.n_steps
                                      + n_eval))
        if counts != expect:
            raise AssertionError(f"train launched {counts}, expected {expect}")
        logged = read_logged(log_dir)
        assert [rec["step"] for rec in logged] == list(range(1, TRAIN_ITERS + 1))
        total = cfg.ppo.n_epochs * cfg.ppo.total_iters * (
            cfg.ppo.n_steps * N_ENVS // cfg.ppo.batch_size)
        for rec in logged:
            for k in _METRIC_KEYS:
                if not math.isfinite(rec[k]):
                    raise AssertionError(f"train: non-finite {k} at iteration "
                                         f"{rec['step']}")
            if not 1 <= rec["train/n_minibatches"] <= total // cfg.ppo.total_iters:
                raise AssertionError(f"train: {rec['train/n_minibatches']} "
                                     "minibatches")
        count = int(runner.opt_state.count)
        assert count == sum(rec["train/n_minibatches"] for rec in logged)
        lr = metrics["train/learning_rate"]
        if not (lr == runner.opt.lr(count) and
                math.isclose(lr, cfg.ppo.learning_rate * (1 - count / total),
                             rel_tol=1e-6)):
            raise AssertionError(f"train: learning rate {lr} at count {count}")
        # every parameter and running stat, but the BN counters (always 0)
        # and the conv biases ahead of a BN, whose gradient is 0 in exact
        # arithmetic (Adam moves them by rounding noise, or not at all)
        after = runner.variables()
        for k, v in after.items():
            if torch.equal(before[k], v) and not k.endswith((
                    "num_batches_tracked", "grid_conv1.bias", "grid_conv2.bias")):
                raise AssertionError(f"train: {k} did not change")
        assert math.isfinite(metrics["eval/final_coverage"])

        for rec in logged:
            mb = rec["train/n_minibatches"]
            print(f"train: iteration {rec['step']}"
                  f"{' (warm-up)' if rec['step'] == 1 else ''}: fetched "
                  f"{rec['time/iter_seconds']:.3f} s after the last fetch "
                  f"({rec['time/fps']:.1f} env-steps/s by that spacing); on "
                  f"the device rollout {rec['time/rollout']:.3f} + gae "
                  f"{rec['time/gae']:.4f} + update {rec['time/update']:.3f} s "
                  f"(CUDA events); update {mb:g} "
                  f"minibatches, {mb / rec['time/update']:.1f}/s; approx_kl "
                  f"{rec['train/approx_kl']:.5f}, episode reward "
                  f"{rec['rollout/episode_reward']:.3f} [{card}]")
        print(f"train: {TRAIN_ITERS} iterations + eval + checkpoints in "
              f"{secs:.3f} s, eval {metrics['time/eval_seconds']:.3f} s "
              f"(final coverage {metrics['eval/final_coverage']:.4f}); Adam "
              f"count {count}, learning rate {lr:.6g}; peak memory "
              f"{peak / 2 ** 30:.2f} GiB [{card}]")

        # a fresh Runner restored from the checkpoint written at the end
        models = os.path.join(log_dir, "models")
        fresh = Runner(cfg, scenes=scenes, log_dir=log_dir)
        step = fresh.restore(models)
        if step != runner.global_step or fresh.global_step != step:
            raise AssertionError(f"restored step {step}, ran {runner.global_step}")
        restored = fresh.variables()
        for k, v in after.items():
            if not torch.equal(restored[k], v):
                raise AssertionError(f"restored {k} differs")
        for moment in ("mu", "nu"):
            for k, v in getattr(runner.opt_state, moment).items():
                if not torch.equal(getattr(fresh.opt_state, moment)[k], v):
                    raise AssertionError(f"restored Adam {moment} {k} differs")
        assert fresh.opt_state.count == count
        print(f"train: a fresh Runner restored from rl_model_{step}_steps holds "
              "the same parameters, BatchNorm stats, Adam state and step")
        del fresh
        reproduce(card, cfg, scenes, eval_scenes, snapshot(runner, logged),
                  log_dir, secs)

        _pipeline_window(card, runner)
        _profile_update(card, runner)
    finally:
        runner.close()
    return counts


def train400(card: str, scenes, log_dir: str) -> dict:
    """The flagship recipe at the 400x400 camera on a Runner of its own,
    without eval or checkpoints: one iteration with each kernel's launches
    held exactly, then one more under a raw profile (_profiled) whose
    device launches of each kernel must equal the wrappers' counts over
    the same window, and the weight gradient's also WGRAD_CALLS_PER_STEP
    a replay of the update's graph, which launches it without a call.
    Returns the first iteration's launches."""
    cfg = config.apply_overrides(train_config(), (
        f"env.camera.height={EVAL_HW}", f"env.camera.width={EVAL_HW}",
        "ppo.lr_schedule=constant", "runner.eval_freq=0",
        "runner.eval_camera=0", "runner.save_freq=0"))
    steps = 1 + cfg.ppo.n_steps          # the set-up's reset, a rollout
    runner = Runner(cfg, scenes=scenes, log_dir=log_dir)
    try:
        reset_launches()
        t0 = time.perf_counter()
        runner.train(1, log=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launches()
        if counts != trained(splat_expect(steps)):
            raise AssertionError(f"train 400x400 launched {counts}, expected "
                                 f"{trained(splat_expect(steps))}")
        replays = [0]

        def take():
            reset_launches()
            before = profiling.counters("update/").get("update/replays", 0)
            runner.train(runner.iteration + 1, log=False)
            replays[0] = profiling.counters("update/")["update/replays"] - before
            return launches()

        window, spans = _profiled("train 400x400: an iteration", take, raw=True)
        seen = {name: sum(PORT_KERNEL_FUNCTIONS[name] in s.name
                          for s in spans) for name in KERNELS}
        want = {**window, "conv3d_wgrad": window["conv3d_wgrad"]
                + WGRAD_CALLS_PER_STEP * replays[0]}
        n_mb = cfg.ppo.n_epochs * cfg.ppo.n_steps * N_ENVS // cfg.ppo.batch_size
        if window != splat_expect(steps) or replays[0] != n_mb or seen != want:
            raise AssertionError(
                f"train 400x400: the profiled iteration launched {seen} on the "
                f"device (profiler); the wrappers counted {window} and "
                f"{replays[0]} replays, expected {splat_expect(steps)} and "
                f"{n_mb}")
        print(f"train 400x400: the first iteration (with the capture) "
              f"{secs:.3f} s; the second's kernel launches {seen} equal the "
              f"profiler's, among {len(spans)} device activities [{card}]")
    finally:
        runner.close()
    return counts


def _kdtree_accuracy(deduped, gt_pts, gt_mask) -> dict:
    """The accuracy metrics from float64 nearest neighbours of
    scipy.spatial.cKDTree, an independent check of batched_accuracy:
    mean squared distances x100, averaged over the envs with scan points."""
    from scipy.spatial import cKDTree
    s2g, g2s, floor = [], [], []
    for e, scan in enumerate(deduped):
        if len(scan) == 0:
            continue
        gt = gt_pts[e][gt_mask[e]].astype(np.float64)
        scan = scan.astype(np.float64)
        gt_tree = cKDTree(gt)
        s2g.append(np.mean(gt_tree.query(scan)[0] ** 2))
        g2s.append(np.mean(cKDTree(scan).query(gt)[0] ** 2))
        # the nearest OTHER GT point: the second neighbour of each
        floor.append(np.mean(gt_tree.query(gt, k=2)[0][:, 1] ** 2))
    s2g, g2s, floor = (np.array(x) * 100.0 for x in (s2g, g2s, floor))
    return {"mean_accuracy": float((s2g + g2s).mean()),
            "scan2gt": float(s2g.mean()), "gt2scan": float(g2s.mean()),
            "floor": float(floor.mean())}


def dedupe_case(card: str, ep, host: list) -> dict:
    """The card's 1 cm dedupe at the report's shape, on an episode's
    device scans ``ep.device_scans``: the kernels (``dedupe.dedupe_cm``,
    padded as the report pads) and the plain version on the card
    (``dedupe_cm_ref``) bit-equal, and each env's rows equal to the host's
    np.unique lists `host` (``evaluation.episode_scans``); a call's device
    records under the profiler (one launch of each of its two kernels,
    PyTorch's sort, the counts' copy); timed beside the plain version, the
    host's np.unique and the bound of ``dedupe.work``'s bytes."""
    pts, valid = ep.device_scans
    before_done = evaluation.before_done_mask(ep.dones)
    first_done = torch.as_tensor(before_done.sum(axis=0).astype(np.int64) - 1,
                                 device=pts.device)
    kernel = lambda: dedupe.dedupe_cm(pts, valid, first_done,
                                      evaluation.SCAN_PAD)
    plain = lambda: dedupe.dedupe_cm_ref(pts, valid, first_done,
                                         evaluation.SCAN_PAD)
    got, ref = kernel(), plain()
    if not (torch.equal(got.rows, ref.rows)
            and (got.counts == ref.counts).all()
            and (got.points_in == ref.points_in).all()):
        raise AssertionError("dedupe_cm: the kernels differ from the plain "
                             "version on the card")
    rows = got.rows.cpu().numpy()
    for e, want in enumerate(host):
        if got.counts[e] != len(want) or not np.array_equal(
                rows[e, :len(want)], want):
            raise AssertionError(f"dedupe_cm: env {e}'s rows differ from "
                                 "np.unique's")
    calls = 5

    def run():
        for _ in range(calls):
            kernel()

    kernel()
    _, spans = _profiled("dedupe_cm", run)
    names = [e.name for e in spans]
    ours = (PORT_KERNEL_FUNCTIONS["dedupe_cm"], DEDUPE_EMIT_FUNCTION)
    for fn in ours:
        if sum(fn in name for name in names) != calls:
            raise AssertionError(f"dedupe_cm: {calls} calls launched "
                                 f"{sorted(set(names))}, expected one {fn} "
                                 "a call")

    def device_ms(keep):
        return sum(e.time_range.end - e.time_range.start for e in spans
                   if keep(e.name)) / calls / 1e3

    kernels_ms = device_ms(lambda name: any(fn in name for fn in ours))
    copy_ms = device_ms(lambda name: "Memcpy" in name or "Memset" in name)
    all_ms = device_ms(lambda name: True)
    t_host = []
    for _ in range(3):
        t0 = time.perf_counter()
        evaluation.episode_scans(ep.scan_pts, ep.scan_valid, before_done)
        t_host.append(time.perf_counter() - t0)
    nbytes, ops = dedupe.work(valid.numel(), int(got.points_in.sum()),
                              int(got.counts.sum()))
    bound_ms, bound_by = _bound(nbytes, ops)
    res = {"ms": _time_ms(kernel, trials=11, calls=3),
           "plain_ms": _time_ms(plain, trials=3, calls=1),
           "np_unique_ms": statistics.median(t_host) * 1e3,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "device_ms": all_ms, "kernels_device_ms": kernels_ms,
           "sort_device_ms": all_ms - kernels_ms - copy_ms,
           "copies_device_ms": copy_ms,
           "device_activities_per_call": len(spans) / calls,
           "points_in": int(got.points_in.sum()),
           "rows": int(got.counts.sum())}
    print(f"dedupe_cm: {res['points_in']} points in, {res['rows']} rows out "
          f"({list(pts.shape)}); bit-equal to the plain version on the card "
          f"and to the host's np.unique; a call {res['ms']:.4f} ms (CUDA "
          f"events, with its wait for the counts), {all_ms:.4f} ms of device "
          f"time in {res['device_activities_per_call']:g} activities "
          f"(profiler: the two kernels {kernels_ms:.4f}, the sort "
          f"{res['sort_device_ms']:.4f}, copies {copy_ms:.4f}); plain version "
          f"{res['plain_ms']:.4f} ms, host np.unique {res['np_unique_ms']:.1f}"
          f" ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    return res


def _report_pieces(card: str, env, policy, report: dict) -> dict:
    """The held-out family's accuracy scan piece by piece on the card:
    the episodes with their scan, the host dedupe and batched_accuracy,
    each timed; the card's dedupe beside them (``dedupe_case``);
    batched_accuracy and the ray march on 2 envs held equal to the same
    functions on the CPU; the card's accuracy held to float64 KD trees;
    the ray march's device time per view."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep = evaluation.run_episodes(env, policy, POINT_STRIDE)
    t_episodes = time.perf_counter() - t0          # ends with host copies
    t0 = time.perf_counter()
    deduped = evaluation.episode_scans(ep.scan_pts, ep.scan_valid,
                                       evaluation.before_done_mask(ep.dones))
    t_dedupe = time.perf_counter() - t0
    dedupe_timing = dedupe_case(card, ep, deduped)
    sc = env.scenes
    sids = ep.scene_id
    gt = sc.gt_points[sids].cpu().numpy()
    gm = sc.gt_points_mask[sids].cpu().numpy()
    vox = ((sc.box_hi[sids] - sc.box_lo[sids]).cpu().numpy().max(axis=1)
           / sc.grid_res)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = evaluation.batched_accuracy(deduped, gt, gm, vox, device="cuda")
    t_accuracy = time.perf_counter() - t0          # ends on the host
    want = report["held_out_houses"]
    for key, value, digits in (("mean_accuracy_x100m2", acc[0], 3),
                               ("gt_unseen_frac", acc[4], 4),
                               ("accuracy_floor_gt_sampling", acc[5], 3)):
        if round(value, digits) != want[key]:
            raise AssertionError(f"report: batched_accuracy {key} {value} "
                                 f"against the report's {want[key]}")
    points = [len(p) for p in deduped]
    print(f"report: held_out_houses piece by piece: episodes with the scan "
          f"{t_episodes:.3f} s, host dedupe {t_dedupe:.3f} s, batched_accuracy "
          f"{t_accuracy:.3f} s on the card; deduped scan points a scene "
          f"{min(points)}-{max(points)} (mean {np.mean(points):.0f}), GT "
          f"points {int(gm.sum(axis=1).max())} at most [{card}]")

    # the card against the CPU on 2 envs: batched_accuracy, and the ray
    # march of the init view and of a step's view
    two = dict(deduped=deduped[:2], gt_pts=gt[:2], gt_mask=gm[:2], vox=vox[:2])
    on_card = evaluation.batched_accuracy(**two, device="cuda")
    t0 = time.perf_counter()
    on_cpu = evaluation.batched_accuracy(**two, device="cpu")
    t_cpu = time.perf_counter() - t0
    if on_card != on_cpu:
        raise AssertionError(f"report: batched_accuracy on 2 envs: card "
                             f"{on_card}, CPU {on_cpu}")
    sub_rays = evaluation.scan_rays(env, POINT_STRIDE)
    rng = np.random.default_rng(0)
    acts = torch.as_tensor(np.stack([rng.integers(0, k, 2) for k in spec.NVEC],
                                    -1), dtype=torch.int32, device="cuda")
    for label, poses in (
            ("init view", evaluation.init_pose(env).expand(2, -1)),
            ("step view", evaluation.step_poses(
                env, env.init_state(2)._replace(
                    episode_len=torch.ones(2, dtype=torch.int32,
                                           device="cuda")), acts))):
        r_c2w, t_c2w = camera.pose_to_c2w(poses, env.cfg.camera.z_offset)
        args = (sc.render_occ[sids[:2]], sc.box_lo[sids[:2]],
                sc.box_hi[sids[:2]], sub_rays, r_c2w, t_c2w)
        static = (sc.grid_res, 3 * sc.grid_res, env.cfg.camera.depth_max)
        card_out = render.render_depth(*args, *static)
        cpu_out = render.render_depth(*(a.cpu() for a in args), *static)
        for name, c, h in zip(("depth", "hit"), card_out, cpu_out):
            if not torch.equal(c.cpu(), h):
                raise AssertionError(f"report: raymarch {label} {name}: card "
                                     "differs from the CPU")
    print(f"report: on 2 envs, batched_accuracy and the ray march of the init "
          f"and a step's view are bit-equal on the card and the CPU "
          f"(tolerance 0; the CPU's batched_accuracy took {t_cpu:.3f} s)")

    kd = _kdtree_accuracy(deduped, gt, gm)
    for key, value in (("mean_accuracy", acc[0]), ("scan2gt", acc[1]),
                       ("gt2scan", acc[2]), ("floor", acc[5])):
        if not math.isclose(value, kd[key], rel_tol=1e-3):
            raise AssertionError(f"report: {key} {value} on the card against "
                                 f"{kd[key]} from float64 KD trees")
    print(f"report: held_out_houses accuracy on the card {acc[0]:.6f} "
          f"(scan2gt {acc[1]:.6f}, gt2scan {acc[2]:.6f}, floor {acc[5]:.6f}) "
          f"against float64 cKDTree {kd['mean_accuracy']:.6f} "
          f"({kd['scan2gt']:.6f}, {kd['gt2scan']:.6f}, {kd['floor']:.6f}), "
          "within 1e-3 relative")

    # the ray march of one view of every env (the init view), timed
    n = env.cfg.num_envs
    r_c2w, t_c2w = camera.pose_to_c2w(evaluation.init_pose(env).expand(n, -1),
                                      env.cfg.camera.z_offset)

    def view():
        return render.render_depth(
            sc.render_occ[sids], sc.box_lo[sids], sc.box_hi[sids], sub_rays,
            r_c2w, t_c2w, sc.grid_res, 3 * sc.grid_res, env.cfg.camera.depth_max)

    per_call, device_ms, _ = profile_calls(view, calls=5)
    wall_ms = _time_ms(view, trials=5, calls=2)
    print(f"report: raymarch of one view of {n} envs x {sub_rays.shape[0]} rays "
          f"(R={sc.grid_res}, at most {3 * sc.grid_res} steps): "
          f"{device_ms:.4f} ms of device time in {per_call:g} device "
          f"activities (profiler), {wall_ms:.3f} ms a call (CUDA events) "
          f"[{card}]")
    return {"episodes_s": t_episodes, "dedupe_s": t_dedupe,
            "dedupe_cm": dedupe_timing, "batched_accuracy_s": t_accuracy,
            "raymarch_view_device_ms": device_ms, "raymarch_view_ms": wall_ms,
            "raymarch_view_activities": per_call}


def phase_report(card: str, run_dir: str) -> dict:
    """The port's post_run on phase 7's run directory at full size (three
    families x 50 scenes x (reset + 30 steps) under the 400x400 camera,
    point_stride 8), then play with --ply, --obj and --export; returns each
    kernel's launches in the post_run call."""
    argv = [run_dir, "--eval_cam", str(EVAL_HW), "--point_stride",
            str(POINT_STRIDE), "--no-artifacts"]
    with open(os.path.join(run_dir, "config.json")) as f:
        raw = json.load(f)
    env_cfg = post_run.run_env_config(raw, EVAL_HW)
    fams = post_run.families(raw, 100)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = post_run.main(argv)
    secs = time.perf_counter() - t0                # ends on the host
    counts = launches()
    peak = torch.cuda.max_memory_allocated()

    # each family: its env's init-view cache where zbuf_impl=pallas, the
    # reset and one launch a step
    per_family = (1 + env_cfg.max_episode_length
                  + (env_cfg.renderer.zbuf_impl == "pallas"))
    # and the accuracy scan's ray march of each view, the init view's too,
    # the accuracy's dedupe and its three nearest-neighbour passes
    expect = {**splat_expect(len(fams) * per_family),
              "raymarch": len(fams) * (1 + env_cfg.max_episode_length),
              "nn_min": len(fams) * NN_PASSES, "dedupe_cm": len(fams)}
    if counts != expect:
        raise AssertionError(f"report launched {counts}, expected {expect}")
    with open(REFERENCE_REPORT) as f:
        reference = json.load(f)
    # the JAX report's keys, and what the held-out family ran on
    if set(report) != {"checkpoint", "held_out_dataset", "eval_cam",
                       *(tag for tag, _, _ in fams)}:
        raise AssertionError(f"report: keys {sorted(report)}")
    if (report["held_out_dataset"], report["eval_cam"]) != (fams[0][1],
                                                            EVAL_HW):
        raise AssertionError(f"report: held-out family on "
                             f"{report['held_out_dataset']!r} at "
                             f"{report['eval_cam']}")
    for tag, _, _ in fams:
        if set(report[tag]) != set(reference[tag]):
            raise AssertionError(f"report: {tag} has keys {sorted(report[tag])}, "
                                 f"the JAX report {sorted(reference[tag])}")
        if not all(math.isfinite(v) for v in report[tag].values()):
            raise AssertionError(f"report: {tag} not finite: {report[tag]}")
    print(f"report: post_run.main {' '.join(argv[1:])} on phase 7's run "
          f"({report['checkpoint']}) in {secs:.3f} s, {len(fams)} families x "
          f"{env_cfg.num_envs} scenes x (reset + {env_cfg.max_episode_length} "
          f"steps); peak memory {peak / 2 ** 30:.2f} GiB [{card}]")

    models = os.path.join(run_dir, "models")
    policy = post_run.load_policy(raw, models, report["checkpoint"], "cuda")
    envs = {}
    for tag, dataset, seed in fams:
        env = post_run.family_env(env_cfg, raw, dataset, seed, "cuda")
        envs[tag] = env
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = evaluation.evaluate(env, policy, POINT_STRIDE,
                                    compute_accuracy=False)
        t_plain = time.perf_counter() - t0
        t0 = time.perf_counter()
        full = evaluation.evaluate(env, policy, POINT_STRIDE)
        t_full = time.perf_counter() - t0
        # the scan does not disturb the env, and the report is reproducible
        for key, value in (("final_coverage", plain.mean_final_coverage),
                           ("mean_AUC", plain.mean_auc),
                           ("mean_reward", plain.mean_reward)):
            if round(value, 4) != report[tag][key]:
                raise AssertionError(f"report: {tag} {key} {value} without the "
                                     f"scan, {report[tag][key]} in the report")
        if post_run.family_report(full) != report[tag]:
            raise AssertionError(f"report: {tag} differs on a second run")
        print(f"report: {tag}: {report[tag]}; evaluate {t_full:.3f} s with the "
              f"accuracy scan, {t_plain:.3f} s without [{card}]")
    pieces = _report_pieces(card, envs["held_out_houses"], policy, report)

    # play: the PLY, the OBJ and the exported policy, on the card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_play_") as d:
        out = {k: os.path.join(d, f"recon.{k}") for k in ("ply", "obj")}
        exported = os.path.join(d, "policy.pt2")
        t0 = time.perf_counter()
        play.main(["--ckpt", os.path.join(models, report["checkpoint"]),
                   "--ply", out["ply"], "--obj", out["obj"],
                   "--export", exported, "--device", "cuda"]
                  + post_run.play_overrides(raw, EVAL_HW))
        t_play = time.perf_counter() - t0
        with open(out["ply"]) as f:
            n_pts = int(f.read().splitlines()[2].split()[-1])
        with open(out["obj"]) as f:
            n_faces = sum(line.startswith("f ") for line in f)
        if n_pts == 0 or n_faces == 0:
            raise AssertionError(f"play: {n_pts} PLY points, {n_faces} OBJ faces")
        env = envs["held_out_houses"]
        _, reset_out = env.reset(env.cfg.num_envs)
        policy.eval()
        with torch.no_grad():
            eager = distributions.mode(policy(reset_out.obs).logits)
        got = play.load_exported_policy(exported)(reset_out.obs)
        if not torch.equal(got, eager):
            raise AssertionError("play: the exported policy's actions differ "
                                 "from the eager policy's")
    print(f"play: --ply ({n_pts} points), --obj ({n_faces} faces) and --export "
          f"in {t_play:.3f} s; the loaded torch.export program's actions equal "
          f"the eager policy's on a {tuple(reset_out.obs.shape)} observation "
          f"batch [{card}]")
    return counts, pieces


def dda_config(carve_mode: str, mode: str = "dda") -> config.EnvConfig:
    """The flagship rollout's env (256 envs, 128x128, R=64) on the ray
    march or an external depth feed, with the given carve."""
    cfg = flagship_config()
    return dataclasses.replace(cfg, carve_mode=carve_mode,
                               renderer=dataclasses.replace(cfg.renderer,
                                                            mode=mode))


def dda_expect(carve_mode: str, mode: str = "dda") -> dict:
    """Each kernel's launches a step of the DDA, replay and callback paths:
    the hit scatter once; the gather of the depth and of the hit mask with
    the z-test carve, none with Bresenham's; the Bresenham kernel once with
    Bresenham's carve, never with the z-test; the ray march once on the
    DDA path, never on the others; no splat and no scatter-min z-buffer."""
    return {"gather_image": 2 if carve_mode == "ztest" else 0,
            "scatter_cells_any": 1, "zbuf_visible": 0, "zbuf_scatter_min": 0,
            "conv3d_wgrad": 0, "raymarch": int(mode == "dda"),
            "bresenham": int(carve_mode == "bresenham"), "nn_min": 0,
            "dedupe_cm": 0}


def _step_counted(env, state, actions, expect: dict, label: str):
    before = launches()
    state, out = env.step(state, actions)
    got = {k: v - before[k] for k, v in launches().items()}
    if got != expect:
        raise AssertionError(f"{label}: a step launched {got}, expected {expect}")
    return state, out


def _same_step(label, a, b, gray_tol: float = 0.0) -> float:
    """Raises unless two (state, StepOutput) pairs are equal: every field
    bit for bit, the grayscale frames (rgb_buf, the obs tail) within
    gray_tol.  Returns the largest grayscale difference."""
    (sa, oa), (sb, ob) = a, b
    n_state = 600 + G ** 3
    gray = 0.0
    for name, x, y in [*((f"out.{f}", getattr(oa, f), getattr(ob, f))
                         for f in oa._fields),
                       *((f"state.{f}", getattr(sa, f), getattr(sb, f))
                         for f in sa._fields)]:
        x, y = x.cpu(), y.cpu()
        if name == "out.obs":
            gray = max(gray, float((x[:, n_state:] - y[:, n_state:]).abs().max()))
            x, y = x[:, :n_state], y[:, :n_state]
        elif name == "state.rgb_buf":
            gray = max(gray, float((x - y).abs().max()))
            continue
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: {name} differs")
    if gray > gray_tol:
        raise AssertionError(f"{label}: grayscale frames differ by {gray}")
    return gray


def _first_envs(x: torch.Tensor, k: int = CPU_ENVS) -> torch.Tensor:
    return x[:k].clone()


def drive(card: str, label: str, cfg: config.EnvConfig, scenes, policy,
          expect: dict, steps: int):
    """Reset + `steps` steps of an N_ENVS env on the card with actions from
    the policy, timed, each kernel launched `expect` times a reset and a
    step; the outputs finite and the coverage in [0, 1], some above 0.
    Returns (actions [T, N, 6], poses [N, T + 1, 6] of each env's views,
    the first CPU_ENVS envs' (state, out) after reset and each step, the
    env, each kernel's launches in the run)."""
    env = ReconEnv(cfg, scenes)
    gen = torch.Generator(device="cuda").manual_seed(5)
    env.reset(N_ENVS)                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, out = env.reset(N_ENVS)
    counts = launches()
    if counts != expect:
        raise AssertionError(f"{label}: reset launched {counts}")
    keep = [tuple(type(x)(*map(_first_envs, x)) for x in (state, out))]
    # the obs opens with the pose history; its last pose is the step's view
    end = cfg.pose_buf_len * spec.ACTION_DIM
    poses, acts = [out.obs[:, end - spec.ACTION_DIM:end]], []
    with torch.no_grad():
        for t in range(steps):
            a, _, _ = policy.act(out.obs, gen)
            state, out = _step_counted(env, state, a, expect,
                                       f"{label} step {t}")
            acts.append(a)
            poses.append(out.obs[:, end - spec.ACTION_DIM:end])
            keep.append(tuple(type(x)(*map(_first_envs, x))
                              for x in (state, out)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for name, x in out._asdict().items():
        if x.is_floating_point() and not torch.isfinite(x).all():
            raise AssertionError(f"{label}: non-finite {name}")
    assert ((out.coverage >= 0) & (out.coverage <= 1)).all()
    assert (out.coverage > 0).any(), "the cameras see the scenes"
    print(f"{label}: reset + {steps} steps x {N_ENVS} envs at "
          f"{cfg.camera.height}x{cfg.camera.width}, R={RES}, "
          f"Q={scenes.surf_pts.shape[1]} in {secs:.3f} s = "
          f"{N_ENVS * (1 + steps) / secs:.1f} env-steps/s [{card}]; mean "
          f"coverage at the last step {float(out.coverage.mean()):.4f}; "
          f"launches a step {expect}; peak memory {peak / 2 ** 30:.2f} GiB")
    return (torch.stack(acts), torch.stack(poses, 1), keep, env,
            {k: v * (1 + steps) for k, v in expect.items()})


def drive_dda(card: str, scenes, policy, carve_mode: str):
    """Reset + DDA_STEPS steps of the 256-env DDA env (drive)."""
    return drive(card, f"dda {carve_mode}", dda_config(carve_mode), scenes,
                 policy, dda_expect(carve_mode), DDA_STEPS)


def _cpu_scenes(scenes, k: int = CPU_ENVS):
    """The first k scenes of a SceneSet, on the CPU."""
    return scene_lib.SceneSet(
        *(getattr(scenes, f)[:k].cpu() for f in scene_lib.SceneSet._fields[:-2]),
        grid_res=scenes.grid_res, grid_size=scenes.grid_size)


def check_on_cpu(label: str, cfg: config.EnvConfig, scenes, actions,
                 keep) -> float:
    """The first CPU_ENVS envs through the port on the CPU with the card
    run's actions: every step's outputs and states equal the card's (the
    grayscale frames within 1e-4); returns their largest difference."""
    env = ReconEnv(dataclasses.replace(cfg, num_envs=CPU_ENVS),
                   _cpu_scenes(scenes))
    state, out = env.reset(CPU_ENVS)
    gray = _same_step(f"{label} reset, card vs CPU", keep[0], (state, out),
                      1e-4)
    for t in range(actions.shape[0]):
        state, out = env.step(state, actions[t, :CPU_ENVS].cpu())
        gray = max(gray, _same_step(f"{label} step {t}, card vs CPU",
                                    keep[t + 1], (state, out), 1e-4))
    return gray


def _profile_dda_pieces(card: str, env, actions) -> dict:
    """Device time and activities of one DDA step and of its ray march and
    Bresenham carve alone (torch.profiler), on the last step's inputs."""
    sc = env.scenes
    state, out = env.reset(N_ENVS)
    a = actions[-1]
    step = profile(f"dda {env.cfg.carve_mode}: one env step",
                   lambda: env.step(state, a))
    poses = fp32.fma(a.float(), env.action_unit, env.pose_low)
    r, t = camera.pose_to_c2w(poses, env.cfg.camera.z_offset)
    sid = state.scene_id
    march = profile("dda: the ray march of one step", lambda: render.render_depth(
        sc.render_occ[sid], sc.box_lo[sid], sc.box_hi[sid], env.cam_rays, r, t,
        sc.grid_res, 3 * sc.grid_res, env.cfg.camera.depth_max))
    res = {"step": step, "march": march}
    if env.cfg.carve_mode == "bresenham":
        gen = torch.Generator(device="cuda").manual_seed(0)
        hit = (torch.rand(state.tri_grid.shape, device="cuda", generator=gen)
               < 0.05).float()
        cam_voxel = voxel.pose_to_voxel_idx(poses[:, :3], sc.range_gt[sid],
                                            sc.voxel_size[sid])
        res["carve"] = profile(
            "dda: the Bresenham carve of one step (5% of cells hit)",
            lambda: carve.carve_bresenham(hit, cam_voxel, G))
    return res


def phase_dda(card: str, scenes) -> dict:
    """renderer.mode=dda with both carves, then replay and callback, at
    full width; returns each kernel's launches by run."""
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    policy.eval()
    counts, runs = {}, {}
    for carve_mode in ("ztest", "bresenham"):
        actions, poses, keep, env, counts[f"dda_{carve_mode}"] = drive_dda(
            card, scenes, policy, carve_mode)
        t0 = time.perf_counter()
        gray = check_on_cpu(f"dda {carve_mode}", dda_config(carve_mode),
                            scenes, actions, keep)
        print(f"dda {carve_mode}: envs 0-{CPU_ENVS - 1} equal the port on the "
              f"CPU over reset + {DDA_STEPS} steps, every output and state "
              f"field bit for bit but the grayscale frames "
              f"({'also bit for bit' if gray == 0 else f'max diff {gray:.3g}'}) "
              f"({time.perf_counter() - t0:.1f} s)")
        pieces = _profile_dda_pieces(card, env, actions)
        runs[carve_mode] = (actions, poses, env)
        print(f"dda {carve_mode}: a step {pieces['step']['busy_ms']:.3f} ms of "
              f"device time in {pieces['step']['activities']} activities; the "
              f"ray march {pieces['march']['busy_ms']:.3f} ms in "
              f"{pieces['march']['activities']}"
              + (f"; the Bresenham carve {pieces['carve']['busy_ms']:.3f} ms in "
                 f"{pieces['carve']['activities']}" if "carve" in pieces else "")
              + f" [{card}]")

    # replay and callback over the frames of the ztest run's views
    actions, poses, dda_env = runs["ztest"]
    t0 = time.perf_counter()
    bank = record_replay_bank(scenes, dda_env.cfg.camera, poses)
    replay = ReplayDepthSource(bank)
    thr = dda_env.cfg.camera.depth_max * (1.0 - 1e-4)
    far_hits = int((bank.fg & (bank.frames >= thr)).sum())

    def host_render(sids, p):
        d, _ = replay.render_batch(torch.from_numpy(sids).cuda(),
                                   torch.from_numpy(p).cuda())
        return d.cpu().numpy()

    envs = {
        "dda": dda_env,
        "replay": ReconEnv(dda_config("ztest", "replay"), scenes, replay),
        "callback": ReconEnv(dda_config("ztest", "callback"), scenes,
                             CallbackDepthSource(host_render, HW, HW,
                                                 dda_env.cfg.camera.depth_max)),
    }
    # the callback derives foreground from the depth: where the ray march
    # hit at or beyond depth_max (1 - 1e-4) it differs from the hit mask,
    # so it is held to a replay bank whose mask is derived alike
    if far_hits:
        envs["derived"] = ReconEnv(
            dda_config("ztest", "replay"), scenes, ReplayDepthSource(
                ReplayBank(bank.poses, bank.frames, bank.frames < thr)))
    expect = {name: dda_expect("ztest", env.cfg.renderer.mode)
              for name, env in envs.items()}
    reset_launches()
    trace = {name: env.reset(N_ENVS) for name, env in envs.items()}
    for t in range(DDA_STEPS + 1):
        _same_step(f"replay vs dda, step {t}", trace["replay"], trace["dda"])
        _same_step(f"callback, step {t}", trace["callback"],
                   trace["derived" if far_hits else "dda"])
        if t == DDA_STEPS:
            break
        trace = {name: _step_counted(env, trace[name][0], actions[t],
                                     expect[name], f"{name} step {t}")
                 for name, env in envs.items()}
    per_env = {name: {k: v * (1 + DDA_STEPS) for k, v in e.items()}
               for name, e in expect.items()}
    if launches() != {k: sum(e[k] for e in per_env.values())
                      for k in KERNELS}:
        raise AssertionError(f"replay/callback run launched {launches()}")
    counts["replay"] = per_env["replay"]
    counts["callback"] = per_env["callback"]
    print(f"replay: a bank of {poses.shape[1]} views of each of "
          f"{scenes.num_scenes} scenes recorded by the card's DDA; the replay "
          f"env equals the dda env bit for bit over reset + {DDA_STEPS} steps, "
          f"and the callback env equals "
          f"{'a replay env with the mask derived from the depth' if far_hits else 'the dda env'} "
          f"({far_hits} hits at or beyond depth_max (1 - 1e-4)) "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")
    return counts


def phase_convert(root: str) -> dict:
    """N_MESHES procedural houses of seed 0 and the eval's 50 of its seed,
    meshed into OBJs under root by the native mesher and converted by the
    port's convert_dataset; returns {"train"/"held_out": directory}."""
    dirs, t_mesh, t_conv = {}, 0.0, 0.0
    for tag, n, seed in (("train", N_MESHES, 0),
                         ("held_out", spec.EVAL_NUM_ENVS, EVAL_SEED)):
        t0 = time.perf_counter()
        meshes = os.path.join(root, f"meshes_{tag}")
        convert_dataset.write_procedural_meshes(meshes, n, seed, RES)
        t1 = time.perf_counter()
        dirs[tag] = os.path.join(root, tag)
        convert_dataset.convert(meshes, dirs[tag], RES, G, 1.0, verbose=False)
        t_mesh += t1 - t0
        t_conv += time.perf_counter() - t1
    print(f"dataset: {N_MESHES} + {spec.EVAL_NUM_ENVS} houses meshed into "
          f"OBJs in {t_mesh:.1f} s and converted at R={RES} in {t_conv:.1f} s "
          f"({os.cpu_count()} CPUs)")
    return dirs


def flagship_sets(*extra: str) -> list:
    """The train CLIs' --set arguments of the flagship recipe
    (reports/r5_refbudget128/config.json) but its log directory and
    experiment name, then `extra`."""
    with open(FLAGSHIP) as f:
        raw = json.load(f)

    def leaves(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            elif f"{prefix}{k}" not in ("runner.log_dir",
                                        "runner.experiment_name"):
                yield f"{prefix}{k}={v}"

    return [arg for leaf in (*leaves(raw, ""), *extra)
            for arg in ("--set", leaf)]


def phase_dataset(card: str, dirs: dict, root: str) -> dict:
    """Training on the converted scenes with the held-out directory as the
    eval dataset, then post_run's held-out family; returns each kernel's
    launches by run."""
    log_dir = os.path.join(root, "runs")
    argv = ["--device", "cuda", "--log_dir", log_dir, "--exp_name", "dataset",
            "--eval_dataset", dirs["held_out"], *flagship_sets(
                f"env.scene.dataset={dirs['train']}",
                f"ppo.total_iters={DATASET_ITERS}",
                f"runner.eval_freq={DATASET_ITERS}",
                f"runner.save_freq={DATASET_ITERS}")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    train_eval_gennbv.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    train_counts = launches()
    peak = torch.cuda.max_memory_allocated()
    (run,) = os.listdir(log_dir)
    run_dir = os.path.join(log_dir, run)
    with open(os.path.join(run_dir, "config.json")) as f:
        recorded = json.load(f)
    if recorded.get("eval_dataset") != os.path.abspath(dirs["held_out"]):
        raise AssertionError(f"config.json records eval_dataset "
                             f"{recorded.get('eval_dataset')!r}")
    # setup reset, 128 steps an iteration, one eval (reset + 30 steps)
    n_steps = recorded["ppo"]["n_steps"]
    expect = trained(splat_expect(1 + DATASET_ITERS * n_steps + 1
                                  + spec.MAX_EPISODE_LENGTH_EVAL))
    if train_counts != expect:
        raise AssertionError(f"dataset training launched {train_counts}, "
                             f"expected {expect}")
    logged = read_logged(run_dir)
    for rec in logged:
        for k in _METRIC_KEYS:
            if not math.isfinite(rec[k]):
                raise AssertionError(f"dataset training: non-finite {k}")
    assert math.isfinite(logged[-1]["eval/final_coverage"])
    train_q = scene_lib.load_npz(os.path.join(dirs["train"], "scenes.npz"),
                                 "cpu").surf_pts.shape[1]
    for rec in logged:
        print(f"dataset: iteration {rec['step']}"
              f"{' (warm-up)' if rec['step'] == 1 else ''}: "
              f"{rec['time/iter_seconds']:.3f} s = rollout "
              f"{rec['time/rollout']:.3f} + update {rec['time/update']:.3f} s; "
              f"{rec['time/fps']:.1f} env-steps/s [{card}]")
    print(f"dataset: train_eval_gennbv on {N_MESHES} converted scenes "
          f"(Q={train_q}), eval on {dirs['held_out']} under {EVAL_HW}x{EVAL_HW} "
          f"(final coverage {logged[-1]['eval/final_coverage']:.4f}) in "
          f"{secs:.3f} s; peak memory {peak / 2 ** 30:.2f} GiB [{card}]")

    reset_launches()
    t0 = time.perf_counter()
    report = post_run.main([run_dir, "--eval_cam", str(EVAL_HW), "--only",
                            "held_out_houses", "--no-artifacts"])
    t_report = time.perf_counter() - t0
    report_counts = launches()
    # the family's steps and its reset, the accuracy scan's ray march of
    # each view, the accuracy's dedupe and its three nearest-neighbour passes
    expect = {**splat_expect(1 + spec.MAX_EPISODE_LENGTH_EVAL),
              "raymarch": 1 + spec.MAX_EPISODE_LENGTH_EVAL,
              "nn_min": NN_PASSES, "dedupe_cm": 1}
    if report_counts != expect:
        raise AssertionError(f"dataset post_run launched {report_counts}, "
                             f"expected {expect}")
    if (report["held_out_dataset"], report["eval_cam"]) != (
            os.path.abspath(dirs["held_out"]), EVAL_HW):
        raise AssertionError(f"post_run's held-out family ran on "
                             f"{report['held_out_dataset']!r}")
    fam = report["held_out_houses"]
    if not all(math.isfinite(v) for v in fam.values()):
        raise AssertionError(f"dataset post_run: non-finite {fam}")
    held_q = scene_lib.load_npz(os.path.join(dirs["held_out"], "scenes.npz"),
                                "cpu").surf_pts.shape[1]
    print(f"dataset: post_run --eval_cam {EVAL_HW} took its held-out family "
          f"from config.json ({held_q=}): final coverage "
          f"{fam['final_coverage']}, accuracy {fam['mean_accuracy_x100m2']} "
          f"in {t_report:.3f} s [{card}]")
    return {"dataset_train": train_counts, "dataset_report": report_counts}


def rsl_args(log_dir: str, iters: int, *extra: str,
             task: str = "drone_velocity") -> list:
    """train_rsl's arguments at the CLI's full width on `task`."""
    return ["--task", task, "--num_envs", str(RSL_ENVS),
            "--num_steps_per_env", str(RSL_STEPS),
            "--hidden", *map(str, RSL_HIDDEN), "--max_iterations", str(iters),
            "--log_dir", log_dir, "--save_interval", "1", *extra]


def check_rsl_logged(card: str, logged: list, cfg, label: str = "rsl",
                     keys=on_policy_runner.METRIC_KEYS) -> None:
    """Every metric finite, the learning rate in [min_lr, max_lr]; prints
    each iteration's rates."""
    steps = RSL_ENVS * RSL_STEPS
    for rec in logged:
        for k in keys:
            if not math.isfinite(rec[k]):
                raise AssertionError(f"{label}: non-finite {k} at iteration "
                                     f"{rec['step']}")
        # the learning rate is float32, clamped to the bounds in float32
        if not (np.float32(cfg.min_lr) <= np.float32(rec["learning_rate"])
                <= np.float32(cfg.max_lr)):
            raise AssertionError(f"{label}: learning rate "
                                 f"{rec['learning_rate']} at iteration "
                                 f"{rec['step']}")
        print(f"{label}: iteration {rec['step']}: {rec['time/iter_seconds']:.4f} s "
              f"= rollout {rec['time/rollout']:.4f} s "
              f"({steps / rec['time/rollout']:.1f} env-steps/s) + update "
              f"{rec['time/update']:.4f} s (+ fetch); {rec['time/fps']:.1f} "
              f"env-steps/s; reward {rec['mean_reward']:+.5f}, kl "
              f"{rec['mean_kl']:.5f}, lr {rec['learning_rate']:.6g} [{card}]")


def resume_rsl(card: str, log_dir: str, first, task: str = "drone_velocity",
               label: str = "rsl") -> None:
    """train_rsl --resume to RSL_ITERS + 1: raises unless it starts at
    iteration RSL_ITERS from the parameters and optimizer state saved
    there, which are the first run's."""
    at_start = {}
    learn = on_policy_runner.OnPolicyRunner.learn

    def spy(runner, *args, **kw):
        at_start.update(iteration=runner.iteration, snap=snapshot(runner, []),
                        lr=runner.opt_state.learning_rate.clone())
        return learn(runner, *args, **kw)

    on_policy_runner.OnPolicyRunner.learn = spy
    try:
        resumed = train_rsl.main(rsl_args(log_dir, RSL_ITERS + 1, "--resume",
                                          task=task))
    finally:
        on_policy_runner.OnPolicyRunner.learn = learn
    if at_start["iteration"] != RSL_ITERS or resumed.iteration != RSL_ITERS + 1:
        raise AssertionError(f"{label}: resumed at {at_start['iteration']}, "
                             f"ended at {resumed.iteration}")
    diff = first_difference(snapshot(first, []), at_start["snap"])
    saved = torch.load(os.path.join(log_dir, f"model_{RSL_ITERS}.pt"),
                       map_location="cuda", weights_only=True)
    if diff or not torch.equal(at_start["lr"], first.opt_state.learning_rate) \
            or any(not torch.equal(v, saved["params"][k])
                   for k, v in at_start["snap"]["variables"].items()):
        raise AssertionError(f"{label}: the resumed runner differs from "
                             f"model_{RSL_ITERS}.pt ({diff})")
    if [r["step"] for r in read_logged(log_dir)] != list(range(1, RSL_ITERS + 2)):
        raise AssertionError(f"{label}: the resumed run's log")
    print(f"{label}: --resume loaded model_{RSL_ITERS}.pt: iteration {RSL_ITERS}, "
          "the saved parameters and optimizer state bit for bit; ran to "
          f"{resumed.iteration} [{card}]")


def reproduce_rsl(card: str, make_env=DroneRobot, label: str = "rsl") -> None:
    """Two OnPolicyRunners from seed 1 at phase 11's width on envs from
    `make_env` end 2 iterations with the same parameters, optimizer state
    and logged metrics (but time/*), bit for bit."""
    snaps = []
    for _ in range(2):
        log_dir = tempfile.mkdtemp(prefix="chip_smoke_rsl_repro_")
        try:
            runner = on_policy_runner.OnPolicyRunner(
                make_env(), ppoc.ContinuousPPOConfig(),
                on_policy_runner.OnPolicyRunnerConfig(
                    num_steps_per_env=RSL_STEPS, save_interval=0),
                num_envs=RSL_ENVS, log_dir=log_dir, seed=1,
                actor_hidden=RSL_HIDDEN, critic_hidden=RSL_HIDDEN)
            runner.learn(2, log=True)
            snaps.append(snapshot(runner, read_logged(log_dir)))
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
    diff = first_difference(*snaps)
    if diff:
        raise AssertionError(f"{label}: a second OnPolicyRunner from seed 1 "
                             f"differs first in {diff}")
    print(f"{label}: two OnPolicyRunners from seed 1 end 2 iterations with the "
          "same parameters, optimizer state and logged metrics (but time/*), "
          f"bit for bit [{card}]")


def drone_on_cpu(card: str, runner) -> None:
    """RSL_CPU_ENVS drones from a fresh spawn on the card, copied to the
    CPU, stepped RSL_CPU_STEPS times on both with the same actions, drawn
    uniformly in +-0.3 as tests/test_torch_drone.py's are (a policy of a
    few iterations flips most drones within 8 steps).  At each step the
    CPU's copy of the trained policy must give the card's mean actions on
    the same observations within MLP_RTOL/ATOL, and the CPU's drones the
    card's step outputs and states within DRONE_RTOL/ATOL.  A drone whose
    episode ends is re-spawned from its device's generator, which draws
    differently on the two devices, so it leaves the comparison after that
    step's outputs; three quarters of the drones must stay in it to the
    end."""
    env = runner.env
    cpu_env = DroneRobot(env.cfg, device="cpu")
    cpu_model = GaussianActorCritic(env.obs_dim, env.num_actions, RSL_HIDDEN,
                                    RSL_HIDDEN, device="cpu")
    cpu_model.load_state_dict(runner.model.state_dict())
    policy = runner.get_inference_policy()
    state, out = env.reset(RSL_CPU_ENVS,
                           torch.Generator(device="cuda").manual_seed(5))
    cs = state._replace(**{f: getattr(state, f).cpu() for f in state._fields
                           if f != "rng"},
                        rng=torch.Generator().manual_seed(5).get_state())
    co_obs = out.obs.cpu()
    live = torch.ones(RSL_CPU_ENVS, dtype=torch.bool)
    worst = {"actions": 0.0, "state": 0.0, "obs": 0.0, "reward": 0.0}

    def held(label, got, want, rtol, atol, key):
        got, want = got[live], want.cpu()[live]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"rsl: {label}")
        worst[key] = max(worst[key], float((got - want).abs().max()))

    draws = torch.Generator().manual_seed(6)
    for k in range(RSL_CPU_STEPS):
        with torch.no_grad():
            held(f"the policy on the CPU at step {k}", cpu_model(co_obs).mean,
                 policy(out.obs), MLP_RTOL, MLP_ATOL, "actions")
        actions = 0.6 * torch.rand(RSL_CPU_ENVS, env.num_actions,
                                   generator=draws) - 0.3
        state, out = env.step(state, actions.cuda())
        cs, co = cpu_env.step(cs, actions)
        if not torch.equal(co.done[live], out.done.cpu()[live]):
            raise AssertionError(f"rsl: done differs at step {k}")
        held(f"obs at step {k}", co.obs, out.obs, DRONE_RTOL, DRONE_ATOL, "obs")
        held(f"reward at step {k}", co.reward, out.reward, DRONE_RTOL, 1e-6,
             "reward")
        live &= ~co.done
        for f in ("pos", "quat", "lin_vel", "ang_vel", "rotor_vel",
                  "ep_reward"):
            held(f"{f} at step {k}", getattr(cs, f), getattr(state, f),
                 DRONE_RTOL, DRONE_ATOL, "state")
        co_obs = co.obs
    if live.sum() < 3 * RSL_CPU_ENVS // 4:
        raise AssertionError(f"rsl: only {int(live.sum())} drones flew "
                             f"{RSL_CPU_STEPS} steps")
    print(f"rsl: {RSL_CPU_ENVS} drones x {RSL_CPU_STEPS} steps on the CPU from "
          f"the card's state agree with the card ({int(live.sum())} flew all "
          "steps): max abs differences "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" [{card}]")


def profile_rsl(card: str, runner, what: str = "drones",
                label: str = "rsl") -> None:
    """One iteration of the runner at full width (rollout, GAE, update),
    timed and then under the profiler: the device-busy share and device
    activities per env step (one step of all RSL_ENVS robots)."""
    state, out = runner.env.reset(RSL_ENVS, runner.generator)
    obs = out.obs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs, metrics = runner._train_iteration(state, obs)
    metrics.tolist()
    secs = time.perf_counter() - t0
    res = profile(f"{label}: an iteration ({RSL_STEPS} steps of {RSL_ENVS} "
                  f"{what}, the update)", lambda: runner._train_iteration(state, obs)[2]
                  .tolist(), secs)
    print(f"{label}: {res['activities'] / RSL_STEPS:.1f} device activities per env "
          f"step, device busy {res['busy_ms']:.3f} ms of the {secs * 1e3:.3f} ms "
          f"unprofiled iteration [{card}]")
    rollout_res = profile(f"{label}: a rollout ({RSL_STEPS} steps)",
                          lambda: runner._rollout(state, obs))
    print(f"{label}: rollout {rollout_res['activities'] / RSL_STEPS:.1f} device "
          f"activities and {rollout_res['busy_ms'] / RSL_STEPS:.3f} ms device "
          f"time per env step [{card}]")


def phase_rsl(card: str) -> dict:
    """train_rsl on the drone at the CLI's full width, a resume, a second
    runner from the seed, the CPU against the card and the profile;
    returns each kernel's launches in the training run (all 0)."""
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_rsl_")
    try:
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = train_rsl.main(rsl_args(log_dir, RSL_ITERS))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launches()
        peak = torch.cuda.max_memory_allocated()
        if any(counts.values()):
            raise AssertionError(f"rsl launched {counts}, expected none")
        cfg = first.alg_cfg
        assert (cfg.num_learning_epochs, cfg.num_mini_batches, cfg.desired_kl,
                first.device.type) == (5, 4, 0.01, "cuda")
        logged = read_logged(log_dir)
        if [r["step"] for r in logged] != list(range(1, RSL_ITERS + 1)):
            raise AssertionError("rsl: logged iterations")
        check_rsl_logged(card, logged, cfg)
        print(f"rsl: train_rsl {RSL_ITERS} iterations of {RSL_ENVS} envs x "
              f"{RSL_STEPS} steps, update 5 x 4 minibatches of "
              f"{RSL_ENVS * RSL_STEPS // 4} rows, in {secs:.3f} s with the "
              f"saves; peak memory {peak / 2 ** 30:.3f} GiB [{card}]")
        resume_rsl(card, log_dir, first)
        reproduce_rsl(card)
        drone_on_cpu(card, first)
        profile_rsl(card, first)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return counts


# ---------------------------------------------------------------------------
# phase 12: the legged robots, rough terrain, the recurrent family and the
# terrain scenes


def _legged_fields_close(label, got, want, keep) -> float:
    """Raises unless the state fields (and the step's outputs) of the envs
    in `keep` agree within LEGGED_SCALE_TOL of each field's largest
    magnitude (at least 1) and their masks are equal; returns the largest
    difference relative to that scale."""
    (gs, go), (ws, wo) = got, want
    worst = 0.0
    for name in ("last_contacts", "knee_contact", "episode_len",
                 "terrain_level"):
        if not torch.equal(getattr(gs, name)[keep].cpu(),
                           getattr(ws, name)[keep].cpu()):
            raise AssertionError(f"{label}: {name} differs")
    pairs = [(f, getattr(gs, f), getattr(ws, f)) for f in LEGGED_FIELDS]
    pairs += [(f"out.{f}", getattr(go, f), getattr(wo, f))
              for f in ("obs", "reward", "episode_reward")]
    for name, a, b in pairs:
        a, b = a[keep].cpu().double(), b[keep].cpu().double()
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max()) / scale
        if err > LEGGED_SCALE_TOL:
            raise AssertionError(f"{label}: {name} differs by {err * scale} "
                                 f"(scale {scale})")
        worst = max(worst, err)
    return worst


def _to_cpu_state(state):
    return state._replace(**{f: getattr(state, f).cpu() for f in state._fields
                             if f != "rng"},
                          rng=torch.Generator().manual_seed(5).get_state())


def legged_on_cpu(card: str, env, policy=None, label="legged") -> None:
    """RSL_CPU_ENVS robots from a fresh spawn on the card, stepped
    RSL_CPU_STEPS times with the same actions (uniform in +-0.3, or the
    policy's mean plus that where a policy is given), each step on the CPU
    from a copy of the card's state before it (the explicit contacts are
    stiff: tests/test_torch_legged.py compares the port with JAX the same
    way, at LEGGED_SCALE_TOL).  Done envs re-spawn from their device's
    generator, so their post-reset state leaves the comparison."""
    cpu_env = LeggedRobot(env.cfg, device="cpu")
    state, out = env.reset(RSL_CPU_ENVS,
                           torch.Generator(device="cuda").manual_seed(5))
    draws = torch.Generator().manual_seed(6)
    worst = 0.0
    for k in range(RSL_CPU_STEPS):
        actions = 0.6 * torch.rand(RSL_CPU_ENVS, env.num_actions,
                                   generator=draws) - 0.3
        if policy is not None:
            actions = actions + policy(out.obs).cpu()
        cs = _to_cpu_state(state)
        state, out = env.step(state, actions.cuda())
        cs, co = cpu_env.step(cs, actions)
        if not torch.equal(co.done, out.done.cpu()):
            raise AssertionError(f"{label}: done differs at step {k}")
        keep = ~co.done
        worst = max(worst, _legged_fields_close(
            f"{label} step {k}, card vs CPU", (cs, co), (state, out), keep))
    print(f"{label}: {RSL_CPU_ENVS} robots x {RSL_CPU_STEPS} steps on the CPU "
          f"from the card's state agree with the card within "
          f"{LEGGED_SCALE_TOL:g} of each field's scale (largest {worst:.3g}); "
          f"contact, knee and done masks equal [{card}]")


def phase_legged(card: str) -> dict:
    """train_rsl's default task at the CLI's full width, a resume, a second
    runner from the seed, the CPU against the card, the profile, and one
    iteration of each other robot; returns each kernel's launches in the
    training runs (all 0)."""
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_legged_")
    label = "legged a1"
    try:
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = train_rsl.main(rsl_args(log_dir, RSL_ITERS, task=LEGGED_TASK))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launches()
        peak = torch.cuda.max_memory_allocated()
        if any(counts.values()):
            raise AssertionError(f"{label} launched {counts}, expected none")
        env = first.env
        assert isinstance(env, legged_robot.LeggedRobot)
        assert (env.obs_dim, env.num_actions, first.device.type) == (48, 12,
                                                                      "cuda")
        logged = read_logged(log_dir)
        if [r["step"] for r in logged] != list(range(1, RSL_ITERS + 1)):
            raise AssertionError(f"{label}: logged iterations")
        check_rsl_logged(card, logged, first.alg_cfg, label)
        print(f"{label}: train_rsl {RSL_ITERS} iterations of {RSL_ENVS} envs x "
              f"{RSL_STEPS} steps in {secs:.3f} s with the saves; peak memory "
              f"{peak / 2 ** 30:.3f} GiB [{card}]")
        t0 = time.perf_counter()
        resume_rsl(card, log_dir, first, LEGGED_TASK, label)
        t1 = time.perf_counter()
        reproduce_rsl(card, lambda: LeggedRobot(legged_robot.a1_config()), label)
        t2 = time.perf_counter()
        legged_on_cpu(card, env, first.get_inference_policy(), label)
        t3 = time.perf_counter()
        # LEGGED_PROFILE_STEPS rollout steps (the policy's forward and
        # sample, the env step) under the profiler: its post-processing
        # takes ~0.5 ms a device activity on the host, ~37 s for a whole
        # rollout's 71,000 (phase 11 profiles the whole iteration; the
        # legged update is the drone's)
        state, out = env.reset(RSL_ENVS, first.generator)

        def rollout_steps():
            s, o = state, out
            with torch.no_grad():
                for _ in range(LEGGED_PROFILE_STEPS):
                    ac = first.model(o.obs)
                    a = gaussian.sample(ac.mean, ac.log_std, first.generator)
                    gaussian.log_prob(ac.mean, ac.log_std, a)
                    s, o = env.step(s, a)

        res = profile(f"{label}: {LEGGED_PROFILE_STEPS} rollout steps of "
                      f"{RSL_ENVS} robots", rollout_steps)
        print(f"{label}: a rollout step {res['activities'] / LEGGED_PROFILE_STEPS:.1f} "
              f"device activities and {res['busy_ms'] / LEGGED_PROFILE_STEPS:.3f} "
              f"ms device time, busy {100 * res['busy_ms'] / res['wall_ms']:.1f}% "
              f"of its profiled wall [{card}]")
        print(f"{label}: the resume {t1 - t0:.1f} s, the second runners "
              f"{t2 - t1:.1f} s, the CPU check {t3 - t2:.1f} s, the profile "
              f"{time.perf_counter() - t3:.1f} s")
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    zoo = {}
    for task in LEGGED_ZOO:
        log_dir = tempfile.mkdtemp(prefix="chip_smoke_legged_")
        try:
            reset_launches()
            t0 = time.perf_counter()
            runner = train_rsl.main(rsl_args(log_dir, 1, task=task))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            zoo[task] = launches()
            if any(zoo[task].values()):
                raise AssertionError(f"{task} launched {zoo[task]}")
            rec = read_logged(log_dir)[0]
            check_rsl_logged(card, [rec], runner.alg_cfg, f"legged {task}")
            print(f"legged {task}: one iteration of {RSL_ENVS} envs (obs "
                  f"{runner.env.obs_dim}, {runner.env.num_actions} actions) "
                  f"in {secs:.3f} s [{card}]")
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
    return {"legged": counts,
            "legged_zoo": {k: sum(c[k] for c in zoo.values()) for k in KERNELS}}


def _circular(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a.double().cpu() - b.double().cpu()).abs() % 1.0
    return torch.minimum(d, 1.0 - d)


def phase_rough(card: str) -> None:
    """A rough-terrain A1 with measure_heights (obs 235) and curriculum
    levels, on the card against the CPU: the hash at 100,000 cell corners
    within CARD_HASH_BOUND on the circle, the heights at 100,000 points of
    every level within amp * CARD_HASH_BOUND but at hash wraps (at most
    8 * CARD_HASH_BOUND of them), and RSL_CPU_ENVS robots stepped on the
    card with the CPU's observation of each step's state held to it.
    (The steps themselves are not compared: 16% of the hashes differ by
    an ulp of the product between the devices, and the ground's error
    moves the stiff contacts past the plane's tolerance.)"""
    cfg = legged_robot.a1_config(terrain=legged_robot.LeggedTerrain(
        mesh_type="rough", measure_heights=True, curriculum=True))
    env, cpu_env = LeggedRobot(cfg), LeggedRobot(cfg, device="cpu")
    assert env.obs_dim == 235
    rng = np.random.default_rng(0)
    n = 100_000
    ix, iy = (torch.from_numpy(rng.integers(-160, 160, n).astype(np.float32))
              for _ in range(2))
    circ = _circular(env.terrain_hash(ix.cuda(), iy.cuda()),
                     cpu_env.terrain_hash(ix, iy))
    if float(circ.max()) > CARD_HASH_BOUND:
        raise AssertionError(f"rough: the hash differs by {float(circ.max())}")
    x, y = (torch.from_numpy(rng.uniform(-40, 40, n).astype(np.float32))
            for _ in range(2))
    level = torch.from_numpy(rng.integers(0, 10, n).astype(np.int32))
    amp = 0.08 * (level.double() + 1.0) / 10
    err = (env.terrain_height(x.cuda(), y.cuda(), level.cuda()).cpu().double()
           - cpu_env.terrain_height(x, y, level).double()).abs() / amp
    wrapped = err > CARD_HASH_BOUND + 1e-5
    # a height leaves the bound only where one of its four corners' hash
    # lies within the bound of the circle's seam at 0 (a wrap): for hashes
    # spread evenly over [0, 1), at most 4 * 2 * CARD_HASH_BOUND of them
    if (float(wrapped.double().mean()) > 8 * CARD_HASH_BOUND
            or float(err.max()) > 1.0):
        raise AssertionError(f"rough: {int(wrapped.sum())} heights past the "
                             f"bound, the largest {float(err.max())} of amp")
    print(f"rough: the hash at {n} corners within {float(circ.max()):.3g} "
          f"(bound {CARD_HASH_BOUND:g}) card vs CPU, "
          f"{float((circ > 0).double().mean()):.4f} of them unequal; heights "
          f"within amp x the bound at all but {int(wrapped.sum())} of {n} "
          f"points (wraps) [{card}]")

    # 256 robots stepped on the card; at each step the CPU's observation
    # of a copy of the card's state: the height grid within 5 * amp *
    # CARD_HASH_BOUND but at wraps, the rest within LEGGED_SCALE_TOL
    state, out = env.reset(RSL_CPU_ENVS,
                           torch.Generator(device="cuda").manual_seed(8))
    draws = torch.Generator().manual_seed(9)
    no = torch.zeros(RSL_CPU_ENVS, dtype=torch.bool)
    worst, wrapped = 0.0, 0
    for k in range(RSL_CPU_STEPS):
        actions = 0.6 * torch.rand(RSL_CPU_ENVS, 12, generator=draws) - 0.3
        state, out = env.step(state, actions.cuda())
        if not torch.isfinite(out.obs).all() or out.obs.shape[1] != 235:
            raise AssertionError(f"rough: the observation at step {k}")
        cs = _to_cpu_state(state)
        co = cpu_env._out(cs, out.reward.cpu(), no, no, None)
        got, want = out.obs.cpu().double(), co.obs.double()
        err = float((got[:, :48] - want[:, :48]).abs().max())
        if err > LEGGED_SCALE_TOL * max(1.0, float(want[:, :48].abs().max())):
            raise AssertionError(f"rough: obs differ by {err} at step {k}")
        amp5 = 5 * 0.08 * (cs.terrain_level.double()[:, None] + 1.0) / 10
        herr = (got[:, 48:] - want[:, 48:]).abs() / amp5
        past = herr > CARD_HASH_BOUND + 1e-5
        wrapped += int(past.sum())
        worst = max(worst, float(herr[~past].max()))
        if float(herr.max()) > 1.0:
            raise AssertionError(f"rough: a height differs by "
                                 f"{float(herr.max())} x 5 amp at step {k}")
    n_heights = RSL_CPU_ENVS * RSL_CPU_STEPS * 187
    if wrapped > 8 * CARD_HASH_BOUND * n_heights:
        raise AssertionError(f"rough: {wrapped} of {n_heights} heights past "
                             "the bound")
    print(f"rough: {RSL_CPU_ENVS} robots x {RSL_CPU_STEPS} steps on the card "
          f"(levels 0-5): the CPU's observation of the card's state has the "
          f"height grid within {worst:.3g} of 5 x amp (bound "
          f"{CARD_HASH_BOUND:g}) at all but {wrapped} of {n_heights} points "
          f"(wraps), the rest within {LEGGED_SCALE_TOL:g} [{card}]")


def phase_recurrent(card: str) -> dict:
    """train_rsl --recurrent on the default task at 4,096 envs, a second
    runner from the seed, and the exported policy against the runner's;
    returns each kernel's launches in the training run (all 0)."""
    args = ["--task", LEGGED_TASK, "--num_envs", str(RSL_ENVS),
            "--num_steps_per_env", str(RSL_STEPS), "--max_iterations",
            str(REC_ITERS), "--recurrent"]
    label = "recurrent"
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = train_rsl.main(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"{label} launched {counts}, expected none")
    assert isinstance(first, ppo_recurrent.RecurrentOnPolicyRunner)
    assert first.model.rnn_type == "lstm" and first.iteration == REC_ITERS
    if first.opt_state.count != REC_ITERS * 20:
        raise AssertionError(f"{label}: {first.opt_state.count} Adam steps")
    check_rsl_logged(card, first.logged, first.cfg, label,
                     ppo_recurrent.METRIC_KEYS)
    print(f"{label}: train_rsl --recurrent {REC_ITERS} iterations of "
          f"{RSL_ENVS} envs x {RSL_STEPS} steps (LSTM 256, heads 256, 5 x 4 "
          f"minibatches of {RSL_ENVS // 4} trajectories) in {secs:.3f} s; "
          f"peak memory {peak / 2 ** 30:.3f} GiB [{card}]")
    # a second runner from seed 1, built as train_rsl builds its runner
    second = ppo_recurrent.RecurrentOnPolicyRunner(
        LeggedRobot(legged_robot.a1_config()), ppoc.ContinuousPPOConfig(),
        num_steps_per_env=RSL_STEPS, num_envs=RSL_ENVS, seed=1)
    second.learn(REC_ITERS)
    diff = first_difference(snapshot(first, first.logged),
                            snapshot(second, second.logged))
    if diff:
        raise AssertionError(f"{label}: a second runner from seed 1 differs "
                             f"first in {diff}")
    print(f"{label}: a second RecurrentOnPolicyRunner from seed 1 ends "
          f"{REC_ITERS} iterations with train_rsl's parameters, optimizer "
          f"state and metrics (but time/*), bit for bit [{card}]")
    # the export against the runner's inference policy, 4 steps of carried
    # hidden state on the env's observations
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_rec_"), "rec.pt2")
    try:
        nbytes = play.export_recurrent_policy(first.model, first.env.obs_dim,
                                              path, batch=RSL_CPU_ENVS)
        exported = play.load_exported_policy(path)
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    policy = first.get_inference_policy()
    env = first.env
    state, out = env.reset(RSL_CPU_ENVS,
                           torch.Generator(device="cuda").manual_seed(7))
    hidden = first.model.initial_state(RSL_CPU_ENVS)
    leaves = actor_critic.hidden_leaves(hidden)
    worst = 0.0
    for k in range(4):
        mean, hidden = policy(out.obs, hidden)
        with torch.no_grad():
            emean, *leaves = exported(out.obs, *leaves)
        for a, b in zip((emean, *leaves),
                        (mean, *actor_critic.hidden_leaves(hidden))):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=MLP_RTOL, atol=MLP_ATOL,
                                       err_msg=f"{label}: export step {k}")
            worst = max(worst, float((a - b).abs().max()))
        state, out = env.step(state, mean)
        hidden = actor_critic.reset_hidden(hidden, out.done)
        leaves = [x * (~out.done).float()[:, None] for x in leaves]
    print(f"{label}: export_recurrent_policy ({nbytes} bytes) -> "
          f"load_exported_policy equals the runner's inference policy over 4 "
          f"steps of carried hidden state on the card (max abs difference "
          f"{worst:.3g}) [{card}]")
    return counts


def phase_terrain(card: str) -> dict:
    """TERRAIN_SCENES terrain scenes (seed 0, R=64) through the flagship env
    on the splat path (256 envs, 128x128), reset + TERRAIN_STEPS steps of
    the seeded policy's actions (drive): each kernel launched once a reset
    and a step, and the first CPU_ENVS envs equal to the port on the CPU
    step by step; returns each kernel's launches in the run."""
    cfg = dataclasses.replace(
        flagship_config(), scene=config.SceneConfig(num_scenes=TERRAIN_SCENES,
                                                    seed=0, dataset="terrain"))
    t0 = time.perf_counter()
    scenes = make_scenes(cfg.scene, RES)
    print(f"terrain: {TERRAIN_SCENES} terrain scenes (seed 0) at R={RES}, "
          f"Q={scenes.surf_pts.shape[1]}, at most "
          f"{int(scenes.surf_mask.sum(1).max())} valid points, in "
          f"{time.perf_counter() - t0:.1f} s")
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    policy.eval()
    actions, _, keep, _, counts = drive(card, "terrain", cfg, scenes, policy,
                                        splat_expect(1),
                                        TERRAIN_STEPS)
    gray = check_on_cpu("terrain", cfg, scenes, actions, keep)
    print(f"terrain: envs 0-{CPU_ENVS - 1} equal the port on the CPU over "
          f"reset + {TERRAIN_STEPS} steps, every output and state field bit "
          f"for bit but the grayscale frames (max diff {gray:.3g}) [{card}]")
    return counts


def phase_12(card: str) -> dict:
    """Phase 12's parts in turn, each timed; returns each kernel's
    launches by run."""
    secs, counts = {}, {}
    for part, run in (("legged", phase_legged), ("rough", phase_rough),
                      ("recurrent", phase_recurrent),
                      ("terrain", phase_terrain)):
        t0 = time.perf_counter()
        got = run(card)
        secs[part] = time.perf_counter() - t0
        if part == "legged":
            counts.update(got)
        elif got is not None:
            counts[part] = got
    print(f"phase 12: {sum(secs.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f") [{card}]")
    return counts


# ---------------------------------------------------------------------------
# phase 13: the off-policy family (SAC, TD3, DDPG, DQN, HER) and the
# all-families example


def to_device(x, device):
    """`x` (tensors in NamedTuples, dicts, lists) with every tensor copied
    to `device`; ints, floats and None as they are."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    return x


def flat_state(x, prefix: str = "", out: dict | None = None) -> dict:
    """Every tensor and number of `x` (NamedTuples, dicts) by its path,
    copied."""
    out = {} if out is None else out
    if isinstance(x, torch.Tensor):
        out[prefix] = x.detach().clone()
    elif isinstance(x, dict):
        for k, v in x.items():
            flat_state(v, f"{prefix}.{k}", out)
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for f in x._fields:
            flat_state(getattr(x, f), f"{prefix}.{f}", out)
    elif isinstance(x, (int, float)):
        out[prefix] = torch.tensor(x)
    return out


def _first_unequal(a: dict, b: dict) -> str | None:
    if list(a) != list(b):
        return "the state's layout"
    return next((k for k in a if not torch.equal(a[k], b[k])), None)


def _state_groups(st) -> dict:
    """The parameter groups of an off-policy or DQN state, each with the
    Adam state whose first moments mark its noise entries."""
    if isinstance(st, dqn.DQNState):
        return {"q": (st.params, st.opt_state),
                "target q": (st.target_params, st.opt_state)}
    return {"actor": (st.actor_params, st.actor_opt),
            "critic": (st.critic_params, st.critic_opt),
            "target actor": (st.target_actor_params, st.actor_opt),
            "target critic": (st.target_critic_params, st.critic_opt),
            "log_alpha": ({"log_alpha": st.log_alpha}, st.alpha_opt)}


def held_update(label: str, got, want, lr: float) -> float:
    """Raises unless the state `got` after one update on the card agrees
    with `want`, the same update's on the CPU, within
    tests/test_torch_off_policy.py's tolerances (parameters OP_PARAM_ATOL,
    moments OP_MOMENT_RTOL plus a share of the tensor's largest; an entry
    whose first moment lies inside that share is float32 cancellation
    noise, which Adam's first steps turn into up to lr, and is held to lr
    and its moments to the share); returns the largest parameter
    difference."""
    worst = 0.0
    want_groups = _state_groups(want)
    for name, (gp, gopt) in _state_groups(got).items():
        wp, wopt = want_groups[name]
        if gopt.count != wopt.count:
            raise AssertionError(f"{label}: {name} Adam count {gopt.count} "
                                 f"against {wopt.count}")
        for k, w in wp.items():
            mu = wopt.mu[k].abs()
            noisy = mu <= OP_MOMENT_SHARE["mu"] * mu.max()
            err = (gp[k].cpu() - w).abs()
            if (err > torch.where(noisy, lr, OP_PARAM_ATOL)).any():
                raise AssertionError(f"{label}: {name} {k} differs from the "
                                     f"CPU by {float(err.max()):.3g}")
            worst = max(worst, float(err.max()))
            for moment in ("mu", "nu"):
                wm = getattr(wopt, moment)[k]
                band = OP_MOMENT_SHARE[moment] * float(wm.abs().max())
                tol = torch.where(noisy, 2 * band, OP_MOMENT_RTOL * wm.abs() + band)
                merr = (getattr(gopt, moment)[k].cpu() - wm).abs()
                if (merr > tol).any():
                    raise AssertionError(
                        f"{label}: {name} Adam {moment} {k} differs from the "
                        f"CPU by {float(merr.max()):.3g}")
    return worst


def _held_metrics(label: str, got: dict, want: dict) -> None:
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=OP_METRIC_RTOL,
                                   atol=OP_METRIC_ATOL, err_msg=f"{label}: {k}")


def offpolicy_update_on_cpu(label: str, learner, st, batch, noises) -> float:
    """One update of `learner`'s algorithm from `st` on `batch` with
    `noises`, on the card and on the CPU: held_update and the metrics
    within OP_METRIC_RTOL/ATOL."""
    cpu = off_policy.OffPolicyLearner(learner.cfg, learner.obs_dim,
                                      learner.action_dim,
                                      torch.Generator().manual_seed(0))
    got, got_m = learner.update(st, batch, *noises)
    want, want_m = cpu.update(*to_device((st, batch, *noises), "cpu"))
    _held_metrics(label, got_m, want_m)
    return held_update(label, got, want, learner.cfg.learning_rate)


def dqn_update_on_cpu(label: str, runner, st, batch) -> float:
    cpu = dqn.DQNRunner(IdentityEnvMultiDiscrete(nvec=runner.env.nvec,
                                                 device="cpu"),
                        runner.cfg, runner.num_envs)
    return held_update(label, runner.update(st, batch),
                       cpu.update(*to_device((st, batch), "cpu")),
                       runner.cfg.learning_rate)


def _all_finite(label: str, tensors: dict) -> None:
    bad = [k for k, v in tensors.items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"{label}: non-finite {bad[:5]}")


def _moved(label: str, before: dict, after: dict, prefixes) -> None:
    for p in prefixes:
        keys = [k for k in before if k.startswith(p)]
        if not keys or all(torch.equal(before[k], after[k]) for k in keys):
            raise AssertionError(f"{label}: {p} did not move")


def _timed_chunks(runner) -> list:
    """Wraps runner._chunk to record each chunk's wall seconds (ended by a
    device synchronize) and whether it acted at random."""
    record, chunk = [], runner._chunk

    def timed(*args):
        t0 = time.perf_counter()
        res = chunk(*args)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t0, bool(args[3:] and args[3])))
        return res

    runner._chunk = timed
    return record


def _ms_per_update(update, calls: int = 20) -> float:
    """Wall ms of `calls` updates back to back (each feeding the next),
    ended by a device synchronize."""
    update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        update()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def _profile_chunk(card: str, label: str, runner, reset_obs, *extra) -> None:
    """OFF_PROFILE_STEPS learning env steps of `runner` (each with its
    gradient step), timed and then under the profiler: device activities
    and device busy time per env step."""
    env_state, obs = reset_obs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env_state, obs, _ = runner._chunk(env_state, obs, OFF_PROFILE_STEPS, *extra)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    res = profile(f"{label}: {OFF_PROFILE_STEPS} env steps with their "
                  "gradient steps",
                  lambda: runner._chunk(env_state, obs, OFF_PROFILE_STEPS,
                                        *extra)[2].item(), secs)
    print(f"{label}: {res['activities'] / OFF_PROFILE_STEPS:.1f} device "
          f"activities and {res['busy_ms'] / OFF_PROFILE_STEPS:.3f} ms device "
          f"busy per env step, {secs / OFF_PROFILE_STEPS * 1e3:.3f} ms wall "
          f"unprofiled [{card}]")
    # where the host's time goes: the operators' own host time under a
    # host-only profile (which adds its own cost to each)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        runner._chunk(env_state, obs, OFF_PROFILE_STEPS, *extra)[2].item()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    total = sum(e.self_cpu_time_total for e in ops)
    print(f"{label}: host time per env step under a host-only profile "
          f"{total / OFF_PROFILE_STEPS / 1e3:.3f} ms; most by operator: "
          + ", ".join(f"{e.key} {e.self_cpu_time_total / OFF_PROFILE_STEPS / 1e3:.3f}"
                      f" ms ({e.count / OFF_PROFILE_STEPS:g} calls)"
                      for e in ops[:8]) + f" [{card}]")


def phase_offpolicy(card: str, algo: str) -> dict:
    """SAC, TD3 or DDPG through OffPolicyRunner on OFF_ENVS drones at the
    default OffPolicyConfig, learn(OFF_STEPS, chunk=OFF_CHUNK); returns
    each kernel's launches in that run (all 0)."""
    label = algo
    cfg = off_policy.OffPolicyConfig(algo=algo)
    runner = off_policy.OffPolicyRunner(DroneRobot(), cfg, OFF_ENVS, seed=1)
    before = flat_state(runner.learner.state, "state")
    chunks = _timed_chunks(runner)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mean_rew = runner.learn(OFF_STEPS, chunk=OFF_CHUNK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"{label} launched {counts}, expected none")
    st, buf = runner.learner.state, runner.buffer
    grad_steps = OFF_STEPS - OFF_CHUNK           # the first chunk is random
    written = OFF_STEPS * OFF_ENVS
    if (st.step, buf.pos, buf.size) != (grad_steps,
                                        written % cfg.buffer_capacity,
                                        min(written, cfg.buffer_capacity)):
        raise AssertionError(f"{label}: step {st.step}, buffer pos {buf.pos} "
                             f"size {buf.size}")
    after = flat_state(st, "state")
    _all_finite(label, {**after, **{f"metric {k}": v.reshape(1)
                                    for k, v in runner.metrics.items()},
                        "mean reward": torch.tensor([mean_rew])})
    _moved(label, before, after, ("state.actor_params", "state.critic_params",
                                  "state.target_actor_params",
                                  "state.target_critic_params"))
    alpha = float(runner.metrics["alpha"])
    if algo == "sac" and alpha == 1.0:
        raise AssertionError(f"{label}: alpha did not move")
    rand_s = sum(s for s, r in chunks if r)
    learn_s = sum(s for s, r in chunks if not r)
    print(f"{label}: learn({OFF_STEPS}, chunk={OFF_CHUNK}) on {OFF_ENVS} drones "
          f"(MLPs 256-256, batch {cfg.batch_size}, buffer "
          f"{cfg.buffer_capacity}) in {secs:.3f} s: the random chunk "
          f"{OFF_CHUNK * OFF_ENVS / rand_s:.1f} env-steps/s, the learning "
          f"chunks {grad_steps * OFF_ENVS / learn_s:.1f} env-steps/s and "
          f"{grad_steps / learn_s:.1f} gradient steps/s; mean reward "
          f"{mean_rew:.4f}, critic loss "
          f"{float(runner.metrics['critic_loss']):.4g}, alpha {alpha:.4f}; "
          f"step {st.step}, buffer pos {buf.pos} size {buf.size}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB [{card}]")
    snap = {**after, **flat_state(buf, "buffer")}

    # one update on the card and on the CPU from the same state and draws
    learner = runner.learner
    batch = rb.sample(buf, runner.generator, cfg.batch_size)
    noises = learner.draw_noises(cfg.batch_size, runner.generator)
    worst = offpolicy_update_on_cpu(label, learner, st, batch, noises)
    ms = _ms_per_update(lambda: learner.update(st, batch, *noises))
    print(f"{label}: an update on the card agrees with the CPU's (max "
          f"parameter difference {worst:.3g}); {ms:.3f} ms an update "
          f"(wall, {cfg.batch_size} rows) [{card}]")
    reset = runner.env.reset(OFF_ENVS, runner.generator)
    _profile_chunk(card, label, runner, (reset[0], reset[1].obs), False)

    # a second runner from seed 1; TD3's actor moves on even steps only
    second = off_policy.OffPolicyRunner(DroneRobot(), cfg, OFF_ENVS, seed=1)
    update, moved = second.learner.update, []

    def spy(s, *args):
        new, metrics = update(s, *args)
        moved.append((s.step, not all(torch.equal(new.actor_params[k], v)
                                      for k, v in s.actor_params.items())))
        return new, metrics

    second.learner.update = spy
    second.learn(OFF_STEPS, chunk=OFF_CHUNK)
    expect = [(k, algo != "td3" or k % cfg.policy_delay == 0)
              for k in range(grad_steps)]
    if moved != expect:
        raise AssertionError(f"{label}: the actor moved at {moved}")
    diff = _first_unequal(snap, {**flat_state(second.learner.state, "state"),
                                 **flat_state(second.buffer, "buffer")})
    if diff:
        raise AssertionError(f"{label}: a second runner from seed 1 differs "
                             f"first in {diff}")
    print(f"{label}: a second OffPolicyRunner from seed 1 ends with the same "
          "parameters, targets, Adam states, log_alpha and buffer, bit for "
          f"bit; its actor moved on {sum(m for _, m in moved)} of {grad_steps} "
          f"gradient steps [{card}]")
    return counts


def phase_dqn(card: str) -> dict:
    """DQNRunner on IdentityEnvMultiDiscrete(nvec=(4,)) at OFF_ENVS envs and
    the default DQNConfig, learn(DQN_STEPS, chunk=DQN_CHUNK), across a
    target sync; returns each kernel's launches in that run (all 0)."""
    label = "dqn"
    cfg = dqn.DQNConfig()
    runner = dqn.DQNRunner(IdentityEnvMultiDiscrete(nvec=(4,)), cfg, OFF_ENVS,
                           seed=1)
    before = flat_state(runner.state, "state")
    chunks = _timed_chunks(runner)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mean_rew = runner.learn(DQN_STEPS, chunk=DQN_CHUNK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"{label} launched {counts}, expected none")
    st, buf = runner.state, runner.buffer
    written = DQN_STEPS * OFF_ENVS
    # a gradient step from the first env step that fills learning_starts
    grad_steps = DQN_STEPS + 1 - math.ceil(cfg.learning_starts / OFF_ENVS)
    if (st.grad_steps, st.env_steps, buf.pos, buf.size) != (
            grad_steps, written, written % cfg.buffer_capacity,
            min(written, cfg.buffer_capacity)):
        raise AssertionError(f"{label}: {st.grad_steps} gradient steps, "
                             f"{st.env_steps} env steps, buffer pos {buf.pos} "
                             f"size {buf.size}")
    after = flat_state(st, "state")
    _all_finite(label, {**after, "mean reward": torch.tensor([mean_rew])})
    _moved(label, before, after, ("state.params", "state.target_params"))
    learn_s = sum(s for s, _ in chunks)
    print(f"{label}: learn({DQN_STEPS}, chunk={DQN_CHUNK}) on {OFF_ENVS} envs "
          f"(MLP 256-256, batch {cfg.batch_size}, buffer {cfg.buffer_capacity}, "
          f"a sync every {cfg.target_update_interval} gradient steps) in "
          f"{secs:.3f} s: {written / learn_s:.1f} env-steps/s, "
          f"{grad_steps / learn_s:.1f} gradient steps/s; mean reward "
          f"{mean_rew:.4f}; peak memory {peak / 2 ** 30:.3f} GiB [{card}]")
    snap = {**after, **flat_state(buf, "buffer")}

    batch = rb.sample(buf, runner.generator, cfg.batch_size)
    worst = dqn_update_on_cpu(label, runner, st, batch)
    ms = _ms_per_update(lambda: runner.update(st, batch))
    print(f"{label}: an update on the card agrees with the CPU's (max "
          f"parameter difference {worst:.3g}); {ms:.3f} ms an update (wall, "
          f"{cfg.batch_size} rows) [{card}]")
    reset = runner.env.reset(OFF_ENVS, runner.generator)
    _profile_chunk(card, label, runner, (reset[0], reset[1].obs))

    # a second runner from seed 1: the target equals the online network
    # just after each sync and stays put between syncs
    second = dqn.DQNRunner(IdentityEnvMultiDiscrete(nvec=(4,)), cfg, OFF_ENVS,
                           seed=1)
    update, syncs = second.update, []

    def spy(s, *args):
        new = update(s, *args)
        if new.grad_steps % cfg.target_update_interval == 0:
            if not all(torch.equal(new.target_params[k], v)
                       for k, v in new.params.items()):
                raise AssertionError(f"{label}: the target after the sync at "
                                     f"{new.grad_steps}")
            syncs.append(new.grad_steps)
        elif new.target_params is not s.target_params:
            raise AssertionError(f"{label}: the target moved at "
                                 f"{new.grad_steps}")
        return new

    second.update = spy
    second.learn(DQN_STEPS, chunk=DQN_CHUNK)
    if syncs != list(range(cfg.target_update_interval, grad_steps + 1,
                           cfg.target_update_interval)):
        raise AssertionError(f"{label}: syncs at {syncs}")
    diff = _first_unequal(snap, {**flat_state(second.state, "state"),
                                 **flat_state(second.buffer, "buffer")})
    if diff:
        raise AssertionError(f"{label}: a second runner from seed 1 differs "
                             f"first in {diff}")
    print(f"{label}: a second DQNRunner from seed 1 ends with the same "
          "parameters, target, Adam state and buffer, bit for bit; the target "
          f"equalled the online network just after the syncs at {syncs} "
          f"[{card}]")
    return counts


def phase_her(card: str) -> dict:
    """HERRunner (the default SAC config) on GoalPointEnv(dim=2,
    ep_length=8, terminate_on_success=True) at HER_ENVS envs, HER_ROUNDS
    rounds; returns each kernel's launches in that run (all 0)."""
    label = "her"
    cfg = off_policy.OffPolicyConfig()
    her_cfg = her.HERConfig()

    def make():
        env = GoalPointEnv(dim=2, ep_length=8, terminate_on_success=True)
        return her.HERRunner(env, cfg, her_cfg, HER_ENVS,
                             capacity_episodes=HER_CAPACITY, seed=1)

    runner = make()
    before = flat_state(runner.learner.state, "state")
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner.learn(HER_ROUNDS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"{label} launched {counts}, expected none")
    env, st, buf = runner.env, runner.learner.state, runner.buffer
    ready = [r for r in range(HER_ROUNDS)
             if r * HER_ENVS * env.ep_length >= cfg.learning_starts]
    grad_steps = len(ready) * runner.updates_per_round
    rounds = HER_ROUNDS * HER_ENVS
    if (st.step, buf.pos, buf.size) != (grad_steps, rounds % HER_CAPACITY,
                                        min(rounds, HER_CAPACITY)):
        raise AssertionError(f"{label}: step {st.step}, buffer pos {buf.pos} "
                             f"size {buf.size}")
    after = flat_state(st, "state")
    _all_finite(label, {**after, **{f"metric {k}": v.reshape(1)
                                    for k, v in runner.metrics.items()}})
    _moved(label, before, after, ("state.actor_params", "state.critic_params"))
    ended_early = float((buf.done[:, :-1] > 0.5).float().mean())
    print(f"{label}: {HER_ROUNDS} rounds of {HER_ENVS} envs x {env.ep_length} "
          f"steps ({grad_steps} gradient steps, buffer of {HER_CAPACITY} "
          f"rounds) in {secs:.3f} s: "
          f"{HER_ROUNDS * HER_ENVS * env.ep_length / secs:.1f} env-steps/s; "
          f"{100 * ended_early:.2f}% of steps before the last end an episode; "
          f"peak memory {peak / 2 ** 30:.3f} GiB [{card}]")

    # segment ends and a relabeled sample on the card, bit-equal to the CPU
    cpu_env = GoalPointEnv(dim=2, ep_length=8, terminate_on_success=True,
                           device="cpu")
    if not torch.equal(her.segment_ends(buf.done).cpu(),
                       her.segment_ends(buf.done.cpu())):
        raise AssertionError(f"{label}: segment_ends on the card")
    if not torch.equal(buf.seg_end.cpu(), her.segment_ends(buf.done.cpu())):
        raise AssertionError(f"{label}: the buffer's segment ends")
    draws = her.draw_relabel_indices(buf.size, cfg.batch_size, env.ep_length,
                                     runner.generator)
    got = her.relabel(buf, draws, env.goal_dim, env.compute_reward, her_cfg)
    want = her.relabel(to_device(buf, "cpu"), to_device(draws, "cpu"),
                       env.goal_dim, cpu_env.compute_reward, her_cfg)
    for f in rb.Batch._fields:
        if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
            raise AssertionError(f"{label}: relabel's {f} on the card")
    relabeled = float((draws.u < her_cfg.future_fraction).float().mean())
    print(f"{label}: segment_ends of the {buf.size} rounds and a relabeled "
          f"sample of {cfg.batch_size} ({100 * relabeled:.1f}% relabeled) on "
          f"the card equal the CPU's, bit for bit [{card}]")

    second = make()
    second.learn(HER_ROUNDS)
    diff = _first_unequal(
        {**after, **flat_state(buf, "buffer")},
        {**flat_state(second.learner.state, "state"),
         **flat_state(second.buffer, "buffer")})
    if diff:
        raise AssertionError(f"{label}: a second runner from seed 1 differs "
                             f"first in {diff}")
    print(f"{label}: a second HERRunner from seed 1 ends with the same "
          f"parameters, targets, Adam states and buffer, bit for bit [{card}]")
    return counts


def phase_example(card: str) -> dict:
    """gennbv_tpu_torch.examples.custom_env_families run whole on the card:
    every number it prints finite; returns each kernel's launches (all
    0)."""
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        custom_env_families.main(["--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    lines = out.getvalue().splitlines()
    numbers = [float(x) for line in lines for x in re.findall(
        r"[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|nan|inf)", line)]
    if (len(lines) != 6 or not numbers
            or not all(math.isfinite(x) for x in numbers)):
        raise AssertionError(f"example: printed {lines}")
    if any(counts.values()):
        raise AssertionError(f"example launched {counts}, expected none")
    for line in lines:
        print(f"example: {line}")
    print(f"example: custom_env_families ran on the card in {secs:.3f} s, "
          f"{len(numbers)} numbers printed, all finite [{card}]")
    return counts


def phase_13(card: str) -> dict:
    """Phase 13's parts in turn, each timed; returns each kernel's
    launches by run."""
    secs, counts = {}, {}
    parts = [(algo, lambda c, a=algo: phase_offpolicy(c, a))
             for algo in ("sac", "td3", "ddpg")]
    parts += [("dqn", phase_dqn), ("her", phase_her), ("example", phase_example)]
    for part, run in parts:
        t0 = time.perf_counter()
        counts[part] = run(card)
        secs[part] = time.perf_counter() - t0
    print(f"phase 13: {sum(secs.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f") [{card}]")
    return counts


# phase 14's iterations at the flagship recipe, and the steps of its
# full-width update from a fixed rollout
MESH_ITERS, MESH_UPDATE_STEPS = 1, 16


def _mesh_iteration(cfg: config.Config, scenes):
    runner = Runner(cfg, scenes=scenes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = runner.train(MESH_ITERS, log=False)
    torch.cuda.synchronize()
    return runner, metrics, time.perf_counter() - t0


def _divergence(got: dict, want: dict, snap: dict, want_snap: dict) -> str:
    """The update metrics' relative differences and the largest parameter
    difference over its tensor's scale, as a line."""
    keys = ("train/policy_gradient_loss", "train/approx_kl",
            "train/clip_fraction", "train/value_loss")
    rel = {k.split("/")[1]: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
           for k in keys}
    params = {k: float((snap["variables"][k] - w).abs().max()
                       / w.abs().max().clamp_min(1e-30))
              for k, w in want_snap["variables"].items()
              if "num_batches" not in k}
    worst = max(params, key=params.get)
    return (", ".join(f"{k} {v:.3g}" for k, v in rel.items())
            + f"; parameters up to {params[worst]:.3g} of a tensor's scale "
            f"({worst})")


@contextlib.contextmanager
def _advantages_one_ulp_up():
    """ppo._loss sees every advantage one ulp up: the smallest change of
    the update's inputs, the control for phase 14's comparison."""
    real = ppo._loss

    def nudged(policy, cfg, obs, actions, logp, values, adv, ret, mesh=None):
        return real(policy, cfg, obs, actions, logp, values,
                    torch.nextafter(adv, torch.full_like(adv, math.inf)), ret,
                    mesh)

    ppo._loss = nudged
    try:
        yield
    finally:
        ppo._loss = real


def phase_mesh(card: str, scenes) -> dict:
    """Phase 14: (a) the flagship training iteration through the mesh path
    at W = 1 over nccl against the one-process Runner and itself, and a
    full-width minibatch on the mesh against one process; (b)
    graft_entry.dryrun_multichip on 2 ranks sharing the card over gloo and
    on 4 CPU ranks (with tensor parallelism).  Returns (a)'s kernel
    launches."""
    import torch_mesh_ranks as ranks
    cfg = train_config()
    ref, want, ref_secs = _mesh_iteration(cfg, scenes)
    want_snap = snapshot(ref, [])
    del ref
    with _advantages_one_ulp_up():
        nudged, nudge, _ = _mesh_iteration(cfg, scenes)
    control = _divergence(nudge, want, snapshot(nudged, []), want_snap)
    del nudged
    # one update of the full-width policy from a fixed rollout: its first
    # minibatch on the mesh against one process
    small = dataclasses.replace(cfg, ppo=dataclasses.replace(
        cfg.ppo, n_steps=MESH_UPDATE_STEPS))
    step_want = ranks.update_case("cuda", small)
    cfg1 = config.apply_overrides(cfg, ("runner.num_devices=1",))
    store = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        reset_launches()
        runner, got, secs = _mesh_iteration(cfg1, scenes)
        counts = launches()
        assert runner.mesh is not None and runner.mesh.env_width == 1
        expect = trained(splat_expect(1 + MESH_ITERS * cfg.ppo.n_steps))
        if counts != expect:
            raise AssertionError(f"mesh launched {counts}, expected {expect}")
        for k in _METRIC_KEYS[:9]:
            if got[k] != want[k]:
                raise AssertionError(f"mesh: {k} {got[k]!r} against the "
                                     f"one-process run's {want[k]!r}")
        for k in _METRIC_KEYS[9:]:
            if not math.isfinite(got[k]):
                raise AssertionError(f"mesh: non-finite {k}")
        if got["train/n_minibatches"] != want["train/n_minibatches"]:
            raise AssertionError("mesh: the KL stop came at another minibatch")
        snap = snapshot(runner, [])
        divergence = _divergence(got, want, snap, want_snap)
        del runner
        twin, again, _ = _mesh_iteration(cfg1, scenes)
        diff = first_difference(snap, snapshot(twin, []))
        diff = diff or next((k for k in got if not k.startswith("time/")
                             and got[k] != again[k]), None)
        if diff:
            raise AssertionError(f"mesh: a second W = 1 run from seed "
                                 f"{cfg.runner.seed} differs first in {diff}")
        del twin
        step_got = ranks.update_case("cuda", config.apply_overrides(
            small, ("runner.num_devices=1",)))
        ranks.held_step(step_got, step_want)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    steps = cfg.ppo.n_steps * cfg.env.num_envs
    print(f"mesh: the flagship iteration at W = 1 over nccl in {secs:.3f} s "
          f"({steps / secs:.1f} env-steps/s; rollout {got['time/rollout']:.3f}"
          f" + update {got['time/update']:.3f} s; {got['train/n_minibatches']:g}"
          f" minibatches), one process {ref_secs:.3f} s; rollout metrics "
          f"bit-equal to the one-process run's, a second run bit-equal "
          f"[{card}]")
    print(f"mesh: after {got['train/n_minibatches']:g} Adam steps the update "
          f"differs from the one-process run's by {divergence}; the "
          f"one-process run with every advantage one ulp up differs by "
          f"{control} [{card}]")
    print(f"mesh: the first minibatch of a full-width update "
          f"({MESH_UPDATE_STEPS} steps x {cfg.env.num_envs} envs) on the mesh: "
          f"summed gradients, BatchNorm stats and metrics within "
          f"tests/test_torch_mesh.py's tolerance of one process [{card}]")
    # (b): a rank a process; nccl refuses two on one card
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(2, "cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(4, "cpu")
    print(f"mesh: dryrun_multichip(2) on the card over gloo {card_s:.1f} s; "
          f"dryrun_multichip(4) on the CPU over gloo "
          f"{time.perf_counter() - t0:.1f} s (its tensor-parallel run needs "
          "DTensor's functional collectives, which crash over gloo on CUDA "
          f"tensors) [{card}]")
    return counts


# ---------------------------------------------------------------------------
# phase 15: the exact z-buffer path (renderer.zbuf_impl=scatter)


def _exact_zbuf_rollout(card: str, scenes) -> tuple[dict, dict]:
    """(a): reset + EXACT_CPU_STEPS steps driven step by step with exact
    launches and envs 0-1 held to the CPU, then the timed rollout."""
    cfg = flagship_config()
    cfg = dataclasses.replace(cfg, renderer=dataclasses.replace(
        cfg.renderer, zbuf_impl="scatter"))
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    policy.eval()
    counts = {}
    actions, _, keep, env, counts["exact_zbuf_steps"] = drive(
        card, "exact zbuf", cfg, scenes, policy, exact_zbuf_expect(1),
        EXACT_CPU_STEPS)
    t0 = time.perf_counter()
    gray = check_on_cpu("exact zbuf", cfg, scenes, actions, keep)
    print(f"exact zbuf: envs 0-{CPU_ENVS - 1} equal the port on the CPU over "
          f"reset + {EXACT_CPU_STEPS} steps, every output and state field bit "
          f"for bit but the grayscale frames "
          f"({'also bit for bit' if gray == 0 else f'max diff {gray:.3g}'}) "
          f"({time.perf_counter() - t0:.1f} s)")
    counts["exact_zbuf_rollout"], device_ms = timed_rollout(
        card, "exact zbuf rollout", env, policy,
        exact_zbuf_expect(1 + N_STEPS))
    return counts, device_ms


def _exact_zbuf_eval(card: str, scenes) -> tuple[dict, dict]:
    """(b): the 400x400 held-out eval (no init-view cache under scatter)."""
    cfg = eval_config("scatter")
    max_len = cfg.max_episode_length
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    run_eval(cfg, scenes, policy)                  # warm-up, not counted
    res, counts, secs = run_eval(cfg, scenes, policy)
    expect = exact_zbuf_expect(1 + max_len)
    if counts != expect:
        raise AssertionError(f"exact zbuf eval launched {counts}, expected "
                             f"{expect}")
    check_eval(res, max_len)
    print(f"exact zbuf eval: {cfg.num_envs} envs x (reset + {max_len} steps) "
          f"at {EVAL_HW}x{EVAL_HW} in {secs:.3f} s = "
          f"{cfg.num_envs * (1 + max_len) / secs:.1f} env-steps/s [{card}]; "
          f"mean reward {res.mean_reward:.4f}, AUC {res.mean_auc:.4f}, final "
          f"coverage {res.mean_final_coverage:.4f}, init coverage "
          f"{res.mean_init_coverage:.4f}")
    env = ReconEnv(cfg, scenes)
    device_us = profile(
        "exact zbuf eval, one evaluate call",
        lambda: evaluation.evaluate(env, policy, compute_accuracy=False), secs)
    return counts, _device_ms_per_call(device_us["kernels"], 1 + max_len)


def _exact_zbuf_training(card: str, root: str) -> dict:
    """(c): train_eval_gennbv.main on the flagship recipe under
    zbuf_impl=scatter for EXACT_ITERS iterations, an eval at 400x400 at the
    last."""
    log_dir = os.path.join(root, "exact_zbuf_runs")
    argv = ["--device", "cuda", "--log_dir", log_dir, "--exp_name",
            "exact_zbuf", *flagship_sets(
                "env.renderer.zbuf_impl=scatter",
                f"ppo.total_iters={EXACT_ITERS}",
                f"runner.eval_freq={EXACT_ITERS}",
                f"runner.save_freq={EXACT_ITERS}")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    train_eval_gennbv.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    (run,) = os.listdir(log_dir)
    run_dir = os.path.join(log_dir, run)
    with open(os.path.join(run_dir, "config.json")) as f:
        recorded = json.load(f)
    if (recorded["env"]["renderer"]["zbuf_impl"],
            recorded["runner"]["eval_camera"]) != ("scatter", EVAL_HW):
        raise AssertionError(f"exact zbuf training ran {recorded['env']}")
    # setup reset, 128 steps an iteration, one eval (reset + 30 steps)
    expect = trained(exact_zbuf_expect(
        1 + EXACT_ITERS * recorded["ppo"]["n_steps"] + 1
        + spec.MAX_EPISODE_LENGTH_EVAL))
    if counts != expect:
        raise AssertionError(f"exact zbuf training launched {counts}, "
                             f"expected {expect}")
    logged = read_logged(run_dir)
    assert [rec["step"] for rec in logged] == list(range(1, EXACT_ITERS + 1))
    for rec in logged:
        for k in _METRIC_KEYS:
            if not math.isfinite(rec[k]):
                raise AssertionError(f"exact zbuf training: non-finite {k}")
        print(f"exact zbuf training: iteration {rec['step']}"
              f"{' (warm-up)' if rec['step'] == 1 else ''}: "
              f"{rec['time/iter_seconds']:.3f} s = rollout "
              f"{rec['time/rollout']:.3f} + update {rec['time/update']:.3f} s; "
              f"{rec['time/fps']:.1f} env-steps/s [{card}]")
    cov = logged[-1]["eval/final_coverage"]
    if not 0 < cov <= 1:
        raise AssertionError(f"exact zbuf training: eval coverage {cov}")
    print(f"exact zbuf training: train_eval_gennbv, {EXACT_ITERS} flagship "
          f"iterations and a {EVAL_HW}x{EVAL_HW} eval (final coverage "
          f"{cov:.4f}) in {secs:.3f} s; peak memory {peak / 2 ** 30:.2f} GiB "
          f"[{card}]")
    return counts


# each form's line of gennbv_tpu_torch/tools/bench_scatter.py
BENCH_SCATTER_FORMS = (
    "zbuf: library scatter-min", "zbuf: count-matmul", "zbuf: hand kernel",
    "hits: library scatter-max", "hits: one-hot matmul",
    "carve: library gather", "carve: one-hot matmul gather",
    "vis: library gather", "vis: flat take")


def _exact_zbuf_tool(card: str) -> None:
    """(d): python -m gennbv_tpu_torch.tools.bench_scatter at its defaults
    in a process of its own: every form's line, and the kernel bit-equal
    to the library scatter-min."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m",
                          "gennbv_tpu_torch.tools.bench_scatter"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    for line in res.stdout.splitlines():
        print(f"  bench_scatter| {line}")
    if res.returncode != 0:
        raise AssertionError(f"bench_scatter exited {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    missing = [f for f in BENCH_SCATTER_FORMS
               if not re.search(rf"^{re.escape(f)}.* ms$", res.stdout, re.M)]
    if missing or "bit-equal True" not in res.stdout:
        raise AssertionError(f"bench_scatter: no line for {missing} or the "
                             "kernel is not exact")
    print(f"exact zbuf: tools/bench_scatter.py's port ran at its defaults in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")


def phase_exact_zbuf(card: str, scenes, eval_scenes,
                     root: str) -> tuple[dict, dict]:
    """Phase 15's parts in turn, each timed; returns each kernel's
    launches by run and the kernels' device ms a step of the rollout and
    of the eval."""
    secs, counts, device_ms = {}, {}, {}
    t0 = time.perf_counter()
    got, device_ms["rollout"] = _exact_zbuf_rollout(card, scenes)
    counts.update(got)
    secs["rollout"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts["exact_zbuf_eval"], device_ms["eval"] = _exact_zbuf_eval(
        card, eval_scenes)
    secs["eval"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts["exact_zbuf_train"] = _exact_zbuf_training(card, root)
    secs["training"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _exact_zbuf_tool(card)
    secs["tool"] = time.perf_counter() - t0
    print(f"phase 15: {sum(secs.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f") [{card}]")
    return counts, device_ms


def phase_cache_pairs(card: str, scenes, pairs: int) -> None:
    """The full-size eval with the init-view cache (zbuf_impl=pallas) and
    without it (mxu), the same kernels on both, in interleaved pairs."""
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    envs = {impl: ReconEnv(eval_config(impl), scenes) for impl in ("pallas", "mxu")}
    n_env_steps = spec.EVAL_NUM_ENVS * (1 + envs["pallas"].cfg.max_episode_length)
    for env in envs.values():                      # warm-up
        evaluation.evaluate(env, policy, compute_accuracy=False)
    rates = {impl: [] for impl in envs}
    for pair in range(pairs):
        for impl in (("pallas", "mxu") if pair % 2 == 0 else ("mxu", "pallas")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluation.evaluate(envs[impl], policy, compute_accuracy=False)
            rates[impl].append(n_env_steps / (time.perf_counter() - t0))
    for impl, r in rates.items():
        q = statistics.quantiles(r, n=4)
        print(f"cache A/B, {impl} ({'with' if impl == 'pallas' else 'without'} "
              f"the init-view cache): {pairs} runs, median "
              f"{statistics.median(r):.1f} env-steps/s, quartiles {q[0]:.1f} / "
              f"{q[2]:.1f} [{card}]: {', '.join(f'{x:.1f}' for x in r)}")
    wins = sum(p > m for p, m in zip(rates["pallas"], rates["mxu"]))
    print(f"cache A/B: with the cache faster in {wins} of {pairs} pairs")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cache-pairs", type=int, default=0,
                        help="run only this many interleaved pairs of the "
                        "eval with and without the init-view cache")
    args = parser.parse_args()
    card = phase_device()
    t_start = time.perf_counter()
    phase_build()
    eval_scenes = make_path_scenes(eval_config("pallas"), "held-out")
    if args.cache_pairs:
        phase_cache_pairs(card, eval_scenes, args.cache_pairs)
        return
    rollout_scenes = make_path_scenes(flagship_config(), "flagship")
    data_root = tempfile.mkdtemp(prefix="chip_smoke_dataset_")
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        dirs = phase_convert(data_root)
        dataset_scenes = {
            "dataset": (scene_lib.load_npz(
                os.path.join(dirs["train"], "scenes.npz")), HW),
            "dataset_held_out": (scene_lib.load_npz(
                os.path.join(dirs["held_out"], "scenes.npz")), EVAL_HW)}
        timing, floor = phase_kernels(eval_scenes, rollout_scenes,
                                      dataset_scenes)
        del dataset_scenes
        phase_golden()
        rollout_counts, rollout_ms = phase_rollout(card, rollout_scenes)
        eval_counts, eval_ms = phase_eval(card, eval_scenes)
        train_counts = phase_train(card, rollout_scenes, eval_scenes, run_dir)
        train400_counts = train400(card, rollout_scenes,
                                   os.path.join(run_dir, "train400"))
        report_counts, report_pieces = phase_report(card, run_dir)
        dda_counts = phase_dda(card, rollout_scenes)
        dataset_counts = phase_dataset(card, dirs, data_root)
        rsl_counts = phase_rsl(card)
        p12_counts = phase_12(card)
        p13_counts = phase_13(card)
        t0 = time.perf_counter()
        mesh_counts = phase_mesh(card, rollout_scenes)
        print(f"phase 14: {time.perf_counter() - t0:.1f} s [{card}]")
        exact_counts, exact_ms = phase_exact_zbuf(card, rollout_scenes,
                                                  eval_scenes, data_root)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        shutil.rmtree(data_root, ignore_errors=True)
    by_path = {"rollout": rollout_counts, "eval": eval_counts,
               "train": train_counts, "train400": train400_counts,
               "report": report_counts, **dda_counts,
               **dataset_counts, "rsl": rsl_counts, **p12_counts,
               **p13_counts, "mesh": mesh_counts, **exact_counts}
    # each kernel's device time a call, profiled on the path that runs it;
    # none where neither path does
    for name in KERNELS:
        if not eval_counts[name]:
            for ms, exact in ((eval_ms, exact_ms["eval"]),
                              (rollout_ms, exact_ms["rollout"])):
                ms.pop(name, None)
                if name in exact:
                    ms[name] = exact[name]
    # the dedupe runs in the report alone: its times, and its device time a
    # call (its two kernels, the sort and the copies), are phase 8's
    timing["dedupe_cm"]["eval"] = report_pieces["dedupe_cm"]
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            # times at the eval's shapes; the rollout's beside them (the
            # weight gradient's at the update's, among the paths below)
            **timing[name].get("eval", {}), **floor,
            # the profiler's device time per call in each path's run
            **({"device_ms": eval_ms[name]} if name in eval_ms else {}),
            "rollout": {**timing[name].get("rollout", {}),
                        **({"device_ms": rollout_ms[name]}
                           if name in rollout_ms else {})},
            # phase 3 at the DDA step's and the converted scenes' shapes
            **{path: t for path, t in timing[name].items()
               if path not in ("eval", "rollout")}})
    print(f"profiler: at most {PADS_LOST['leading']} leading and "
          f"{PADS_LOST['trailing']} trailing of the {PROFILE_PADS} pads on "
          "each side of a profiled run lost")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the device "
          "check")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
