"""Frozen interface contract of the GenNBV task.

Every constant here mirrors the reference implementation so that observation
layout, action decoding, reward semantics and termination thresholds are
reproduced exactly.  Citations are to files under the reference repo
(zjwzcx/GenNBV):

- action tables:        gennbv/env/config_gennbv_train.py:51-69
- obs layout + order:   gennbv/wrapper/env_wrapper_gennbv_train.py:104,110
                        gennbv/env/env_train_gennbv.py:359-366
- camera model:         gennbv/env/env_train_base.py:787-803 (intrinsics),
                        config_gennbv_train.py:23-35 (400x400, FOV 90)
- grids:                gennbv/env/env_train_gennbv.py:184-191 (G=20)
- reward scales (x dt): config_gennbv_train.py:13-18, drone_robot.py:874-884
- termination:          env_train_gennbv.py:438-457 (collision | timeout |
                        coverage > 0.99)
"""
from __future__ import annotations

import math

PI = math.pi

# ---------------------------------------------------------------------------
# Action space: MultiDiscrete over 6 pose components (x, y, z, roll, pitch, yaw)
# pose = action_index * ACTION_UNIT + CLIP_POSE_LOW          (env_train_base.py:665)
# ---------------------------------------------------------------------------
ACTION_DIM = 6
# number of choices per component  (clip_pose_idx_up - clip_pose_idx_low + 1)
NVEC = (81, 81, 51, 1, 13, 13)
NUM_LOGITS = sum(NVEC)  # 240
CLIP_POSE_IDX_LOW = (0, 0, 0, 0, 0, 0)
CLIP_POSE_IDX_UP = (80, 80, 50, 0, 12, 12)
CLIP_POSE_LOW = (-8.0, -8.0, 0.1, 0.0, -0.5 * PI, 0.0)
ACTION_UNIT = (0.2, 0.2, 0.2, 0.0, PI / 12.0, PI / 6.0)
# initial discrete action forced on freshly reset envs (config_gennbv_train.py:68)
INIT_ACTION = (40, 40, 50, 0, 12, 0)
# pose value used to fill the pose history buffer at reset (config :67)
INIT_POSE_BUF = (0.0, 0.0, 10.1, 0.0, 0.5 * PI, 0.0)

# ---------------------------------------------------------------------------
# Observation layout.  Flat obs = concat([state, grid, state_rgb], axis=-1)
# in this exact key order (env_wrapper_gennbv_train.py:104).
# ---------------------------------------------------------------------------
POSE_BUF_LEN = 100          # visual_input.stack (config :28)
GRID_SIZE = 20              # G; prob/tri-class/scanned grids are [G, G, G]
RGB_K = 2                   # grayscale frame history length (env_train_gennbv.py:195)
RGB_H = 64
RGB_W = 64

STATE_DIM = POSE_BUF_LEN * ACTION_DIM            # 600
GRID_DIM = GRID_SIZE ** 3                        # 8000
RGB_DIM = RGB_K * RGB_H * RGB_W                  # 8192
OBS_DIM = STATE_DIM + GRID_DIM + RGB_DIM         # 16792

# ---------------------------------------------------------------------------
# Camera model (config_gennbv_train.py:23-35, env_train_base.py:787-803)
# ---------------------------------------------------------------------------
CAMERA_WIDTH = 400
CAMERA_HEIGHT = 400
HORIZONTAL_FOV_DEG = 90.0
# camera is mounted 0.1 m above the drone body (env_train_base.py:366)
CAMERA_Z_OFFSET = 0.1
# depth post-processing: nan->0, clamp(min=-50), abs  (env_train_base.py:522-525)
DEPTH_MAX = 50.0
# foreground = segmentation id > 50; object id is 255, ground plane 0
OBJECT_SEGMENTATION_ID = 255
PLANE_SEGMENTATION_ID = 0
FG_SEG_THRESHOLD = 50

# ---------------------------------------------------------------------------
# Mapping update (env_train_gennbv.py:277-326, gennbv/utils.py:309-325)
# ---------------------------------------------------------------------------
CARVE_DELTA = 0.05          # free-space carving decrement per step
OCCUPIED_VALUE = 1.0        # occupied voxels overwrite to 1.0 (write wins)
TRI_CLS_THRESHOLD_OCC = 0.5
TRI_CLS_THRESHOLD_FREE = 0.0
BRESENHAM_MAX_PTS_FACTOR = 3  # max_pts_per_ray = 3 * map_size (utils.py:37)

# ---------------------------------------------------------------------------
# Rewards.  Scales are multiplied by dt at prep time (drone_robot.py:874-884);
# dt = sim_dt(0.005) * decimation(4) = 0.02.  Effective per-step scales:
#   surface_coverage: 1000 * 0.02 = 20
#   short_path:          5 * 0.02 = 0.1
#   termination:        50 * 0.02 = 1.0
# only_positive_rewards clips the pre-termination sum at 0 (config :20,
# drone_robot compute_reward at env_train_base.py:377-398).
# ---------------------------------------------------------------------------
DT = 0.02
EPISODE_LENGTH_S = 20.0
REWARD_SCALE_SURFACE_COVERAGE = 1000.0 * DT
REWARD_SCALE_SHORT_PATH = 5.0 * DT
REWARD_SCALE_TERMINATION = 50.0 * DT
ONLY_POSITIVE_REWARDS = True
SHORT_PATH_FREE_STEPS = 30   # -clip(len - 30, 0, 2) (env_train_gennbv.py:541-545)
SHORT_PATH_MAX_EXTRA = 2

# ---------------------------------------------------------------------------
# Termination (env_train_gennbv.py:438-457)
# ---------------------------------------------------------------------------
MAX_EPISODE_LENGTH_TRAIN = 100
MAX_EPISODE_LENGTH_EVAL = 30
COVERAGE_DONE_THRESHOLD_TRAIN = 0.99
# the eval env drops the coverage-threshold condition (env_eval_gennbv.py:338-351)

# ---------------------------------------------------------------------------
# PPO hyper-parameters (gennbv/train/train_gennbv.py:149-198)
# ---------------------------------------------------------------------------
PPO_NUM_ENVS = 256
PPO_N_STEPS = 128
PPO_BATCH_SIZE = 128
PPO_N_EPOCHS = 5
PPO_LR = 1e-4
PPO_GAMMA = 0.99
PPO_GAE_LAMBDA = 0.95
PPO_CLIP_RANGE = 0.2
PPO_CLIP_RANGE_VF = 0.2
PPO_VF_COEF = 0.8
PPO_ENT_COEF = 0.01
PPO_TARGET_KL = 0.05
PPO_MAX_GRAD_NORM = 1.0
PPO_TOTAL_ITERS = 1000
# the reference multiplies the policy-gradient term by 10 (ppo_grid_obs.py:253)
PPO_POLICY_LOSS_MULT = 10.0
PPO_ADAM_EPS = 1e-5

# Eval harness (evaluation.py:199-202, train_eval_gennbv.py:156-164)
EVAL_NUM_ENVS = 50
EVAL_MAX_LENGTH = 30
EVAL_N_EPISODES = 50
