"""Train every algorithm family on a custom functional env (port of
``examples/02_custom_env_families.py``).

    python -m gennbv_tpu_torch.examples.custom_env_families [--device cuda|cpu]

Shows the env protocol (reset/step tuples; see utils/env_checker.py) and
one-liner training with PPO (adaptive-KL, rsl_rl-style), A2C, SAC, DQN,
recurrent PPO and HER (TD3 and DDPG share SAC's runner), at the JAX
example's sizes, printing its lines.  Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from gennbv_tpu_torch.algo import ppo_continuous as ppoc
from gennbv_tpu_torch.algo.dqn import DQNConfig, DQNRunner
from gennbv_tpu_torch.algo.her import HERConfig, HERRunner
from gennbv_tpu_torch.algo.off_policy import OffPolicyConfig, OffPolicyRunner
from gennbv_tpu_torch.algo.on_policy_runner import (OnPolicyRunner,
                                                    OnPolicyRunnerConfig)
from gennbv_tpu_torch.algo.ppo_recurrent import RecurrentOnPolicyRunner
from gennbv_tpu_torch.env.synthetic import (GoalPointEnv,
                                            IdentityEnvMultiDiscrete,
                                            PointGoalEnv)
from gennbv_tpu_torch.utils.env_checker import check_env


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the families in turn; returns what each printed, by name."""
    device = parse_args(argv).device
    out = {}

    env = PointGoalEnv(dim=2, ep_length=16, device=device)
    check_env(env)  # validate the functional contract first

    # --- on-policy (rsl_rl family): PPO with adaptive-KL learning rate
    ppo = OnPolicyRunner(env, ppoc.ContinuousPPOConfig(learning_rate=1e-3),
                         OnPolicyRunnerConfig(num_steps_per_env=16),
                         num_envs=32, seed=0, actor_hidden=(32, 32),
                         critic_hidden=(32, 32))
    out["ppo"] = ppo.learn(5)
    print("ppo:", out["ppo"])

    # --- A2C is the degenerate PPO (TF-style RMSprop)
    a2c = OnPolicyRunner(env, ppoc.a2c_config(),
                         OnPolicyRunnerConfig(num_steps_per_env=5), num_envs=32,
                         seed=0, actor_hidden=(32, 32), critic_hidden=(32, 32))
    out["a2c"] = a2c.learn(20)
    print("a2c:", out["a2c"])

    # --- off-policy: SAC / TD3 / DDPG share one runner
    sac = OffPolicyRunner(env, OffPolicyConfig(algo="sac", learning_starts=256,
                                               buffer_capacity=4096),
                          num_envs=16, seed=0)
    out["sac"] = sac.learn(200, chunk=50)
    print("sac mean reward:", out["sac"])

    # --- DQN on a discrete task
    dqn = DQNRunner(IdentityEnvMultiDiscrete(nvec=(4,), ep_length=8,
                                             device=device),
                    DQNConfig(learning_starts=128, buffer_capacity=2048),
                    num_envs=16, seed=0)
    out["dqn"] = dqn.learn(300, chunk=100)
    print("dqn mean reward:", out["dqn"])

    # --- recurrent PPO (LSTM, BPTT) for memory tasks
    rec = RecurrentOnPolicyRunner(env, ppoc.ContinuousPPOConfig(),
                                  num_steps_per_env=8, num_envs=16, seed=0,
                                  rnn_hidden=16, actor_hidden=(16,),
                                  critic_hidden=(16,))
    out["recurrent ppo"] = rec.learn(3)
    print("recurrent ppo:", out["recurrent ppo"])

    # --- HER for sparse goal-conditioned tasks
    her = HERRunner(GoalPointEnv(dim=2, ep_length=8, device=device),
                    OffPolicyConfig(algo="sac", learning_starts=512,
                                    buffer_capacity=8192),
                    HERConfig(future_fraction=0.8), num_envs=16,
                    capacity_episodes=512, seed=0)
    her.learn(10)
    out["her"] = her.buffer.size
    print("her: trained", out["her"], "episodes buffered")
    return out


if __name__ == "__main__":
    main()
