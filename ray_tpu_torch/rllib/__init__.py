"""ray_tpu_torch.rllib — reinforcement learning on the actor runtime
(counterpart of ``ray_tpu.rllib``).

Analogue of RLlib's core loop (reference: rllib/ — Algorithm/
AlgorithmConfig, EnvRunnerGroup of rollout actors, Learner with the PPO
clipped-surrogate loss): PPO, IMPALA, DQN, SAC and multi-agent PPO with
parallel env-runner actors (numpy, on the CPU) and PyTorch learners on the
driver's CUDA card (``device=None``; ``.training(device="cpu")`` keeps
them on the CPU).

    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.env import CartPole

    algo = (PPOConfig().environment(CartPole)
            .env_runners(4, rollout_fragment_length=512).build())
    for _ in range(20):
        print(algo.train()["episode_return_mean"])

The names load on first use: an env runner, which imports
``ray_tpu_torch.rllib.env_runner``, loads no torch.
"""

import importlib

_NAMES = {
    "DQN": "dqn", "DQNConfig": "dqn",
    "CartPole": "env", "ContinuousEnv": "env", "CooperativeMatch": "env",
    "Env": "env", "MultiAgentEnv": "env", "Pendulum": "env",
    "IMPALA": "impala", "IMPALAConfig": "impala",
    "DQNLearner": "learner", "IMPALALearner": "learner",
    "PPOLearner": "learner", "SACLearner": "learner",
    "MultiAgentEnvRunner": "multi_agent", "MultiAgentPPO": "multi_agent",
    "MultiAgentPPOConfig": "multi_agent",
    "PPO": "ppo", "PPOConfig": "ppo",
    "PrioritizedReplayBuffer": "replay", "ReplayBuffer": "replay",
    "SAC": "sac", "SACConfig": "sac",
}


def __getattr__(name):
    module = _NAMES.get(name)
    if module is None:
        raise AttributeError(name)
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


__all__ = sorted(_NAMES)
