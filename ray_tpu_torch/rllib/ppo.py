"""PPO Algorithm + AlgorithmConfig — the training driver (counterpart of
``ray_tpu/rllib/ppo.py``).

Analogue of the reference's algorithm layer (reference:
rllib/algorithms/algorithm.py Algorithm:207 + algorithm_config.py builder,
ppo/ppo.py training_step:388: sync weights -> parallel rollouts via the
EnvRunnerGroup -> learner update). The learner's update runs on the
driver's CUDA card (``config.device``; ``"cpu"`` in the tests); env runners
are CPU actors.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import cloudpickle
import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import PPOLearner


@dataclass
class PPOConfig:
    """Builder-style config (reference: AlgorithmConfig)."""

    env_maker: Optional[Callable[[], Any]] = None
    num_env_runners: int = 2
    rollout_fragment_length: int = 512
    gamma: float = 0.99
    gae_lambda: float = 0.95
    lr: float = 3e-4
    clip_param: float = 0.2
    num_epochs: int = 4
    minibatch_size: int = 128
    entropy_coeff: float = 0.01
    vf_loss_coeff: float = 0.5
    hidden: tuple = (64, 64)
    seed: int = 0
    # The learner's device: None is the CUDA card (raises without one)
    device: Optional[str] = None

    def environment(self, env_maker: Callable[[], Any]) -> "PPOConfig":
        self.env_maker = env_maker
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "PPOConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "PPOConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown PPO option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "PPO":
        return PPO(self)


class PPO:
    """The algorithm: owns the learner + env-runner actor group."""

    def __init__(self, config: PPOConfig):
        assert config.env_maker is not None, "config.environment(...) first"
        self.config = config
        probe = config.env_maker()
        self._learner = PPOLearner(
            probe.observation_size, probe.num_actions,
            hidden=tuple(config.hidden), lr=config.lr,
            clip=config.clip_param, vf_coeff=config.vf_loss_coeff,
            entropy_coeff=config.entropy_coeff, seed=config.seed,
            device=config.device)
        maker_blob = cloudpickle.dumps(config.env_maker)
        runner_cls = ray_tpu_torch.remote(EnvRunner)
        self._runners = [
            runner_cls.remote(maker_blob, seed=config.seed + 1000 * (i + 1))
            for i in range(config.num_env_runners)]
        self.iteration = 0
        self._recent_returns: List[float] = []

    def train(self) -> Dict[str, Any]:
        """One training iteration (reference: ppo.py training_step)."""
        t0 = time.monotonic()
        cfg = self.config
        weights = self._learner.get_weights()
        ray_tpu_torch.get([r.set_weights.remote(weights)
                     for r in self._runners], timeout=300)
        batches = ray_tpu_torch.get([
            r.sample.remote(cfg.rollout_fragment_length, cfg.gamma,
                            cfg.gae_lambda)
            for r in self._runners], timeout=600)
        episode_returns = np.concatenate(
            [b.pop("episode_returns") for b in batches])
        batch = {k: np.concatenate([b[k] for b in batches])
                 for k in batches[0]}
        t_learn = time.monotonic()
        losses = self._learner.update_minibatches(
            batch, num_epochs=cfg.num_epochs,
            minibatch_size=cfg.minibatch_size)
        learner_s = time.monotonic() - t_learn
        self.iteration += 1
        self._recent_returns.extend(episode_returns.tolist())
        self._recent_returns = self._recent_returns[-100:]
        mean_return = (float(np.mean(self._recent_returns))
                       if self._recent_returns else 0.0)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_return,
            "episodes_this_iter": int(len(episode_returns)),
            "env_steps_this_iter": int(len(batch["obs"])),
            "time_this_iter_s": time.monotonic() - t0,
            "learner_time_this_iter_s": learner_s,
            "learner_updates_this_iter": cfg.num_epochs * max(
                1, len(batch["obs"]) // cfg.minibatch_size),
            **losses,
        }

    def get_weights(self):
        return self._learner.get_weights()

    def stop(self) -> None:
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass

    def as_trainable(self, num_iterations: int) -> Callable[[dict], None]:
        """Adapter for ray_tpu_torch.tune (reference: Algorithm as
        Trainable): each trial builds the algorithm from this config with
        its overrides and reports every iteration's result."""
        config = self.config

        def trainable(overrides: dict):
            import dataclasses

            from ray_tpu_torch import tune
            cfg = dataclasses.replace(config, **overrides)
            algo = PPO(cfg)
            try:
                for _ in range(num_iterations):
                    tune.report(algo.train())
            finally:
                algo.stop()

        return trainable
