"""SAC — off-policy soft actor-critic for continuous control (counterpart of
``ray_tpu/rllib/sac.py``).

Analogue of the reference's SAC (reference: rllib/algorithms/sac/sac.py
training_step — env runners feed a replay buffer; the learner performs
twin-Q + squashed-Gaussian policy + temperature updates with polyak
target sync). Same always-in-flight rollout pipeline as DQN/IMPALA; the
SAC update runs on the driver's CUDA card (``config.device``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import cloudpickle
import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import SACLearner
from ray_tpu_torch.rllib.replay import ReplayBuffer


@dataclass
class SACConfig:
    """Builder-style config (reference: SACConfig)."""

    env_maker: Optional[Callable[[], Any]] = None
    num_env_runners: int = 2
    rollout_fragment_length: int = 200
    buffer_capacity: int = 100_000
    train_batch_size: int = 128
    updates_per_iteration: int = 64
    fragments_per_iteration: int = 2
    learning_starts: int = 500
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    init_alpha: float = 0.1
    hidden: tuple = (64, 64)
    seed: int = 0
    # The learner's device: None is the CUDA card (raises without one)
    device: Optional[str] = None

    def environment(self, env_maker: Callable[[], Any]) -> "SACConfig":
        self.env_maker = env_maker
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "SACConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "SACConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown SAC option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "SAC":
        return SAC(self)


class SAC:
    """Collection -> replay -> twin-Q soft updates."""

    def __init__(self, config: SACConfig):
        assert config.env_maker is not None, "config.environment(...) first"
        self.config = config
        probe = config.env_maker()
        self._learner = SACLearner(
            probe.observation_size, probe.action_size,
            action_scale=(float(probe.action_high)
                          - float(probe.action_low)) / 2.0,
            action_shift=(float(probe.action_high)
                          + float(probe.action_low)) / 2.0,
            hidden=tuple(config.hidden), lr=config.lr,
            gamma=config.gamma, tau=config.tau,
            init_alpha=config.init_alpha, seed=config.seed,
            device=config.device)
        self._buffer = ReplayBuffer(config.buffer_capacity,
                                    seed=config.seed)
        maker_blob = cloudpickle.dumps(config.env_maker)
        runner_cls = ray_tpu_torch.remote(EnvRunner)
        self._runners = [
            runner_cls.remote(maker_blob, seed=config.seed + 1000 * (i + 1))
            for i in range(config.num_env_runners)]
        weights = self._learner.get_weights()
        ray_tpu_torch.get([r.set_weights.remote(weights)
                     for r in self._runners], timeout=300)
        self.total_env_steps = 0
        self.total_updates = 0
        self.iteration = 0
        self._recent_returns: List[float] = []
        self._inflight: Dict[Any, Any] = {
            r.sample_continuous.remote(config.rollout_fragment_length): r
            for r in self._runners}

    def _collect(self, n: int) -> int:
        steps = 0
        weights = self._learner.get_weights()
        for _ in range(n):
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                    timeout=600)
            if not ready:
                raise TimeoutError("env runners produced no fragments")
            ref = ready[0]
            runner = self._inflight.pop(ref)
            frag = ray_tpu_torch.get(ref)
            self._recent_returns.extend(
                frag.pop("episode_returns").tolist())
            n_rows = len(frag["obs"])
            steps += n_rows
            self.total_env_steps += n_rows
            self._buffer.add(frag)
            runner.set_weights.remote(weights)
            self._inflight[runner.sample_continuous.remote(
                self.config.rollout_fragment_length)] = runner
        return steps

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        cfg = self.config
        env_steps = self._collect(cfg.fragments_per_iteration)
        losses: Dict[str, float] = {}
        updates = 0
        learner_s = 0.0
        if len(self._buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iteration):
                batch = self._buffer.sample(cfg.train_batch_size)
                batch.pop("indices", None)
                t_learn = time.monotonic()
                losses = self._learner.update(batch)
                learner_s += time.monotonic() - t_learn
                self.total_updates += 1
                updates += 1
        self.iteration += 1
        self._recent_returns = self._recent_returns[-100:]
        mean_return = (float(np.mean(self._recent_returns))
                       if self._recent_returns else 0.0)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_return,
            "env_steps_this_iter": env_steps,
            "updates_this_iter": updates,
            "total_env_steps": self.total_env_steps,
            "buffer_size": len(self._buffer),
            "time_this_iter_s": time.monotonic() - t0,
            "learner_time_this_iter_s": learner_s,
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
            algo = SAC(cfg)
            try:
                for _ in range(num_iterations):
                    tune.report(algo.train())
            finally:
                algo.stop()

        return trainable
