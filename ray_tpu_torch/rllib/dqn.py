"""DQN — off-policy Q-learning with prioritized replay (counterpart of
``ray_tpu/rllib/dqn.py``).

Analogue of the reference's DQN (reference: rllib/algorithms/dqn/dqn.py
training_step — env runners feed a (prioritized) replay buffer, the
learner samples batches, TD errors write back as priorities, the target
net syncs on a cadence). Redesign for this runtime: the same always-in-
flight rollout pipeline as IMPALA (the in-flight refs ARE the sample
queue), with epsilon-greedy collection annealed by total env steps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import cloudpickle
import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import DQNLearner
from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer, ReplayBuffer


@dataclass
class DQNConfig:
    """Builder-style config (reference: DQNConfig)."""

    env_maker: Optional[Callable[[], Any]] = None
    num_env_runners: int = 2
    rollout_fragment_length: int = 64
    buffer_capacity: int = 50_000
    prioritized_replay: bool = True
    replay_alpha: float = 0.6
    replay_beta: float = 0.4
    train_batch_size: int = 64
    updates_per_iteration: int = 32
    fragments_per_iteration: int = 4
    learning_starts: int = 500         # env steps before the first update
    target_update_freq: int = 100      # updates between target syncs
    gamma: float = 0.99
    lr: float = 1e-3
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_anneal_steps: int = 4_000
    hidden: tuple = (64, 64)
    seed: int = 0
    # The learner's device: None is the CUDA card (raises without one)
    device: Optional[str] = None

    def environment(self, env_maker: Callable[[], Any]) -> "DQNConfig":
        self.env_maker = env_maker
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "DQNConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "DQNConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown DQN option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "DQN":
        return DQN(self)


class DQN:
    """The algorithm: epsilon-greedy collection -> replay -> double-DQN
    updates with priority write-back."""

    def __init__(self, config: DQNConfig):
        assert config.env_maker is not None, "config.environment(...) first"
        self.config = config
        probe = config.env_maker()
        self._learner = DQNLearner(
            probe.observation_size, probe.num_actions,
            hidden=tuple(config.hidden), lr=config.lr,
            gamma=config.gamma, seed=config.seed, device=config.device)
        if config.prioritized_replay:
            self._buffer: ReplayBuffer = PrioritizedReplayBuffer(
                config.buffer_capacity, alpha=config.replay_alpha,
                beta=config.replay_beta, seed=config.seed)
        else:
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
        # Arm the pipeline: one fragment perpetually in flight per runner.
        self._inflight: Dict[Any, Any] = {
            r.sample_transitions.remote(config.rollout_fragment_length,
                                        self._epsilon()): r
            for r in self._runners}

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.total_env_steps
                   / max(1, cfg.epsilon_anneal_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def _collect(self, n: int) -> int:
        """Consume n first-finished fragments into the replay buffer;
        re-arm each producer with fresh weights + the annealed epsilon."""
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
            self._inflight[runner.sample_transitions.remote(
                self.config.rollout_fragment_length,
                self._epsilon())] = runner
        return steps

    def train(self) -> Dict[str, Any]:
        """One iteration = collect fragments_per_iteration rollouts +
        updates_per_iteration replay updates (after learning_starts)."""
        t0 = time.monotonic()
        cfg = self.config
        env_steps = self._collect(cfg.fragments_per_iteration)
        losses: Dict[str, float] = {}
        updates = 0
        learner_s = 0.0
        if len(self._buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iteration):
                batch = self._buffer.sample(cfg.train_batch_size)
                indices = batch.get("indices")
                t_learn = time.monotonic()
                losses, td_abs = self._learner.update(batch)
                learner_s += time.monotonic() - t_learn
                if indices is not None and isinstance(
                        self._buffer, PrioritizedReplayBuffer):
                    self._buffer.update_priorities(indices, td_abs)
                self.total_updates += 1
                updates += 1
                if self.total_updates % cfg.target_update_freq == 0:
                    self._learner.sync_target()
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
            "epsilon": self._epsilon(),
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
            algo = DQN(cfg)
            try:
                for _ in range(num_iterations):
                    tune.report(algo.train())
            finally:
                algo.stop()

        return trainable
