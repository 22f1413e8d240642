"""IMPALA — asynchronous actor-critic with V-trace correction (counterpart
of ``ray_tpu/rllib/impala.py``).

Analogue of the reference's IMPALA (reference:
rllib/algorithms/impala/impala.py:599 training_step — async sample
queue, learner thread, V-trace). Redesign for this runtime: every env
runner always has a sample_fragment call IN FLIGHT; the learner waits
for whichever finishes first, stacks fragments into a [B, T] batch, and
V-trace corrects the staleness. A runner is re-armed with the CURRENT
weights the moment its fragment is consumed — rollout collection never
blocks on the learner and vice versa (the in-flight refs are the queue).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import cloudpickle
import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import IMPALALearner


@dataclass
class IMPALAConfig:
    """Builder-style config (reference: IMPALAConfig)."""

    env_maker: Optional[Callable[[], Any]] = None
    num_env_runners: int = 2
    rollout_fragment_length: int = 64
    train_batch_fragments: int = 4     # fragments stacked per update
    updates_per_iteration: int = 8
    gamma: float = 0.99
    lr: float = 5e-4
    entropy_coeff: float = 0.01
    vf_loss_coeff: float = 0.5
    vtrace_rho_bar: float = 1.0
    vtrace_c_bar: float = 1.0
    hidden: tuple = (64, 64)
    seed: int = 0
    # The learner's device: None is the CUDA card (raises without one)
    device: Optional[str] = None

    def environment(self, env_maker: Callable[[], Any]) -> "IMPALAConfig":
        self.env_maker = env_maker
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "IMPALAConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "IMPALAConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown IMPALA option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALA:
    """The algorithm: async rollout pipeline + V-trace learner."""

    def __init__(self, config: IMPALAConfig):
        assert config.env_maker is not None, "config.environment(...) first"
        self.config = config
        probe = config.env_maker()
        self._learner = IMPALALearner(
            probe.observation_size, probe.num_actions,
            hidden=tuple(config.hidden), lr=config.lr,
            gamma=config.gamma, vf_coeff=config.vf_loss_coeff,
            entropy_coeff=config.entropy_coeff,
            rho_bar=config.vtrace_rho_bar, c_bar=config.vtrace_c_bar,
            seed=config.seed, device=config.device)
        maker_blob = cloudpickle.dumps(config.env_maker)
        runner_cls = ray_tpu_torch.remote(EnvRunner)
        self._runners = [
            runner_cls.remote(maker_blob, seed=config.seed + 1000 * (i + 1))
            for i in range(config.num_env_runners)]
        weights = self._learner.get_weights()
        ray_tpu_torch.get([r.set_weights.remote(weights)
                     for r in self._runners], timeout=300)
        # Arm the pipeline: one fragment perpetually in flight per runner.
        self._inflight: Dict[Any, Any] = {
            r.sample_fragment.remote(config.rollout_fragment_length): r
            for r in self._runners}
        self.iteration = 0
        self._recent_returns: List[float] = []

    def _next_fragments(self, n: int) -> List[Dict[str, np.ndarray]]:
        """Consume the n first-finished fragments; re-arm each producer
        with the freshest weights immediately."""
        out = []
        weights = self._learner.get_weights()  # one D2H copy per batch
        while len(out) < n:
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                    timeout=600)
            if not ready:
                raise TimeoutError("env runners produced no fragments")
            ref = ready[0]
            runner = self._inflight.pop(ref)
            out.append(ray_tpu_torch.get(ref))
            runner.set_weights.remote(weights)
            self._inflight[runner.sample_fragment.remote(
                self.config.rollout_fragment_length)] = runner
        return out

    def train(self) -> Dict[str, Any]:
        """One iteration = updates_per_iteration V-trace updates."""
        t0 = time.monotonic()
        cfg = self.config
        env_steps = 0
        episodes = 0
        losses: Dict[str, float] = {}
        learner_s = 0.0
        for _ in range(cfg.updates_per_iteration):
            frags = self._next_fragments(cfg.train_batch_fragments)
            for f in frags:
                finished = f.pop("episode_returns").tolist()
                self._recent_returns.extend(finished)
                episodes += len(finished)
            batch = {k: np.stack([f[k] for f in frags])
                     for k in frags[0]}
            env_steps += batch["obs"].shape[0] * batch["obs"].shape[1]
            t_learn = time.monotonic()
            losses = self._learner.update(batch)
            learner_s += time.monotonic() - t_learn
        self.iteration += 1
        self._recent_returns = self._recent_returns[-100:]
        mean_return = (float(np.mean(self._recent_returns))
                       if self._recent_returns else 0.0)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_return,
            "episodes_this_iter": episodes,
            "env_steps_this_iter": env_steps,
            "time_this_iter_s": time.monotonic() - t0,
            "learner_time_this_iter_s": learner_s,
            "learner_updates_this_iter": cfg.updates_per_iteration,
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
            algo = IMPALA(cfg)
            try:
                for _ in range(num_iterations):
                    tune.report(algo.train())
            finally:
                algo.stop()

        return trainable
