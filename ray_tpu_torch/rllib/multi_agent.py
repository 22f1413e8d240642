"""Multi-agent training: env runner mapping agents to policies + a
per-policy PPO trainer (counterpart of ``ray_tpu/rllib/multi_agent.py``).

Analogue of the reference's multi-agent stack (reference:
rllib/env/multi_agent_env_runner.py — one env, many agents, a
policy_mapping_fn routing each agent to a module; multi_agent_episode
bookkeeping; algorithms train one RLModule per policy id). Each runner
steps ALL agents simultaneously, slices the stream into per-policy PPO
batches (GAE computed per agent stream), and the driver updates one
PPOLearner per policy on its CUDA card (``config.device``). The runner
imports no torch: the learner is imported where the algorithm builds it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import cloudpickle
import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import _log_softmax, _np_forward


class MultiAgentEnvRunner:
    """Steps one MultiAgentEnv with per-policy weights; emits per-policy
    PPO batches (obs/actions/logp_old/advantages/returns)."""

    def __init__(self, env_maker_blob: bytes, mapping_blob: bytes,
                 seed: int = 0):
        self._env = cloudpickle.loads(env_maker_blob)()
        self._map: Callable[[str], str] = cloudpickle.loads(mapping_blob)
        self._rng = np.random.RandomState(seed)
        self._weights: Dict[str, Any] = {}   # policy_id -> params
        self._obs = self._env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed: List[float] = []

    def set_weights(self, weights: Dict[str, Any]) -> bool:
        self._weights = weights
        return True

    def _act(self, agent: str, obs: np.ndarray) -> tuple:
        w = self._weights[self._map(agent)]
        logp = _log_softmax(_np_forward(w["pi"], obs[None, :]))[0]
        action = int(self._rng.choice(len(logp), p=np.exp(logp)))
        return action, float(logp[action])

    def sample(self, num_steps: int, gamma: float = 0.99,
               gae_lambda: float = 0.95) -> Dict[str, Dict[str, Any]]:
        """num_steps ENV steps -> {policy_id: ppo_batch}. Every agent
        stream contributes to its policy's batch; episode boundaries
        ("__all__") cut the GAE recursion."""
        env = self._env
        agents = list(env.agent_ids)
        traj = {a: {"obs": [], "actions": [], "logp": [], "rewards": [],
                    "dones": []} for a in agents}
        obs = self._obs
        for _ in range(num_steps):
            acts, logps = {}, {}
            for a in agents:
                acts[a], logps[a] = self._act(a, obs[a])
            nxt, rews, terms, truncs, _ = env.step(acts)
            done = bool(terms.get("__all__") or truncs.get("__all__"))
            for a in agents:
                t = traj[a]
                t["obs"].append(obs[a])
                t["actions"].append(acts[a])
                t["logp"].append(logps[a])
                t["rewards"].append(rews.get(a, 0.0))
                t["dones"].append(float(done))
            self._episode_return += float(np.mean(
                [rews.get(a, 0.0) for a in agents]))
            if done:
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                obs = env.reset(seed=int(self._rng.randint(0, 2 ** 31)))
            else:
                obs = nxt
        self._obs = obs

        out: Dict[str, Dict[str, Any]] = {}
        for a in agents:
            pid = self._map(a)
            t = traj[a]
            obs_a = np.asarray(t["obs"], np.float32)
            rew_a = np.asarray(t["rewards"], np.float32)
            done_a = np.asarray(t["dones"], np.float32)
            w = self._weights[pid]
            values = _np_forward(w["vf"], obs_a)[:, 0]
            v_boot = float(_np_forward(
                w["vf"], obs[a][None, :].astype(np.float32))[0, 0])
            adv = np.zeros(num_steps, np.float32)
            last = 0.0
            for i in reversed(range(num_steps)):
                if done_a[i] > 0:  # episode cut (cooperative envs end
                    v_next, carry = 0.0, 0.0   # together via __all__)
                else:
                    v_next = v_boot if i == num_steps - 1 \
                        else float(values[i + 1])
                    carry = 1.0
                delta = rew_a[i] + gamma * v_next - values[i]
                last = delta + gamma * gae_lambda * carry * last
                adv[i] = last
            batch = {
                "obs": obs_a,
                "actions": np.asarray(t["actions"], np.int32),
                "logp_old": np.asarray(t["logp"], np.float32),
                "advantages": adv,
                "returns": (adv + values).astype(np.float32),
            }
            agg = out.setdefault(pid, {k: [] for k in batch})
            for k, v in batch.items():
                agg[k].append(v)
        result = {pid: {k: np.concatenate(v) for k, v in agg.items()}
                  for pid, agg in out.items()}
        result["__episode_returns__"] = np.asarray(
            self._completed, np.float32)
        self._completed = []
        return result


@dataclass
class MultiAgentPPOConfig:
    """reference: AlgorithmConfig.multi_agent(policies=...,
    policy_mapping_fn=...)."""

    env_maker: Optional[Callable[[], Any]] = None
    policy_mapping_fn: Callable[[str], str] = lambda agent_id: agent_id
    policies: Optional[List[str]] = None  # None: one policy per agent
    num_env_runners: int = 2
    rollout_fragment_length: int = 256
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
    # The learners' device: None is the CUDA card (raises without one)
    device: Optional[str] = None

    def environment(self, env_maker) -> "MultiAgentPPOConfig":
        self.env_maker = env_maker
        return self

    def multi_agent(self, *, policies: Optional[List[str]] = None,
                    policy_mapping_fn: Optional[Callable] = None
                    ) -> "MultiAgentPPOConfig":
        if policies is not None:
            self.policies = list(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "MultiAgentPPOConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "MultiAgentPPOConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """One PPOLearner per policy id; shared rollouts."""

    def __init__(self, config: MultiAgentPPOConfig):
        from ray_tpu_torch.rllib.learner import PPOLearner

        assert config.env_maker is not None
        self.config = config
        probe = config.env_maker()
        mapping = config.policy_mapping_fn
        policies = config.policies or sorted(
            {mapping(a) for a in probe.agent_ids})
        # Per-policy obs/action sizes from any agent mapped to it.
        sizes: Dict[str, tuple] = {}
        for a in probe.agent_ids:
            pid = mapping(a)
            size = (probe.observation_sizes[a],
                    probe.num_actions_per_agent[a])
            if pid in sizes and sizes[pid] != size:
                raise ValueError(
                    f"policy {pid!r} maps agents with different spaces")
            sizes[pid] = size
        self._learners: Dict[str, "PPOLearner"] = {
            pid: PPOLearner(*sizes[pid], hidden=tuple(config.hidden),
                            lr=config.lr, clip=config.clip_param,
                            vf_coeff=config.vf_loss_coeff,
                            entropy_coeff=config.entropy_coeff,
                            seed=config.seed + i, device=config.device)
            for i, pid in enumerate(policies)}
        maker_blob = cloudpickle.dumps(config.env_maker)
        map_blob = cloudpickle.dumps(mapping)
        runner_cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
        self._runners = [
            runner_cls.remote(maker_blob, map_blob,
                              seed=config.seed + 1000 * (i + 1))
            for i in range(config.num_env_runners)]
        self.iteration = 0
        self._recent_returns: List[float] = []

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        cfg = self.config
        weights = {pid: ln.get_weights()
                   for pid, ln in self._learners.items()}
        ray_tpu_torch.get([r.set_weights.remote(weights)
                     for r in self._runners], timeout=300)
        results = ray_tpu_torch.get([
            r.sample.remote(cfg.rollout_fragment_length, cfg.gamma,
                            cfg.gae_lambda)
            for r in self._runners], timeout=600)
        for res in results:
            self._recent_returns.extend(
                res.pop("__episode_returns__").tolist())
        losses: Dict[str, float] = {}
        env_steps = 0
        learner_s = 0.0
        updates = 0
        for pid, learner in self._learners.items():
            per = [res[pid] for res in results if pid in res]
            if not per:
                continue
            batch = {k: np.concatenate([p[k] for p in per])
                     for k in per[0]}
            env_steps += len(batch["obs"])
            t_learn = time.monotonic()
            out = learner.update_minibatches(
                batch, num_epochs=cfg.num_epochs,
                minibatch_size=cfg.minibatch_size)
            learner_s += time.monotonic() - t_learn
            updates += cfg.num_epochs * max(
                1, len(batch["obs"]) // cfg.minibatch_size)
            losses.update({f"{pid}/{k}": v for k, v in out.items()})
        self.iteration += 1
        self._recent_returns = self._recent_returns[-100:]
        mean_return = (float(np.mean(self._recent_returns))
                       if self._recent_returns else 0.0)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_return,
            "env_steps_this_iter": env_steps,
            "time_this_iter_s": time.monotonic() - t0,
            "learner_time_this_iter_s": learner_s,
            "learner_updates_this_iter": updates,
            **losses,
        }

    def get_weights(self) -> Dict[str, Any]:
        return {pid: ln.get_weights()
                for pid, ln in self._learners.items()}

    def stop(self) -> None:
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
