"""EnvRunner — rollout-collecting actor (a copy of
``ray_tpu/rllib/env_runner.py``; numpy only).

Analogue of the reference's env runners (reference: rllib/env/
single_agent_env_runner.py — step envs with the current policy, return
sample batches; env_runner_group.py fans N of them out as actors). The
policy forward runs on the runner's host devices (numpy MLP mirror of the
learner net, ``x @ w + b`` with tanh between layers, on the learner's
weights as numpy — env stepping is host work; shipping obs to the GPU per
step would be all latency).
"""

from __future__ import annotations

from typing import Any, Dict, List

import cloudpickle
import numpy as np


def _np_forward(layers: List[dict], x: np.ndarray) -> np.ndarray:
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = np.tanh(x)
    return x


def _log_softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max(axis=-1, keepdims=True)
    return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))


class EnvRunner:
    def __init__(self, env_maker_blob: bytes, seed: int = 0):
        self._env = cloudpickle.loads(env_maker_blob)()
        self._rng = np.random.RandomState(seed)
        self._seed = seed
        self._weights: Dict[str, Any] = {}
        self._obs = self._env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed_returns: List[float] = []

    def set_weights(self, weights: Dict[str, Any]) -> bool:
        self._weights = weights
        return True

    def _policy_action(self, obs: np.ndarray) -> tuple:
        """Default behavior: sample from the softmax policy head."""
        logp = _log_softmax(_np_forward(self._weights["pi"],
                                        obs[None, :]))[0]
        action = int(self._rng.choice(len(logp), p=np.exp(logp)))
        return action, float(logp[action])

    def _rollout(self, num_steps: int,
                 select_action=None) -> Dict[str, np.ndarray]:
        """Shared stepping loop: behavior-policy transitions with explicit
        term/trunc flags, per-step next obs, and the final pre-reset obs
        at truncations — using the next episode's reset obs would leak
        value estimates across episode boundaries (GAE, V-trace, and TD
        targets all need this). `select_action(obs) -> (action, logp)`
        swaps the behavior policy (epsilon-greedy Q for DQN)."""
        select_action = select_action or self._policy_action
        obs_buf = np.zeros((num_steps, self._env.observation_size),
                           np.float32)
        next_buf = np.zeros((num_steps, self._env.observation_size),
                            np.float32)
        act_buf = np.zeros(num_steps, np.int32)
        rew_buf = np.zeros(num_steps, np.float32)
        term_buf = np.zeros(num_steps, np.float32)
        trunc_buf = np.zeros(num_steps, np.float32)
        logp_buf = np.zeros(num_steps, np.float32)
        trunc_obs = np.zeros((num_steps, self._env.observation_size),
                             np.float32)

        self._completed_returns = []
        obs = self._obs
        for t in range(num_steps):
            action, logp_a = select_action(obs)
            nxt, rew, term, trunc, _ = self._env.step(action)
            obs_buf[t] = obs
            next_buf[t] = nxt
            act_buf[t] = action
            rew_buf[t] = rew
            logp_buf[t] = logp_a
            term_buf[t] = float(term)
            trunc_buf[t] = float(trunc and not term)
            if trunc and not term:
                trunc_obs[t] = nxt
            self._episode_return += rew
            if term or trunc:
                self._completed_returns.append(self._episode_return)
                self._episode_return = 0.0
                obs = self._env.reset(
                    seed=int(self._rng.randint(0, 2 ** 31)))
            else:
                obs = nxt
        self._obs = obs
        return {
            "obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
            "next_obs": next_buf,
            "terms": term_buf, "truncs": trunc_buf,
            "trunc_obs": trunc_obs, "behavior_logp": logp_buf,
            "bootstrap_obs": obs.astype(np.float32),
            "episode_returns": np.asarray(self._completed_returns,
                                          np.float32),
        }

    def sample(self, num_steps: int, gamma: float = 0.99,
               gae_lambda: float = 0.95) -> Dict[str, np.ndarray]:
        """Collect num_steps transitions; returns the PPO batch with GAE
        advantages computed runner-side (reference: ConnectorV2 GAE)."""
        roll = self._rollout(num_steps)
        vf = self._weights["vf"]
        values = _np_forward(vf, roll["obs"])[:, 0]
        v_boot = float(_np_forward(vf, roll["bootstrap_obs"][None, :])
                       [0, 0])
        # V only at actual truncation rows (usually none or a handful).
        trunc_vals = np.zeros(num_steps, np.float32)
        idx = np.nonzero(roll["truncs"] > 0)[0]
        if len(idx):
            trunc_vals[idx] = _np_forward(vf, roll["trunc_obs"][idx])[:, 0]

        # GAE(lambda) advantages + returns. The recursion resets across
        # episode boundaries (term OR trunc); truncation bootstraps from
        # V(final pre-reset obs).
        adv = np.zeros(num_steps, np.float32)
        last = 0.0
        for t in reversed(range(num_steps)):
            if roll["terms"][t] > 0:
                v_next, nonterminal, carry = 0.0, 0.0, 0.0
            elif roll["truncs"][t] > 0:
                v_next, nonterminal, carry = float(trunc_vals[t]), 1.0, 0.0
            else:
                v_next = v_boot if t == num_steps - 1 else \
                    float(values[t + 1])
                nonterminal, carry = 1.0, 1.0
            delta = roll["rewards"][t] + gamma * v_next * nonterminal \
                - values[t]
            last = delta + gamma * gae_lambda * carry * last
            adv[t] = last
        returns = adv + values
        return {
            "obs": roll["obs"], "actions": roll["actions"],
            "logp_old": roll["behavior_logp"],
            "advantages": adv, "returns": returns.astype(np.float32),
            "episode_returns": roll["episode_returns"],
        }

    def sample_fragment(self, num_steps: int) -> Dict[str, np.ndarray]:
        """IMPALA-style trajectory fragment: raw transitions + behavior
        log-probs, NO advantage computation (the learner applies V-trace
        off-policy correction; reference:
        rllib/algorithms/impala/impala.py async sample batches)."""
        roll = self._rollout(num_steps)
        roll.pop("next_obs", None)  # V-trace never reads per-step next
        return roll

    def sample_transitions(self, num_steps: int,
                           epsilon: float) -> Dict[str, np.ndarray]:
        """Off-policy transition collection with epsilon-greedy Q actions
        (reference: DQN env runners + EpsilonGreedy exploration).
        Truncations count as NON-terminal (the TD target bootstraps
        through them); `next_obs` at a boundary is the final pre-reset
        obs (the shared _rollout loop guarantees this)."""
        q = self._weights["q"]

        def select(obs):
            if self._rng.random_sample() < epsilon:
                return int(self._rng.randint(self._env.num_actions)), 0.0
            return int(np.argmax(_np_forward(q, obs[None, :])[0])), 0.0

        roll = self._rollout(num_steps, select)
        return {
            "obs": roll["obs"], "actions": roll["actions"],
            "rewards": roll["rewards"], "next_obs": roll["next_obs"],
            "dones": roll["terms"],
            "episode_returns": roll["episode_returns"],
        }

    def sample_continuous(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Off-policy continuous-action collection with the squashed-
        Gaussian behavior policy (SAC; reference: rllib/algorithms/sac
        env-runner sampling). Own stepping loop — the shared _rollout
        stores int actions. Truncations bootstrap (non-terminal dones);
        `next_obs` at a boundary is the final pre-reset obs."""
        pi = self._weights["pi"]
        scale = float(self._weights.get("action_scale", 1.0))
        shift = float(self._weights.get("action_shift", 0.0))
        env = self._env
        asize = env.action_size
        obs_buf = np.zeros((num_steps, env.observation_size), np.float32)
        next_buf = np.zeros_like(obs_buf)
        act_buf = np.zeros((num_steps, asize), np.float32)
        rew_buf = np.zeros(num_steps, np.float32)
        done_buf = np.zeros(num_steps, np.float32)

        self._completed_returns = []
        obs = self._obs
        for t in range(num_steps):
            out = _np_forward(pi, obs[None, :])[0]
            mean, log_std = out[:asize], np.clip(out[asize:], -5.0, 2.0)
            action = shift + np.tanh(
                mean + np.exp(log_std)
                * self._rng.standard_normal(asize)) * scale
            nxt, rew, term, trunc, _ = env.step(action.astype(np.float32))
            obs_buf[t] = obs
            next_buf[t] = nxt
            act_buf[t] = action
            rew_buf[t] = rew
            done_buf[t] = float(term)  # truncation bootstraps
            self._episode_return += rew
            if term or trunc:
                self._completed_returns.append(self._episode_return)
                self._episode_return = 0.0
                obs = env.reset(seed=int(self._rng.randint(0, 2 ** 31)))
            else:
                obs = nxt
        self._obs = obs
        return {
            "obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
            "next_obs": next_buf, "dones": done_buf,
            "episode_returns": np.asarray(self._completed_returns,
                                          np.float32),
        }
