"""Environment API + a built-in CartPole (a copy of
``ray_tpu/rllib/env.py``; numpy only).

Analogue of the reference's env layer (reference: rllib/env/ — gymnasium
Env wrapping; SingleAgentEnvRunner steps vectorized gym envs). The API is
gymnasium-shaped (reset/step with terminated/truncated) so user gym envs
drop in via a thunk; CartPole ships built-in so the stack tests without
the gymnasium dependency.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


class Env:
    """Minimal gymnasium-compatible interface."""

    observation_size: int
    num_actions: int

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int
             ) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        raise NotImplementedError


class CartPole(Env):
    """Classic cart-pole balancing (standard Barto-Sutton dynamics)."""

    observation_size = 4
    num_actions = 2

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    def __init__(self):
        self._rng = np.random.RandomState(0)
        self._state = np.zeros(4, np.float64)
        self._steps = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._state = self._rng.uniform(-0.05, 0.05, 4)
        self._steps = 0
        return self._state.astype(np.float32)

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE if action == 1 else -self.FORCE
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        temp = (force + pole_ml * theta_dot ** 2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LEN * (4.0 / 3.0
                                  - self.POLE_MASS * cos_t ** 2 / total_mass))
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass
        x += self.DT * x_dot
        x_dot += self.DT * x_acc
        theta += self.DT * theta_dot
        theta_dot += self.DT * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        terminated = bool(abs(x) > self.X_LIMIT
                          or abs(theta) > self.THETA_LIMIT)
        truncated = self._steps >= self.MAX_STEPS
        return (self._state.astype(np.float32), 1.0, terminated, truncated,
                {})


class ContinuousEnv:
    """Continuous-action interface (reference: gymnasium Box spaces as
    consumed by rllib/algorithms/sac): actions are float vectors in
    [action_low, action_high]^action_size."""

    observation_size: int
    action_size: int
    action_low: float
    action_high: float

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: np.ndarray
             ) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        raise NotImplementedError


class Pendulum(ContinuousEnv):
    """Classic underactuated pendulum swing-up (standard gym dynamics):
    obs [cos th, sin th, th_dot], torque in [-2, 2], reward
    -(th^2 + 0.1 th_dot^2 + 0.001 u^2), 200-step episodes (truncation
    only — the task never terminates)."""

    observation_size = 3
    action_size = 1
    action_low = -2.0
    action_high = 2.0

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    def __init__(self):
        self._rng = np.random.RandomState(0)
        self._th = 0.0
        self._thdot = 0.0
        self._steps = 0

    def _obs(self) -> np.ndarray:
        return np.array([np.cos(self._th), np.sin(self._th), self._thdot],
                        np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._th = self._rng.uniform(-np.pi, np.pi)
        self._thdot = self._rng.uniform(-1.0, 1.0)
        self._steps = 0
        return self._obs()

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th_norm = ((self._th + np.pi) % (2 * np.pi)) - np.pi
        cost = th_norm ** 2 + 0.1 * self._thdot ** 2 + 0.001 * u ** 2
        thdot = self._thdot + (3 * self.G / (2 * self.L) * np.sin(self._th)
                               + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        thdot = float(np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED))
        self._th = self._th + thdot * self.DT
        self._thdot = thdot
        self._steps += 1
        truncated = self._steps >= self.MAX_STEPS
        return self._obs(), -float(cost), False, truncated, {}


class MultiAgentEnv:
    """Multi-agent interface (reference: rllib/env/multi_agent_env.py):
    dict-keyed obs/action/reward per agent id; terminateds/truncateds
    carry the "__all__" episode-end key."""

    agent_ids: Tuple[str, ...]
    observation_sizes: Dict[str, int]
    num_actions_per_agent: Dict[str, int]

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, int]):
        """-> (obs, rewards, terminateds, truncateds, infos) dicts; the
        terminateds/truncateds dicts include "__all__"."""
        raise NotImplementedError


class CooperativeMatch(MultiAgentEnv):
    """Two-agent coordination game: both agents see a one-hot context
    and (as the second half of the obs) a one-hot of the OTHER agent's
    previous action. Reward each step: +1 to both when both actions
    match the context, +0.25 when exactly one does. Solvable only when
    both policies learn the mapping — the cooperative sanity task."""

    agent_ids = ("a0", "a1")
    N_CONTEXTS = 4
    EP_LEN = 16

    def __init__(self):
        n = self.N_CONTEXTS
        self.observation_sizes = {a: 2 * n for a in self.agent_ids}
        self.num_actions_per_agent = {a: n for a in self.agent_ids}
        self._rng = np.random.RandomState(0)
        self._ctx = 0
        self._steps = 0
        self._prev = {a: 0 for a in self.agent_ids}

    def _obs_for(self, me: str) -> np.ndarray:
        n = self.N_CONTEXTS
        other = [a for a in self.agent_ids if a != me][0]
        obs = np.zeros(2 * n, np.float32)
        obs[self._ctx] = 1.0
        obs[n + self._prev[other]] = 1.0
        return obs

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._ctx = int(self._rng.randint(self.N_CONTEXTS))
        self._steps = 0
        self._prev = {a: 0 for a in self.agent_ids}
        return {a: self._obs_for(a) for a in self.agent_ids}

    def step(self, actions: Dict[str, int]):
        hits = sum(int(actions[a] == self._ctx) for a in self.agent_ids)
        reward = 1.0 if hits == 2 else (0.25 if hits == 1 else 0.0)
        self._prev = dict(actions)
        self._ctx = int(self._rng.randint(self.N_CONTEXTS))
        self._steps += 1
        done = self._steps >= self.EP_LEN
        obs = {a: self._obs_for(a) for a in self.agent_ids}
        rewards = {a: reward for a in self.agent_ids}
        terms = {a: False for a in self.agent_ids}
        terms["__all__"] = False
        truncs = {a: done for a in self.agent_ids}
        truncs["__all__"] = done
        return obs, rewards, terms, truncs, {}
