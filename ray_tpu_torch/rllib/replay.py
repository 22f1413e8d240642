"""Replay buffers for off-policy algorithms (a copy of
``ray_tpu/rllib/replay.py``; numpy only).

Analogue of the reference's replay stack (reference:
rllib/utils/replay_buffers/replay_buffer.py ReplayBuffer +
prioritized_episode_buffer.py). Columnar numpy storage: batches of
transitions append into preallocated rings, sampling gathers by index —
static dtypes and contiguous slices, which the learner copies to its
device in one go.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class ReplayBuffer:
    """Uniform FIFO-ring transition buffer."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._head = 0
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        """Append a columnar batch of transitions (first axis = time)."""
        n = len(next(iter(batch.values())))
        if self._cols and set(batch) != set(self._cols):
            # A key-set mismatch would silently pair columns from
            # different transitions at the same index.
            raise ValueError(
                f"replay batch keys {sorted(batch)} != buffer keys "
                f"{sorted(self._cols)}")
        for k, v in batch.items():
            v = np.asarray(v)
            col = self._cols.get(k)
            if col is None:
                col = self._cols[k] = np.zeros(
                    (self.capacity, *v.shape[1:]), v.dtype)
            if len(v) != n:
                raise ValueError("ragged replay batch")
        if n >= self.capacity:  # keep only the newest capacity rows
            for k, v in batch.items():
                self._cols[k][:] = np.asarray(v)[-self.capacity:]
            self._head = 0
            self._size = self.capacity
            return
        end = self._head + n
        for k, v in batch.items():
            v = np.asarray(v)
            if end <= self.capacity:
                self._cols[k][self._head:end] = v
            else:  # wrap
                first = self.capacity - self._head
                self._cols[k][self._head:] = v[:first]
                self._cols[k][:end - self.capacity] = v[first:]
        self._head = end % self.capacity
        self._size = min(self.capacity, self._size + n)

    def sample(self, num: int) -> Dict[str, np.ndarray]:
        """Uniform sample with replacement."""
        if self._size == 0:
            raise ValueError("sampling from an empty replay buffer")
        idx = self._rng.randint(0, self._size, size=num)
        return {k: col[idx] for k, col in self._cols.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    prioritized_replay_buffer.py; Schaul et al. 2016) with importance
    weights and post-update priority writes."""

    def __init__(self, capacity: int, *, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed)
        self._alpha = alpha
        self._beta = beta
        self._prio = np.zeros(capacity, np.float64)
        self._max_prio = 1.0

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        start = self._head
        super().add(batch)
        # New transitions get max priority so they are seen at least once.
        idx = (start + np.arange(min(n, self.capacity))) % self.capacity
        self._prio[idx] = self._max_prio

    def sample(self, num: int) -> Dict[str, np.ndarray]:
        if self._size == 0:
            raise ValueError("sampling from an empty replay buffer")
        p = self._prio[:self._size] ** self._alpha
        p = p / p.sum()
        idx = self._rng.choice(self._size, size=num, p=p)
        weights = (self._size * p[idx]) ** (-self._beta)
        weights = weights / weights.max()
        out = {k: col[idx] for k, col in self._cols.items()}
        out["weights"] = weights.astype(np.float32)
        out["indices"] = idx.astype(np.int64)
        return out

    def update_priorities(self, indices: np.ndarray,
                          priorities: np.ndarray) -> None:
        priorities = np.abs(np.asarray(priorities, np.float64)) + 1e-6
        self._prio[indices] = priorities
        self._max_prio = max(self._max_prio, float(priorities.max()))
