"""Replay buffers: the port's own copy of `ray_tpu/rllib/buffers.py`
(reference: rllib/utils/replay_buffers/*).

Host numpy ring storage, as in the reference: CPU RAM holds the
transitions, and each sampled minibatch goes to the learner's device once
an update. Prioritized sampling walks a sum tree. The numpy generator is
called in the reference's order (`integers` for a uniform draw, `uniform`
over the tree's total for a prioritized one), so a seed gives the same
indices and importance weights in both packages.

`ReplayActor` (sebulba's replay of object-store refs) schedules actors and
stays with `ray_tpu`'s runtime.
"""

from typing import Dict, Optional

import numpy as np

from . import sample_batch as SB

# the columns of a stored transition (s, a, r, s', terminated)
TRANSITION_KEYS = (SB.OBS, SB.ACTIONS, SB.REWARDS, SB.NEXT_OBS, SB.TERMINATEDS)


class ReplayBuffer:
    """Uniform FIFO ring over dict-of-array transitions."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self._store: Optional[Dict[str, np.ndarray]] = None
        self._idx = 0
        self._size = 0

    def __len__(self):
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(next(iter(batch.values())))
        if self._store is None:
            self._store = {k: np.empty((self.capacity,) + np.asarray(v).shape[1:],
                                       np.asarray(v).dtype)
                           for k, v in batch.items()}
        idx = (self._idx + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._store[k][idx] = np.asarray(v)
        self._idx = (self._idx + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def add(self, **transition):
        self.add_batch({k: np.asarray([v]) for k, v in transition.items()})

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._store.items()}


class _SumTree:
    def __init__(self, capacity: int):
        self.n = 1
        while self.n < capacity:
            self.n *= 2
        self.tree = np.zeros(2 * self.n, np.float64)

    def set(self, idx, value):
        i = idx + self.n
        self.tree[i] = value
        i //= 2
        while i >= 1:
            self.tree[i] = self.tree[2 * i] + self.tree[2 * i + 1]
            i //= 2

    def total(self) -> float:
        return float(self.tree[1])

    def find(self, prefix: float) -> int:
        """Index whose cumulative-sum interval contains `prefix`."""
        i = 1
        while i < self.n:
            left = self.tree[2 * i]
            if prefix < left:
                i = 2 * i
            else:
                prefix -= left
                i = 2 * i + 1
        return i - self.n


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional PER (Schaul et al. 2016; reference:
    prioritized_replay_buffer.py): P(i) ∝ p_i^α, importance weights
    w_i ∝ (N·P(i))^-β normalized by their max."""

    def __init__(self, capacity: int, alpha: float = 0.6, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.tree = _SumTree(capacity)
        self.max_priority = 1.0

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(next(iter(batch.values())))
        start = self._idx
        super().add_batch(batch)
        for j in range(n):
            self.tree.set((start + j) % self.capacity, self.max_priority ** self.alpha)

    def sample(self, batch_size: int, beta: float = 0.4):
        total = self.tree.total()
        prefixes = self.rng.uniform(0, total, size=batch_size)
        idx = np.array([min(self.tree.find(p), self._size - 1) for p in prefixes])
        probs = self.tree.tree[idx + self.tree.n] / total
        weights = (self._size * np.maximum(probs, 1e-12)) ** (-beta)
        weights = weights / weights.max()
        out = {k: v[idx] for k, v in self._store.items()}
        out["_weights"] = weights.astype(np.float32)
        out["_indices"] = idx
        return out

    def update_priorities(self, indices, priorities):
        for i, p in zip(np.asarray(indices), np.asarray(priorities)):
            p = float(abs(p)) + 1e-6
            self.max_priority = max(self.max_priority, p)
            self.tree.set(int(i), p ** self.alpha)
