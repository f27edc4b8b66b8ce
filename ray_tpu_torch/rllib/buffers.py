"""Replay buffers: the port's own copy of `ray_tpu/rllib/buffers.py`
(reference: rllib/utils/replay_buffers/*).

Host numpy ring storage, as in the reference: CPU RAM holds the
transitions, and each sampled minibatch goes to the learner's device once
an update. Prioritized sampling walks a sum tree. The numpy generator is
called in the reference's order (`integers` for a uniform draw, `uniform`
over the tree's total for a prioritized one), so a seed gives the same
indices and importance weights in both packages.

`ReplayActor` is the sebulba pipeline's replay: it never touches
trajectory bytes, only object-store refs of the port's runtime. Rollout
actors seal [T, B] trajectory objects into their store; the driver
forwards the refs here (wrapped in a list so that they arrive as refs);
the learner fetches sampled refs from the store: trajectory data never
passes through this actor.
"""

from typing import Dict, List, Optional

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


class ReplayActor:
    """Ref-based trajectory replay for the sebulba pipeline (deployed as an
    actor of the port's runtime; plain-class methods so it is also directly
    testable in process).

    Admission: ``add_refs([refs], versions)``: each slot holds an
    ObjectRef (a borrow: the deserialized copy increfs, so the trajectory
    object stays alive in the store exactly as long as the slot does)
    plus the params version stamped at collection time. Ring eviction
    drops the oldest slot's ref, releasing the object.

    Sampling: ``sample_refs(k)`` returns (ref, version) pairs without
    fetching any data. Two modes:

    * ``uniform``: seeded ``np.random.default_rng`` draws (deterministic
      given the config seed);
    * ``fifo``: each trajectory is handed out exactly once, oldest first
      (the lockstep mode: replay becomes a queue and the pipeline replays
      the synchronous schedule exactly).
    """

    def __init__(self, capacity: int, seed: int = 0, mode: str = "uniform"):
        if mode not in ("uniform", "fifo"):
            raise ValueError(f"unknown replay mode {mode!r}")
        self.capacity = capacity
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self._slots: List[tuple] = []   # (ref, version), insertion order
        self._next = 0                  # fifo cursor
        self._admitted = 0
        self._evicted = 0
        self._sampled = 0

    def ping(self) -> bool:
        return True

    def add_refs(self, refs, versions) -> int:
        """Admit trajectory refs (the driver passes them wrapped in a list
        so they arrive as refs, not values). Returns the current size."""
        if not isinstance(versions, (list, tuple)):
            versions = [versions] * len(refs)
        for ref, v in zip(refs, versions):
            self._slots.append((ref, int(v)))
            self._admitted += 1
        while len(self._slots) > self.capacity:
            self._slots.pop(0)          # drop -> borrow decref -> release
            self._evicted += 1
            self._next = max(self._next - 1, 0)
        return len(self._slots)

    def _sample_indices(self, k: int) -> List[int]:
        """The deterministic core: the next k slot indices for this mode."""
        n = len(self._slots)
        if self.mode == "fifo":
            take = min(k, n - self._next)
            idx = list(range(self._next, self._next + take))
            self._next += take
            return idx
        if n == 0:
            return []
        return [int(i) for i in self.rng.integers(0, n, size=k)]

    def sample_refs(self, k: int) -> List[tuple]:
        """Up to k (ref, version) pairs (fewer in fifo mode when the queue
        runs dry; empty when nothing is admitted yet). The refs go back to
        the caller as refs: no trajectory bytes move."""
        idx = self._sample_indices(k)
        self._sampled += len(idx)
        return [self._slots[i] for i in idx]

    def size(self) -> int:
        return len(self._slots) if self.mode == "uniform" else len(self._slots) - self._next

    def clear(self) -> int:
        """Drop every held ref (the driver awaits this before releasing the
        actor's handle, so no trajectory object stays pinned by a dying
        borrower)."""
        n = len(self._slots)
        del self._slots[:]
        self._next = 0
        return n

    def stats(self) -> Dict:
        return {"size": len(self._slots), "capacity": self.capacity,
                "mode": self.mode, "admitted": self._admitted,
                "evicted": self._evicted, "sampled": self._sampled,
                "fifo_cursor": self._next}


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
