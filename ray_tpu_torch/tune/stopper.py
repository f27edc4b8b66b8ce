"""Stoppers: the port's copy of `ray_tpu.tune.stopper` (reference:
python/ray/tune/stopper/*)."""

import collections
from typing import Dict

import numpy as np


class Stopper:
    def __call__(self, trial_id: str, result: Dict) -> bool:
        raise NotImplementedError

    def stop_all(self) -> bool:
        return False


class MaximumIterationStopper(Stopper):
    def __init__(self, max_iter: int):
        self.max_iter = max_iter

    def __call__(self, trial_id, result):
        return result.get("training_iteration", 0) >= self.max_iter


class TrialPlateauStopper(Stopper):
    def __init__(self, metric: str, *, std: float = 0.01, num_results: int = 4,
                 grace_period: int = 4):
        self.metric = metric
        self.std = std
        self.num_results = num_results
        self.grace = grace_period
        self._window = collections.defaultdict(
            lambda: collections.deque(maxlen=num_results))
        self._counts = collections.defaultdict(int)

    def __call__(self, trial_id, result):
        if self.metric not in result:
            return False
        self._counts[trial_id] += 1
        w = self._window[trial_id]
        w.append(float(result[self.metric]))
        if self._counts[trial_id] < self.grace or len(w) < self.num_results:
            return False
        return float(np.std(w)) < self.std


class FunctionStopper(Stopper):
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, trial_id, result):
        return bool(self.fn(trial_id, result))


class CombinedStopper(Stopper):
    def __init__(self, *stoppers: Stopper):
        self.stoppers = stoppers

    def __call__(self, trial_id, result):
        return any(s(trial_id, result) for s in self.stoppers)
