"""Trial schedulers: the port's copy of `ray_tpu.tune.schedulers`
(reference: python/ray/tune/schedulers/*).

Decision API: `on_result(trial_id, result)` → CONTINUE | STOP, plus PBT's
exploit instruction. ASHA is the async successive-halving rule from the
reference (asha.py): rungs at r, r*eta, r*eta², ...; at each rung keep the
top 1/eta of completed results, stop the rest.
"""

import collections
import math
from typing import Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def set_properties(self, metric: str, mode: str):
        self.metric = metric
        self.mode = mode
        self._sign = 1.0 if mode == "max" else -1.0

    def score(self, result: Dict) -> float:
        return self._sign * float(result[self.metric])

    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE

    def on_complete(self, trial_id: str, result: Optional[Dict]):
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (reference default)."""


class ASHAScheduler(TrialScheduler):
    def __init__(self, *, time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4, metric=None, mode=None):
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace = grace_period
        self.eta = reduction_factor
        # rung levels: grace * eta^k up to max_t
        self.rungs: List[int] = []
        r = grace_period
        while r < max_t:
            self.rungs.append(r)
            r *= reduction_factor
        self._rung_scores: Dict[int, List[float]] = {r: [] for r in self.rungs}
        if metric:
            self.set_properties(metric, mode or "max")

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return STOP  # reached the horizon — done, not culled
        decision = CONTINUE
        for rung in self.rungs:
            if t == rung:
                s = self.score(result)
                scores = self._rung_scores[rung]
                scores.append(s)
                k = max(len(scores) // self.eta, 1)
                cutoff = sorted(scores, reverse=True)[k - 1]
                if s < cutoff:
                    decision = STOP
        return decision


class HyperBandScheduler(TrialScheduler):
    """Simplified HyperBand: trials hash into brackets with different grace
    periods, each bracket runs ASHA (reference hyperband.py's essence)."""

    def __init__(self, *, time_attr: str = "training_iteration",
                 max_t: int = 100, reduction_factor: int = 4):
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = reduction_factor
        s_max = max(int(math.log(max_t, reduction_factor)), 1)
        self.brackets = [
            ASHAScheduler(time_attr=time_attr, max_t=max_t,
                          grace_period=reduction_factor ** s,
                          reduction_factor=reduction_factor)
            for s in range(s_max)]
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def set_properties(self, metric, mode):
        super().set_properties(metric, mode)
        for b in self.brackets:
            b.set_properties(metric, mode)

    def on_result(self, trial_id: str, result: Dict) -> str:
        if trial_id not in self._assignment:
            self._assignment[trial_id] = self._next % len(self.brackets)
            self._next += 1
        return self.brackets[self._assignment[trial_id]].on_result(
            trial_id, result)


class MedianStoppingRule(TrialScheduler):
    def __init__(self, *, time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        # running mean of the metric per trial + all means at each step
        self._sums: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr, 0)
        self._sums[trial_id] += self.score(result)
        self._counts[trial_id] += 1
        if t < self.grace or len(self._counts) < self.min_samples:
            return CONTINUE
        means = [self._sums[k] / self._counts[k] for k in self._sums]
        my_mean = self._sums[trial_id] / self._counts[trial_id]
        med = sorted(means)[len(means) // 2]
        return STOP if my_mean < med else CONTINUE


class PBTDecision:
    """Exploit instruction: restart `trial_id` from `source_trial`'s
    checkpoint with a mutated config."""

    def __init__(self, source_trial: str, new_config: Dict):
        self.source_trial = source_trial
        self.new_config = new_config


class PopulationBasedTraining(TrialScheduler):
    def __init__(self, *, time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict] = None,
                 quantile_fraction: float = 0.25, seed: int = 0):
        import numpy as np
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = np.random.default_rng(seed)
        self._latest: Dict[str, Dict] = {}   # trial_id -> last result
        self._configs: Dict[str, Dict] = {}  # trial_id -> current config

    def register(self, trial_id: str, config: Dict):
        self._configs[trial_id] = dict(config)

    def _mutate(self, config: Dict) -> Dict:
        from .search_space import Domain
        out = dict(config)
        for k, spec in self.mutations.items():
            if isinstance(spec, list):
                out[k] = spec[int(self.rng.integers(len(spec)))]
            elif isinstance(spec, Domain):
                out[k] = spec.sample(self.rng)
            elif callable(spec):
                out[k] = spec()
            elif k in out and isinstance(out[k], (int, float)):
                factor = 1.2 if self.rng.random() < 0.5 else 0.8
                out[k] = type(out[k])(out[k] * factor)
        return out

    def on_result(self, trial_id: str, result: Dict):
        """Returns CONTINUE, STOP, or a PBTDecision (exploit+explore)."""
        self._latest[trial_id] = result
        t = result.get(self.time_attr, 0)
        if t == 0 or t % self.interval != 0 or len(self._latest) < 2:
            return CONTINUE
        scored = sorted(self._latest.items(),
                        key=lambda kv: self.score(kv[1]), reverse=True)
        n = len(scored)
        k = max(int(n * self.quantile), 1)
        bottom_ids = {tid for tid, _ in scored[-k:]}
        top_ids = [tid for tid, _ in scored[:k]]
        if trial_id in bottom_ids and top_ids:
            src = top_ids[int(self.rng.integers(len(top_ids)))]
            if src != trial_id:
                new_cfg = self._mutate(self._configs.get(src, {}))
                self._configs[trial_id] = new_cfg
                return PBTDecision(source_trial=src, new_config=new_cfg)
        return CONTINUE
