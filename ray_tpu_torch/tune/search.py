"""Searchers: the port's copy of `ray_tpu.tune.search` (reference:
python/ray/tune/search/basic_variant.py + search/searcher.py).

BasicVariantGenerator: cross-product of grid_search entries × num_samples
random draws of the Domain entries. ConcurrencyLimiter caps how many
suggestions are outstanding. A lightweight TPE-flavored searcher
(QuasiBayesSearch) biases later samples toward the best-seen region —
the hyperopt-style slot without the dependency.
"""

import itertools
from typing import Any, Dict, List, Optional

import numpy as np

from .search_space import Domain, is_grid


class Searcher:
    def set_search_properties(self, metric, mode, space):
        self.metric, self.mode, self.space = metric, mode, space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None):
        pass


def _split_space(space: Dict):
    grids, domains, constants = {}, {}, {}
    for k, v in space.items():
        if is_grid(v):
            grids[k] = v["grid_search"]
        elif isinstance(v, Domain):
            domains[k] = v
        else:
            constants[k] = v
    return grids, domains, constants


class BasicVariantGenerator(Searcher):
    def __init__(self, space: Dict, num_samples: int = 1, seed: int = 0):
        self.space = space
        self.num_samples = num_samples
        self.rng = np.random.default_rng(seed)
        grids, domains, constants = _split_space(space)
        self._variants: List[Dict] = []
        grid_items = (itertools.product(*grids.values())
                      if grids else [()])
        for combo in grid_items:
            for _ in range(num_samples):
                cfg = dict(constants)
                cfg.update(dict(zip(grids.keys(), combo)))
                cfg.update({k: d.sample(self.rng) for k, d in domains.items()})
                self._variants.append(cfg)
        self._next = 0

    @property
    def total_trials(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._next >= len(self._variants):
            return None
        cfg = self._variants[self._next]
        self._next += 1
        return cfg


class QuasiBayesSearch(Searcher):
    """Explore/exploit sampler: after warmup, half the draws resample around
    the best config seen (gaussian jitter on numeric dims)."""

    def __init__(self, space: Dict, num_samples: int = 16, seed: int = 0,
                 metric: str = "score", mode: str = "max", warmup: int = 5):
        self.space = space
        self.metric, self.mode = metric, mode
        self.num_samples = num_samples
        self.warmup = warmup
        self.rng = np.random.default_rng(seed)
        self._suggested = 0
        self._observed: List = []  # (score, config)
        self._pending: Dict[str, Dict] = {}

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        _, domains, constants = _split_space(self.space)
        cfg = dict(constants)
        exploit = (len(self._observed) >= self.warmup
                   and self.rng.random() < 0.5)
        if exploit:
            sign = 1 if self.mode == "max" else -1
            best = max(self._observed, key=lambda sc: sign * sc[0])[1]
            for k, d in domains.items():
                v = best.get(k)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    jitter = d.sample(self.rng)
                    mixed = 0.8 * v + 0.2 * jitter
                    cfg[k] = type(v)(mixed) if isinstance(v, int) else mixed
                else:
                    cfg[k] = v if v is not None else d.sample(self.rng)
        else:
            cfg.update({k: d.sample(self.rng) for k, d in domains.items()})
        self._pending[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None):
        cfg = self._pending.pop(trial_id, None)
        if cfg is not None and result and self.metric in result:
            self._observed.append((result[self.metric], cfg))


class ConcurrencyLimiter(Searcher):
    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if len(self._live) >= self.max_concurrent:
            return None  # backpressure: tuner retries later
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result)

    def __getattr__(self, item):
        return getattr(self.searcher, item)
