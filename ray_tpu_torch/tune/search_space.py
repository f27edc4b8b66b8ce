"""Search-space primitives: the port's copy of `ray_tpu.tune.search_space`
(reference: python/ray/tune/search/sample.py).

Each domain samples with a numpy Generator; `grid_search` is a marker the
variant generator cross-products.
"""

import math
from typing import Any, Callable, Dict, List, Sequence

import numpy as np


class Domain:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[int(rng.integers(len(self.categories)))]


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


class LogUniform(Domain):
    def __init__(self, low: float, high: float, base: float = 10.0):
        if low <= 0:
            raise ValueError("loguniform needs low > 0")
        self.low, self.high, self.base = low, high, base

    def sample(self, rng):
        lo, hi = math.log(self.low, self.base), math.log(self.high, self.base)
        return float(self.base ** rng.uniform(lo, hi))


class Randint(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return int(rng.integers(self.low, self.high))


class QRandint(Domain):
    def __init__(self, low: int, high: int, q: int = 1):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        v = int(rng.integers(self.low, self.high + 1))
        return int(round(v / self.q) * self.q)


class Randn(Domain):
    def __init__(self, mean: float = 0.0, sd: float = 1.0):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return float(rng.normal(self.mean, self.sd))


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        try:
            return self.fn(None)  # reference passes a spec object
        except TypeError:
            return self.fn()


# -- public constructors (tune.choice etc.) ---------------------------------
def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def quniform(low, high, q):
    class _Q(Uniform):
        def sample(self, rng):
            return float(round(rng.uniform(self.low, self.high) / q) * q)
    return _Q(low, high)


def loguniform(low, high, base: float = 10.0) -> LogUniform:
    return LogUniform(low, high, base)


def randint(low, high) -> Randint:
    return Randint(low, high)


def qrandint(low, high, q=1) -> QRandint:
    return QRandint(low, high, q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Randn:
    return Randn(mean, sd)


def sample_from(fn) -> Function:
    return Function(fn)


def grid_search(values) -> Dict[str, List]:
    return {"grid_search": list(values)}


def is_grid(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


class LogRandint(Domain):
    """Integer drawn log-uniformly (ref: sample.py lograndint)."""

    def __init__(self, low: int, high: int, base: float = 10.0):
        if low <= 0:
            raise ValueError("lograndint needs low > 0")
        self.low, self.high, self.base = low, high, base

    def sample(self, rng):
        lo = math.log(self.low, self.base)
        hi = math.log(self.high, self.base)
        return int(self.base ** rng.uniform(lo, hi))


class Quantized(Domain):
    """round(inner/q)*q — the ONE quantization wrapper behind every q*
    sampler (matches QRandint's no-clamping convention); `cast` keeps the
    inner domain's value type."""

    def __init__(self, inner: Domain, q, cast=float):
        self.inner, self.q, self.cast = inner, q, cast

    def sample(self, rng):
        return self.cast(round(self.inner.sample(rng) / self.q) * self.q)


def lograndint(low, high, base: float = 10.0) -> LogRandint:
    return LogRandint(low, high, base)


def qlograndint(low, high, q=1, base: float = 10.0) -> Quantized:
    return Quantized(LogRandint(low, high, base), q, cast=int)


def qloguniform(low, high, q) -> Quantized:
    return Quantized(LogUniform(low, high), q)


def qrandn(mean: float = 0.0, sd: float = 1.0, q: float = 1.0) -> Quantized:
    return Quantized(Randn(mean, sd), q)
