"""Application metrics: Counter, Gauge and Histogram in a per-process
registry, with quantile summaries of histograms.

The port's own copy of `ray_tpu/util/metrics.py`, without its runtime
counters (which read the JAX package's control plane), with the two
tallies the serving plane reads: `kv_ship_counters` (the PD KV-shipment
plane, `serve/kv_transfer.py`) and `radix_counters` (the radix prefix
cache and its demotion tier, `serve/radix_cache.py`). The registry is
process-global, as in the JAX package, and separate from it: the serving
engine's SLO histograms (`serve/llm.py`) register here by name through
`get_or_create`, so every replica in a process shares one series per tag
set. Tag semantics: default_tags at construction, per-record overrides.
"""

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Reentrant: get_or_create holds it across construction and
# Metric.__init__ re-acquires to register — the whole check-then-create is
# one critical section, so two racing threads can't build duplicate
# instances of the same series and clear_registry() can't interleave
# between the lookup and the construction (which used to resurrect a
# cleared counter mid-test).
_registry_lock = threading.RLock()
_registry: Dict[str, "Metric"] = {}


def _tag_key(tags: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((tags or {}).items()))


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry[name] = self

    @property
    def info(self):
        return {"name": self._name, "description": self._description,
                "tag_keys": self._tag_keys}

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags):
        out = dict(self._default_tags)
        out.update(tags or {})
        return out


class Counter(Metric):
    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict] = None):
        if value < 0:
            raise ValueError("counters only go up")
        k = _tag_key(self._merged(tags))
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def snapshot(self):
        with self._lock:
            return {"type": "counter", **self.info,
                    "values": {k: v for k, v in self._values.items()}}


class Gauge(Metric):
    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict] = None):
        with self._lock:
            self._values[_tag_key(self._merged(tags))] = float(value)

    def inc(self, value: float = 1.0, tags: Optional[Dict] = None):
        k = _tag_key(self._merged(tags))
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def dec(self, value: float = 1.0, tags: Optional[Dict] = None):
        self.inc(-value, tags)

    def snapshot(self):
        with self._lock:
            return {"type": "gauge", **self.info,
                    "values": dict(self._values)}


class Histogram(Metric):
    def __init__(self, name, description="", boundaries: Sequence[float] = (),
                 tag_keys=()):
        super().__init__(name, description, tag_keys)
        if not boundaries:
            boundaries = [0.001, 0.01, 0.1, 1, 10, 100]
        self._bounds = sorted(boundaries)
        self._buckets: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._counts: Dict[Tuple, int] = {}

    def observe(self, value: float, tags: Optional[Dict] = None):
        k = _tag_key(self._merged(tags))
        with self._lock:
            if k not in self._buckets:
                self._buckets[k] = [0] * (len(self._bounds) + 1)
            idx = bisect.bisect_left(self._bounds, value)
            self._buckets[k][idx] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1

    def snapshot(self):
        with self._lock:
            return {"type": "histogram", **self.info,
                    "boundaries": list(self._bounds),
                    "buckets": {k: list(v) for k, v in self._buckets.items()},
                    "sum": dict(self._sums), "count": dict(self._counts)}


def get_or_create(metric_cls, name: str, *args, **kwargs) -> "Metric":
    """Return the metric registered under `name`, constructing it on first
    use. Metric.__init__ REPLACES a same-name registration, which silently
    forks the series when several instances of a component (e.g. every
    LLMServer replica in one process) each build their own — shared series
    must go through here. Raises TypeError if `name` is already registered
    as a different metric class.

    Thread-safe end to end: the lookup AND the construction happen under
    the (reentrant) registry lock, so concurrent callers get the same
    instance and a concurrent clear_registry() either beats the whole
    operation or waits for it — it can no longer land between the check
    and the create."""
    with _registry_lock:
        existing = _registry.get(name)
        if existing is not None:
            if not isinstance(existing, metric_cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(existing).__name__}, not {metric_cls.__name__}")
            return existing
        return metric_cls(name, *args, **kwargs)


def collect() -> List[Dict]:
    """Snapshot every metric registered in this process."""
    with _registry_lock:
        metrics = list(_registry.values())
    return [m.snapshot() for m in metrics]


def clear_registry():
    with _registry_lock:
        _registry.clear()


def _bucket_quantile(q: float, bounds: List[float], buckets: List[int],
                     total: int) -> float:
    """Prometheus-style histogram_quantile: walk the cumulative bucket
    counts and linearly interpolate inside the bucket the rank falls in.
    The overflow bucket clamps to the highest bound (no upper edge)."""
    rank = q * total
    cum = 0
    for i, n in enumerate(buckets):
        if n == 0:
            continue
        if cum + n >= rank:
            if i >= len(bounds):           # overflow bucket: clamp
                return bounds[-1] if bounds else 0.0
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - cum) / n
            return lo + (hi - lo) * frac
        cum += n
    return bounds[-1] if bounds else 0.0


def histogram_summary(name: str,
                      qs: Sequence[float] = (0.5, 0.9, 0.99)
                      ) -> Optional[Dict[str, float]]:
    """Quantile summary of a registered Histogram, merged across ALL its
    tag series: {"count", "sum", "mean", "p50", "p90", "p99"} (keys follow
    `qs`). None when the histogram doesn't exist or has no observations —
    callers render '-' rather than a fake zero."""
    with _registry_lock:
        m = _registry.get(name)
    if not isinstance(m, Histogram):
        return None
    snap = m.snapshot()
    bounds = snap["boundaries"]
    merged = [0] * (len(bounds) + 1)
    for series in snap["buckets"].values():
        for i, n in enumerate(series):
            merged[i] += n
    total = sum(merged)
    if total == 0:
        return None
    s = sum(snap["sum"].values())
    out = {"count": total, "sum": s, "mean": s / total}
    for q in qs:
        out[f"p{int(q * 100)}"] = _bucket_quantile(q, bounds, merged, total)
    return out


def histogram_window(name: str, state: Dict,
                     qs: Sequence[float] = (0.5, 0.9, 0.99)
                     ) -> Optional[Dict[str, float]]:
    """Quantile summary of the observations made SINCE the previous call
    with the same `state` dict (mutated in place; pass {} on first use).

    Histograms are cumulative, so an all-time p99 answers "how was the
    whole day" — the SLO autoscaler needs "how is the last evaluation
    interval", else a quiet hour masks a fresh breach (and a past burst
    blocks scale-down forever). None when no new observations landed."""
    with _registry_lock:
        m = _registry.get(name)
    if not isinstance(m, Histogram):
        return None
    snap = m.snapshot()
    bounds = snap["boundaries"]
    merged = [0] * (len(bounds) + 1)
    for series in snap["buckets"].values():
        for i, n in enumerate(series):
            merged[i] += n
    s = sum(snap["sum"].values())
    prev = state.get(name)
    state[name] = {"merged": merged, "sum": s}
    if prev is None or len(prev["merged"]) != len(merged):
        delta, dsum = merged, s
    else:
        delta = [a - b for a, b in zip(merged, prev["merged"])]
        dsum = s - prev["sum"]
        if any(d < 0 for d in delta):  # registry reset between calls
            delta, dsum = merged, s
    total = sum(delta)
    if total <= 0:
        return None
    out = {"count": total, "sum": dsum, "mean": dsum / total}
    for q in qs:
        out[f"p{int(q * 100)}"] = _bucket_quantile(q, bounds, delta, total)
    return out


# -- serving-plane read surface ---------------------------------------------
# The raw series are ordinary registry metrics written by serve/kv_transfer.py
# and serve/pd.py (shipment) and serve/radix_cache.py (the prefix tree). These
# helpers flatten them into plain numbers so that tests and the smoke run can
# assert on deltas. They read the CURRENT process.

def _counter_total(name: str) -> float:
    with _registry_lock:
        m = _registry.get(name)
    if not isinstance(m, Counter):
        return 0.0
    return sum(m.snapshot()["values"].values())


def _gauge_total(name: str) -> float:
    with _registry_lock:
        m = _registry.get(name)
    if not isinstance(m, Gauge):
        return 0.0
    return sum(m.snapshot()["values"].values())


def kv_ship_counters() -> Dict[str, float]:
    """PD KV-shipment tallies: bytes/pages/segments sealed into shm
    segments; requests served by the streaming plane; saved_pages, pages
    NOT shipped because the decode side held them in its prefix cache;
    attach_hits / stream_pulls / rpc_pulls split the decode pulls by
    transport (same-host attach, ranged streams from the KV data server,
    raw-bytes RPC fallback)."""
    return {"bytes": _counter_total("kv_ship_bytes"),
            "pages": _counter_total("kv_ship_pages"),
            "segments": _counter_total("kv_ship_segments"),
            "requests": _counter_total("kv_ship_requests"),
            "saved_pages": _counter_total("kv_ship_saved_pages"),
            "attach_hits": _counter_total("kv_ship_attach_hits"),
            "stream_pulls": _counter_total("kv_ship_stream_pulls"),
            "rpc_pulls": _counter_total("kv_ship_rpc_pulls"),
            "rpc_fallback_bytes": _counter_total("kv_ship_rpc_fallback_bytes")}


def radix_counters() -> Dict[str, float]:
    """Radix prefix-cache tallies: prefix_nodes is the live tree size;
    hit_tokens/query_tokens the prefix hit rate; evicted_pages the pages
    LRU-evicted off the tree; demoted/restored_pages those of them sealed
    into the KV stash and those later pulled back instead of recomputed."""
    return {"prefix_nodes": _gauge_total("radix_prefix_nodes"),
            "hit_tokens": _counter_total("radix_hit_tokens"),
            "query_tokens": _counter_total("radix_query_tokens"),
            "evicted_pages": _counter_total("radix_evicted_pages"),
            "demoted_pages": _counter_total("radix_demoted_pages"),
            "restored_pages": _counter_total("radix_restored_pages")}
