"""Application metrics: Counter, Gauge and Histogram in a per-process
registry, with quantile summaries of histograms.

The port's own copy of `ray_tpu/util/metrics.py`, with the port runtime's
read surface (control-plane frames and round trips, transfers, prefetch
hits, async results, locality and the spill ladder's tallies), and the two tallies the serving
plane reads: `kv_ship_counters` (the PD KV-shipment
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


def serve_fleet_counters() -> Dict[str, float]:
    """Fleet-routing tallies for the CURRENT process. Handle side:
    affinity_hits routed to a prefix-matching replica, affinity_spills
    bounced to p2c because the match's queue was too deep, affinity_misses
    had no matching digest; mux_rebalances evicted a multiplex model pin off
    an overloaded replica; died_retries re-routed a request whose replica
    died mid-flight. Controller side: scale_events counts SLO-autoscale
    ledger records."""
    return {"affinity_hits": _counter_total("serve_affinity_hits_total"),
            "affinity_misses": _counter_total("serve_affinity_misses_total"),
            "affinity_spills": _counter_total("serve_affinity_spills_total"),
            "mux_rebalances": _counter_total("serve_mux_rebalances_total"),
            "died_retries": _counter_total("serve_died_retries_total"),
            "scale_events": _counter_total("serve_scale_events_total")}


# -- the port runtime's control-plane and data-plane read surface ----------
# Frame/round-trip tallies live in `_private/protocol.py`; the transfer and
# locality series are registry counters written by the runtime.

def control_plane_counters() -> Dict[str, Dict[str, int]]:
    """Per-process frame/round-trip tallies by message kind:
    {"frames_sent": {kind: n}, "frames_received": {...}, "roundtrips": {...}}.
    Frames count unix-socket messages; round trips count blocking control
    calls (worker RPCs that awaited a reply, driver bridge calls into the
    controller loop)."""
    from ray_tpu_torch._private import protocol
    return protocol.counter_snapshot()


def control_roundtrips_total() -> int:
    """Blocking control calls this process made (worker RPCs that awaited a
    reply, driver bridge calls into the controller loop)."""
    from ray_tpu_torch._private import protocol
    return protocol.roundtrips_total()


def control_frames_sent_total() -> int:
    """Unix-socket frames this process sent."""
    from ray_tpu_torch._private import protocol
    return protocol.frames_sent_total()


def control_local_gets_total() -> int:
    """Owned objects served from the client-local ownership table — gets
    that never touched the head (zero round trips, zero frames)."""
    from ray_tpu_torch._private import protocol
    return protocol.local_gets_total()


def transfer_counters() -> Dict[str, float]:
    """Per-process parallel-transfer tallies: fetches completed, bytes
    landed, streams opened, stream retries (redistributed tails), retry
    rounds across successful AND abandoned fetches (retries_total),
    transfers that ran out their hard deadline (deadline_exceeded), and
    total seconds spent transferring."""
    with _registry_lock:
        hist = _registry.get("transfer_fetch_seconds")
    seconds = 0.0
    if isinstance(hist, Histogram):
        seconds = sum(hist.snapshot()["sum"].values())
    return {"fetches": _counter_total("transfer_fetches"),
            "bytes": _counter_total("transfer_fetch_bytes"),
            "streams": _counter_total("transfer_fetch_streams"),
            "retries": _counter_total("transfer_stream_retries"),
            "retries_total": _counter_total("transfer_retries_total"),
            "deadline_exceeded":
                _counter_total("transfer_deadline_exceeded_total"),
            "seconds": seconds}


def transfer_bytes_total() -> int:
    return int(_counter_total("transfer_fetch_bytes"))


def prefetch_counters() -> Dict[str, float]:
    """Dependency-prefetching dispatch tallies (per process: the head sees
    its own dispatches, each node agent its own). hits/misses are counted
    at DISPATCH: a hit means a ref arg was shm/inline-resident when the
    exec frame shipped (the worker resolves it zero-copy); a miss means
    the worker had to fall back to the blocking exec-time fetch.
    pulls/pull_bytes/dedup/failures tally the eager pull manager;
    overlap_saved_ms sums the pull wall-time of args that were prefetched
    and hit, transfer time taken off the task's critical path."""
    return {"hits": _counter_total("prefetch_hits"),
            "misses": _counter_total("prefetch_misses"),
            "pulls": _counter_total("prefetch_pulls"),
            "pull_bytes": _counter_total("prefetch_pull_bytes"),
            "dedup": _counter_total("prefetch_pull_dedup"),
            "failures": _counter_total("prefetch_pull_failures"),
            "overlap_saved_ms": _counter_total("prefetch_overlap_saved_ms")}


def prefetch_hit_rate() -> float:
    """hits / (hits + misses); 1.0 when nothing was ever dispatched with
    ref args (nothing was ever missed)."""
    c = prefetch_counters()
    total = c["hits"] + c["misses"]
    return 1.0 if total == 0 else c["hits"] / total


def result_async_counters() -> Dict[str, float]:
    """Fire-and-forget task-result publication tallies, counted where the
    batched `task_done` entries are APPLIED (the controller process):
    tasks whose completion rode a batch frame, result objects registered
    that way, and their inline bytes."""
    return {"tasks": _counter_total("result_async_tasks"),
            "results": _counter_total("result_async_results"),
            "bytes": _counter_total("result_async_bytes")}


def rllib_sebulba_counters() -> Dict[str, float]:
    """Sebulba RL pipeline tallies (per process: rollout actors each count
    their own env steps; the driver/learner process counts updates and
    broadcasts). env_steps tallies environment transitions produced by
    rollout actors; learner_steps counts updates applied; broadcasts
    counts versioned param publications; stale_dropped counts sampled
    batches discarded for exceeding the configured max_staleness;
    param_version is the highest version this process has seen (learner:
    published; rollout: received)."""
    version = 0.0
    with _registry_lock:
        m = _registry.get("rllib_param_version")
    if isinstance(m, Gauge):
        vals = m.snapshot()["values"]
        if vals:
            version = max(vals.values())
    return {"env_steps": _counter_total("rllib_env_steps"),
            "learner_steps": _counter_total("rllib_learner_steps"),
            "broadcasts": _counter_total("rllib_broadcasts"),
            "stale_dropped": _counter_total("rllib_stale_dropped"),
            "param_version": version}


def rllib_offpolicy_gap_summary() -> Optional[Dict[str, float]]:
    """Quantiles of the learner's observed off-policy gap (learner param
    version minus the version stamped on each trajectory it consumed), the
    staleness V-trace corrects for. None before any update."""
    return histogram_summary("rllib_offpolicy_gap")


def sched_locality_counters() -> Dict[str, float]:
    """Locality-aware placement tallies (head process): hits = tasks placed
    on the node already holding the most arg bytes, misses = arg bytes
    existed but placement couldn't honor them, bytes = arg bytes that were
    local to the chosen node at placement time."""
    return {"hits": _counter_total("sched_locality_hits"),
            "misses": _counter_total("sched_locality_misses"),
            "bytes": _counter_total("sched_locality_bytes")}


def sched_locality_hit_rate() -> float:
    """hits / (hits + misses); 1.0 when no locality-scored placement has
    happened yet (nothing was ever missed)."""
    c = sched_locality_counters()
    total = c["hits"] + c["misses"]
    return 1.0 if total == 0 else c["hits"] / total


# -- the store's spill ladder: written by `_private/object_store.py` (spill
# and restore I/O) and `_private/controller.py` (demotions, tier gauges)

def spill_counters() -> Dict[str, float]:
    """Spill-ladder tallies (per process: the controller that owns the
    store). spill/restore_bytes tally tier-boundary I/O; spilled/restored
    count objects demoted to disk and promoted back; pressure_spills counts
    demotions triggered by the background pressure loop (vs the synchronous
    over-capacity path); pinned_skips counts demotion candidates spared
    because prefetch/pull pinning protected them; pinned_demotions counts
    protected objects that were ABOUT to be demoted anyway, which must
    stay zero."""
    return {"spill_bytes": _counter_total("spill_bytes_total"),
            "restore_bytes": _counter_total("restore_bytes_total"),
            "spilled_objects": _counter_total("spilled_objects_total"),
            "restored_objects": _counter_total("restored_objects_total"),
            "pressure_spills": _counter_total("spill_pressure_total"),
            "pinned_skips": _counter_total("spill_pinned_skips_total"),
            "pinned_demotions": _counter_total("spill_pinned_demotions_total"),
            "range_reads": _counter_total("spill_range_reads_total")}


def tier_occupancy() -> Dict[str, float]:
    """Per-tier occupancy gauges set by the store owner: bytes resident in
    the shm tier vs demoted to the disk tier, and object counts for each."""
    return {"shm_bytes": _gauge_total("store_tier_shm_bytes"),
            "disk_bytes": _gauge_total("store_tier_disk_bytes"),
            "shm_objects": _gauge_total("store_tier_shm_objects"),
            "disk_objects": _gauge_total("store_tier_disk_objects")}
