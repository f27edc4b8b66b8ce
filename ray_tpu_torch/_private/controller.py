"""Single-host controller: GCS + raylet + object directory in one asyncio loop.

Reference decomposition: src/ray/gcs (cluster/actor/object metadata),
src/ray/raylet (local scheduler + worker pool), src/ray/core_worker (task
submission, ref counting). On a GPU host we collapse these into one
controller per host: the heavy data plane is NCCL/NVLink, so the control plane's
job is bookkeeping, not throughput — a single event loop removes three IPC
hops the reference pays (worker→raylet→GCS) on every task.

Workers are separate processes connected over a unix socket (protocol.py).
The driver shares the controller's process and calls coroutines directly.
"""

import asyncio
import collections
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .. import exceptions as exc
from .._native import codec as _codec
from .._native import objdir as _objdir
from ..util import tracing
from ..util.gpu import scrub_accel_env
from . import ids, protocol
from .object_store import StoreClient
from .runtime_env import runtime_env_key
from .task_spec import ObjectMeta, TaskSpec

# Scheduling states
PENDING_DEPS = "PENDING_DEPS"
PENDING = "PENDING"
RUNNING = "RUNNING"
DONE = "DONE"
FAILED = "FAILED"
CANCELLED = "CANCELLED"

# Actor states (mirrors GCS actor state machine, src/ray/gcs/gcs_actor_manager)
A_PENDING = "PENDING_CREATION"
A_ALIVE = "ALIVE"
A_RESTARTING = "RESTARTING"
A_DEAD = "DEAD"

_INLINE_MAX = 64 * 1024
# decisions per sq_schedule call; the batch pass loops until drained
_SCHED_BATCH_MAX = 1024
DEFAULT_CAPACITY = int(os.environ.get("RTPT_STORE_BYTES", 8 << 30))


# -- spill-ladder policy knobs ------------------------------------------------
# The synchronous over-capacity path (register_put → _maybe_spill) is the
# backstop; the background demotion loop (reaper → _spill_tick) drains AHEAD
# of it, driven by the same store-pressure gauge the health plane exports.

def _physical_cards(assigned: List[int]) -> List[str]:
    """The CUDA_VISIBLE_DEVICES entries of assigned card ids: the ids index
    the cards this process sees, so a driver started under
    CUDA_VISIBLE_DEVICES=2,3 hands card 0 out as "2"."""
    seen = [x.strip() for x in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
            if x.strip()]
    return [seen[i] if i < len(seen) else str(i) for i in assigned]


def spill_threshold() -> float:
    """Store-used fraction above which the background loop starts demoting
    (RAY_TPU_SPILL_THRESHOLD, default 0.9)."""
    return float(os.environ.get("RAY_TPU_SPILL_THRESHOLD", 0.9))


def spill_target() -> float:
    """Fraction the background loop drains down to (RAY_TPU_SPILL_TARGET,
    default 0.7 — below the threshold so the loop doesn't chatter)."""
    return float(os.environ.get("RAY_TPU_SPILL_TARGET", 0.7))


def spill_interval_s() -> float:
    """Minimum seconds between background demotion scans
    (RAY_TPU_SPILL_INTERVAL)."""
    return float(os.environ.get("RAY_TPU_SPILL_INTERVAL", 1.0))


def format_timeline(entries) -> List[dict]:
    """Expand the timeline ring into Chrome trace_event dicts. The
    completion hot path appends raw tuples (one per task); the dict +
    f-string cost per phase is paid here, at query/ship time. Entries
    that are already dicts (spans shipped from nodes, pre-formatted by
    the agent) pass through unchanged."""
    out: List[dict] = []
    for e in entries:
        if isinstance(e, dict):
            out.append(e)
        elif e[0] == "_task":
            _, name, w_tid, t0, t1, trace_id, task_id = e
            ev = {"name": name, "ph": "X", "pid": 1, "tid": w_tid,
                  "ts": t0 * 1e6, "dur": max(t1 - t0, 1e-6) * 1e6}
            if trace_id is not None:
                ev["args"] = {"trace_id": trace_id, "task_id": task_id}
            out.append(ev)
        elif e[0] == "_phases":
            _, name, w_tid, trace_id, task_id, windows = e
            for phase, a, b in windows:
                out.append({"name": f"{name}:{phase}", "cat": "task_phase",
                            "ph": "X", "pid": 1, "tid": w_tid, "ts": a * 1e6,
                            "dur": max(b - a, 1e-6) * 1e6,
                            "args": {"trace_id": trace_id, "task_id": task_id,
                                     "phase": phase}})
    return out


def prefetch_enabled() -> bool:
    """Dependency-prefetching dispatch (ref: raylet dependency manager):
    remote ref args of queued tasks are pulled eagerly, exec frames carry
    shm/inline descriptors for locally resident args, and workers publish
    task results through the batched flusher. RAY_TPU_PREFETCH=0 restores
    the legacy exec-time-fetch path end to end."""
    return os.environ.get("RAY_TPU_PREFETCH", "1").lower() not in (
        "0", "false", "no")


def prefetch_max_bytes() -> int:
    """In-flight byte cap for eager pulls; excess requests queue until a
    pull completes (backpressure, not rejection)."""
    try:
        return int(os.environ.get("RAY_TPU_PREFETCH_MAX_BYTES",
                                  str(256 << 20)))
    except ValueError:
        return 256 << 20


def reconstruct_enabled() -> bool:
    """Eager node-death object recovery (ref: object_recovery_manager.cc
    driven from the GCS node-failure publisher). When a node dies, objects
    whose only copy lived there re-enqueue their creating tasks from lineage
    immediately. RAY_TPU_RECONSTRUCT=0 is the escape hatch: losses then
    surface lazily at the next get()/pull (old behavior)."""
    return os.environ.get("RAY_TPU_RECONSTRUCT", "1").lower() not in (
        "0", "false", "no")


def autoscale_enabled() -> bool:
    """Alert-driven reconciler loop (autoscaler/reconciler.py): node_dead /
    store-pressure / queue-growth alerts drive the installed NodeProvider.
    RAY_TPU_AUTOSCALE=0 disables the loop (manual provisioning only)."""
    return os.environ.get("RAY_TPU_AUTOSCALE", "1").lower() not in (
        "0", "false", "no")


@dataclass
class TaskRecord:
    spec: TaskSpec
    result_oids: List[str]
    state: str = PENDING
    rq_seq: int = -1  # ready-index sequence number while queued
    retries_left: int = 0
    reconstructions_left: int = -1  # lazily set on first lineage recovery
    worker_id: Optional[str] = None
    done: asyncio.Event = field(default_factory=asyncio.Event)
    deps_remaining: Set[str] = field(default_factory=set)
    pinned: List[str] = field(default_factory=list)
    ts_submit: float = 0.0
    ts_start: float = 0.0
    ts_end: float = 0.0
    cancelled: bool = False
    pinned_actors: List[str] = field(default_factory=list)
    pinned_streams: List[str] = field(default_factory=list)
    node_id: Optional[str] = None  # set when forwarded to a cluster node
    fwd_seq: Optional[int] = None  # per-node ship sequence (cluster.py stats)
    # args this task already gated a dispatch on waiting for an eager pull —
    # each arg gates at most once, so a failed pull degrades to the legacy
    # exec-time fetch instead of re-gating forever
    prefetch_tried: Set[str] = field(default_factory=set)
    # tracing (util.tracing): eager-pull wall windows [(t0, t1)] claimed at
    # dispatch for this task's args; worker-reported (resolve, exec-start,
    # exec-end) epoch stamps; derived per-phase durations for the state API
    prefetch_windows: List[tuple] = field(default_factory=list)
    worker_span: Optional[tuple] = None
    phases: Optional[Dict[str, float]] = None


class _ReadyIndex:
    """Ready queue over the C++ signature-bucketed index (_native/src/sched_queue.cpp,
    ctypes via _native/schedq.py; Python mirror when the toolchain is absent).

    Reference contrast: raylet's ClusterTaskManager keeps per-scheduling-class
    C++ queues. Tasks are bucketed by (pool, demand, env_key, gpu, creation);
    `next_rec` asks the index for the earliest pending task whose demand fits
    its pool, masked by worker availability per signature — O(#signatures)
    per dispatch instead of rescanning every queued task. The controller's
    dict pools stay the source of truth; _claim/_release mirror into the
    index, and the dispatch loop re-checks fit against the dicts as an
    invariant."""

    def __init__(self, controller):
        from ray_tpu_torch._native.schedq import make_ready_queue
        self.c = controller
        self.q = make_ready_queue()
        self.recs: "collections.OrderedDict[int, TaskRecord]" = collections.OrderedDict()
        self._seq = 0
        self._sig_cache: Dict[tuple, int] = {}
        self._sig_meta: List[dict] = []      # sig_id -> meta dict
        self._pool_ids: Dict[int, int] = {}  # id(pool dict) -> index pool id
        self._pool_free: List[int] = []      # reusable index pool ids
        self._pg_sigs: Dict[str, List[int]] = collections.defaultdict(list)
        self._next_pool = 0
        # Aggregate resource demand of every queued rec, maintained on the
        # three entry/exit points (append / take-or-remove / drop_seq) so
        # Cluster._head_free is O(resource kinds) instead of an O(queue)
        # rescan per placement decision.
        self.pending_demand: Dict[str, float] = {}

    def _demand_adjust(self, res: Dict[str, float], sign: float):
        pd = self.pending_demand
        for k, v in res.items():
            nv = pd.get(k, 0.0) + sign * v
            if -1e-9 < nv < 1e-9:
                pd.pop(k, None)
            else:
                pd[k] = nv

    # -- pools (mirrors of the controller's dict pools) ----------------------
    def register_pool(self, pool: Dict[str, float]) -> int:
        # reuse retired ids so placement-group churn doesn't grow the index
        pid = self._pool_free.pop() if self._pool_free else self._next_pool
        if pid == self._next_pool:
            self._next_pool += 1
        self._pool_ids[id(pool)] = pid
        self.q.set_pool(pid, pool)
        return pid

    def drop_pool(self, pool: Dict[str, float]):
        pid = self._pool_ids.pop(id(pool), None)
        if pid is not None:
            self.q.remove_pool(pid)
            self._pool_free.append(pid)

    def retire_pg_sigs(self, pg_id: str):
        """Placement group removed: retire its signatures — queued entries
        dropped, slots freed for reuse on both sides of the ctypes boundary,
        cache keys pruned. Keeps long PG-churn sessions bounded."""
        for sig in self._pg_sigs.pop(pg_id, []):
            self._sig_meta[sig]["dead"] = True
            self.q.retire_sig(sig)
        self._sig_cache = {k: v for k, v in self._sig_cache.items()
                           if not self._sig_meta[v].get("dead")}

    def adjust(self, pool: Dict[str, float], need: Dict[str, float], sign: float):
        pid = self._pool_ids.get(id(pool))
        if pid is not None and need:
            self.q.adjust(pid, need, sign)

    # -- enqueue / remove ----------------------------------------------------
    def _pool_key_for(self, spec: TaskSpec) -> int:
        if spec.placement_group_id:
            pg = self.c.pgroups.get(spec.placement_group_id)
            if pg is None:
                return -1  # unregistered pool: never fits, task pends
            idx = spec.placement_group_bundle_index
            bundle = pg.bundles[idx if idx >= 0 else 0]
            return self._pool_ids.get(id(bundle.available), -1)
        return self._pool_ids.get(id(self.c.available), 0)

    def _sig_for(self, spec: TaskSpec) -> int:
        from .runtime_env import runtime_env_key
        pool_key = self._pool_key_for(spec)
        env_key = runtime_env_key(spec.runtime_env)
        gpu = spec.resources.get("GPU", 0) > 0
        pg_id = spec.placement_group_id
        key = (pool_key, pg_id, tuple(sorted(spec.resources.items())),
               env_key, gpu, spec.is_actor_creation)
        sig = self._sig_cache.get(key)
        if sig is None:
            sig = self.q.register_sig(pool_key, spec.resources)
            self._sig_cache[key] = sig
            if pg_id:
                bidx = spec.placement_group_bundle_index

                def pool_ref(pg_id=pg_id, bidx=bidx):
                    pg = self.c.pgroups.get(pg_id)
                    if pg is None:
                        return None
                    return pg.bundles[bidx if bidx >= 0 else 0].available

                self._pg_sigs[pg_id].append(sig)
            else:
                pool_ref = lambda: self.c.available  # noqa: E731
            meta = {
                "env_key": env_key, "gpu": gpu,
                "creation": spec.is_actor_creation,
                "need": dict(spec.resources),
                "runtime_env": spec.runtime_env,
                "pool_ref": pool_ref, "dead": False}
            if sig == len(self._sig_meta):
                self._sig_meta.append(meta)
            else:
                self._sig_meta[sig] = meta  # reused retired slot
        return sig

    def append(self, rec: TaskRecord):
        self._seq += 1
        rec.rq_seq = self._seq
        self.recs[self._seq] = rec
        self._demand_adjust(rec.spec.resources, +1.0)
        self.q.push(self._seq, self._sig_for(rec.spec))

    def remove(self, rec: TaskRecord):
        """Lazy cancel: mark dead in the index (O(1)); the bucket sheds dead
        entries as they reach its front. Eager pop_task here would rescan the
        bucket per removal — O(n²) on mass cancellation."""
        if rec.rq_seq in self.recs:
            del self.recs[rec.rq_seq]
            self._demand_adjust(rec.spec.resources, -1.0)
            self.q.remove(rec.rq_seq)

    def take(self, rec: TaskRecord):
        """Dispatch-path removal: the rec is its bucket's front (next_rec just
        returned it), so pop_task is O(1)."""
        if rec.rq_seq in self.recs:
            del self.recs[rec.rq_seq]
            self._demand_adjust(rec.spec.resources, -1.0)
            self.q.pop_task(rec.rq_seq)

    def __len__(self):
        return len(self.recs)

    def __iter__(self):
        return iter(list(self.recs.values()))

    # -- dispatch selection --------------------------------------------------
    def sig_mask(self, deferred: Set[int]) -> List[bool]:
        # O(buckets) reads of the controller's idle index — no worker scan
        idle = {k for k, b in self.c.idle_index.items() if b}
        mask = []
        for sig_id, meta in enumerate(self._sig_meta):
            if sig_id in deferred or meta["dead"]:
                mask.append(False)
            elif meta["creation"]:
                mask.append(True)  # creations spawn their own worker
            else:
                mask.append((meta["gpu"], meta["env_key"]) in idle)
        return mask

    def batch_inputs(self, deferred: Set[int]):
        """(sig_modes, sig_buckets, bucket_idle) for schedule_batch: mode 0
        skip / 1 plain / 2 creation-barrier, plus per-(gpu, env) idle-worker
        counts from the controller's O(1) idle index."""
        modes: List[int] = []
        buckets: List[int] = []
        idle_counts: List[int] = []
        bucket_ids: Dict[tuple, int] = {}
        idle_index = self.c.idle_index
        for sig_id, meta in enumerate(self._sig_meta):
            if sig_id in deferred or meta["dead"]:
                modes.append(0)
                buckets.append(-1)
            elif meta["creation"]:
                modes.append(2)
                buckets.append(-1)
            else:
                key = (meta["gpu"], meta["env_key"])
                b = bucket_ids.get(key)
                if b is None:
                    b = len(idle_counts)
                    bucket_ids[key] = b
                    idle_counts.append(len(idle_index.get(key) or ()))
                modes.append(1)
                buckets.append(b)
        return modes, buckets, idle_counts

    def unclaim(self, sig: int):
        """Refund a native claim made by schedule_batch for a decision the
        controller could not apply (stale rec / dict drift / no worker)."""
        meta = self._sig_meta[sig]
        pool = meta["pool_ref"]()
        if pool is None or not meta["need"]:
            return
        pid = self._pool_ids.get(id(pool))
        if pid is not None:
            self.q.adjust(pid, meta["need"], +1.0)

    def next_rec(self, mask: List[bool]):
        """(rec_or_None, sig_id, seq); seq == -1 means nothing dispatchable.
        rec None with seq != -1 is a stale index entry the caller drops."""
        seq, sig = self.q.next_dispatchable(mask)
        if seq == -1:
            return None, -1, -1
        return self.recs.get(seq), sig, seq

    def drop_seq(self, seq: int):
        rec = self.recs.pop(seq, None)
        if rec is not None:
            self._demand_adjust(rec.spec.resources, -1.0)
        self.q.pop_task(seq)  # it was the bucket front — O(1)

    # -- per-signature aggregates (keeps demand counting O(#signatures)) -----
    def demand_by_sig(self):
        """[(meta, live_count)] for non-creation signatures whose demand
        currently fits their pool (pool checked against the dict truth)."""
        out = []
        for sig_id, meta in enumerate(self._sig_meta):
            if meta["creation"] or meta["dead"]:
                continue
            n = self.q.pending_sig(sig_id)
            if not n:
                continue
            pool = meta["pool_ref"]()
            if pool is None or not self.c._resources_fit(meta["need"], pool):
                continue
            out.append((meta, n))
        return out


@dataclass
class StreamState:
    items: list = field(default_factory=list)  # object ids in yield order
    finished: bool = False
    drained: bool = False  # consumer saw the end (StopIteration / error)
    open_handles: int = 0  # live ObjectRefGenerator copies
    max_served: int = 0  # items[:max_served] were handed out (consumer owns them)
    error: Optional[Exception] = None
    cond: asyncio.Event = field(default_factory=asyncio.Event)


@dataclass
class WorkerConn:
    worker_id: str
    writer: asyncio.StreamWriter = None
    proc: subprocess.Popen = None
    state: str = "starting"  # starting | idle | busy | dead
    running: Set[str] = field(default_factory=set)
    actor_id: Optional[str] = None  # dedicated actor worker
    blocked_tasks: Set[str] = field(default_factory=set)
    pid: int = 0
    # GPU-capable workers keep the card-binding env; CPU-only workers get it
    # stripped at spawn (CUDA_VISIBLE_DEVICES="": a plain worker that
    # initializes CUDA would take a context on a card it was not given)
    gpu_capable: bool = False
    # runtime_env content hash this worker was built for (None = default env);
    # tasks only dispatch to workers whose env_key matches theirs
    env_key: Optional[str] = None
    # actor handle / stream refs this worker's deserialized handles hold;
    # reconciled (released) if the worker dies without the matching decrefs
    actor_refs: Dict[str, int] = field(default_factory=dict)
    stream_refs: Dict[str, int] = field(default_factory=dict)
    # negotiated native-codec wire version for frames TO this peer (0 =
    # pickle only); set from the register handshake's codec_ver
    codec_ver: int = 0


@dataclass
class ActorRecord:
    actor_id: str
    creation_spec: TaskSpec = None
    options: object = None
    state: str = A_PENDING
    worker_id: Optional[str] = None
    queue: collections.deque = field(default_factory=collections.deque)  # queued TaskRecords
    in_flight: Set[str] = field(default_factory=set)
    restarts_used: int = 0
    name: Optional[str] = None
    namespace: str = "default"
    death_reason: str = ""
    env: dict = field(default_factory=dict)
    resources_claimed: bool = False  # standing allocation held (exactly-once release)
    node_id: Optional[str] = None  # cluster node hosting this actor (None = head)
    # distributed handle refcount (ref: Ray's actor handle reference counting,
    # src/ray/core_worker/reference_count.cc — an actor with no reachable
    # handles is terminated). Starts at 1 for the creating handle; serialized
    # handles ride the contained-id lists, deserialized handles own a ref.
    handle_refs: int = 1
    pending_gc: bool = False  # refs hit 0 while tasks were still queued/running


@dataclass
class Bundle:
    resources: Dict[str, float]
    available: Dict[str, float]
    # cross-node bundles (cluster mode): the hosting node's id plus the
    # node-local placement group that actually reserves the resources
    node_id: Optional[str] = None
    remote_pg_id: Optional[str] = None
    remote_index: int = 0


@dataclass
class PlacementGroupRecord:
    pg_id: str
    bundles: List[Bundle]
    strategy: str = "PACK"
    state: str = "CREATED"
    name: str = ""


class Controller:
    def __init__(self, socket_path: str, resources: Dict[str, float], job_id: str,
                 max_workers: int = None, store_capacity: int = DEFAULT_CAPACITY,
                 session_dir: str = None, cluster_port: int = None):
        self.socket_path = socket_path
        # GCS fault tolerance (named sessions): journal detached actors and
        # spilled objects so the next controller on this session restores
        # them (ref: src/ray/gcs GCS FT via Redis; see _private/gcs.py)
        self.gcs = None
        if session_dir:
            from .gcs import GcsJournal
            self.gcs = GcsJournal(session_dir)
        self.job_id = job_id
        self.node_id = ids.node_id()
        self.loop: asyncio.AbstractEventLoop = None
        self.store = StoreClient(create_arena=True)
        self.total = dict(resources)
        self.available = dict(resources)
        self.max_workers = max_workers or (int(resources.get("CPU", 1)) + 2)

        self.objects: Dict[str, ObjectMeta] = {}
        # id-sharded counter directory (native when the toolchain builds):
        # ObjectMeta routes refcount/pinned/holders here; bulk paths
        # (refdelta batches, node-death holder sweeps) hit it directly
        self.objdir = _objdir.get_directory()
        self.object_events: Dict[str, asyncio.Event] = {}
        self.lineage: Dict[str, str] = {}  # evicted oid -> creating task id
        self.tasks: Dict[str, TaskRecord] = {}
        self.ready_queue = _ReadyIndex(self)
        self.ready_queue.register_pool(self.available)  # cluster pool = 0
        self.dep_waiters: Dict[str, Set[str]] = collections.defaultdict(set)
        self.workers: Dict[str, WorkerConn] = {}
        # module directories of attached drivers (a submitted job's working
        # dir), appended after this process's own sys.path on every worker
        # spawned later, so an actor class the job pickled by reference
        # resolves there
        self.driver_paths: List[str] = []
        # idle pool workers indexed by (gpu_capable, env_key) so
        # _find_idle_worker and the schedule pass's per-class idle counts are
        # O(1) instead of scanning self.workers per dispatch. Maintained at
        # every state transition; readers still validate entries (a stale
        # entry degrades to a deferred dispatch, never a wrong one).
        self.idle_index: Dict[tuple, Dict[str, WorkerConn]] = {}
        # Batched scheduling pass (_native/src/sched_queue.cpp sq_schedule): one
        # selection+claim call per _schedule invocation instead of one index
        # round-trip per dispatch. RAY_TPU_NATIVE=0 / RAY_TPU_NATIVE_SCHED=0
        # fall back to the per-dispatch oracle loop (_dispatch_ready_oracle),
        # kept behavior-identical and asserted so by the equivalence tests.
        self._sched_batch = (
            os.environ.get("RAY_TPU_NATIVE", "1") != "0"
            and os.environ.get("RAY_TPU_NATIVE_SCHED", "1") != "0")
        # Client-owned small objects (ref: Ray ownership model,
        # src/ray/core_worker/reference_count.cc): inline results are pushed
        # to their owner's local table; sinks are in-process callbacks
        # (driver) — socket workers get one-way "owned" frames instead.
        self.ownership = os.environ.get("RAY_TPU_OWNERSHIP", "1") != "0"
        self.owner_sinks: Dict[str, object] = {}
        self.spawning: Dict[str, WorkerConn] = {}
        # consecutive Popen/OS spawn failures per env_key: transient errors
        # (fork EAGAIN) retry via _reaper's 1s _schedule; persistent ones
        # (venv interpreter deleted under us) must still fail fast
        self._spawn_failures: Dict[Optional[str], int] = {}
        self.actors: Dict[str, ActorRecord] = {}
        self.named_actors: Dict[tuple, str] = {}
        self.pgroups: Dict[str, PlacementGroupRecord] = {}
        self.streams: Dict[str, StreamState] = {}
        self.pending_reqs: Dict[str, asyncio.Future] = {}
        self.store_used = 0
        self.store_capacity = store_capacity
        self.store_spilled_bytes = 0   # disk-tier occupancy (spill ladder)
        self._last_spill_scan = 0.0
        self.gpu_free: List[int] = list(range(int(resources.get("GPU", 0))))
        self._server = None
        self._shutdown = False
        # Bounded bookkeeping (ref: GCS job-level GC,
        # src/ray/gcs/gcs_server/gcs_task_manager.h RAY_maximum_gcs_storage_entries):
        # finished task records and timeline events are pruned so week-long
        # sessions hold steady memory. Slim (spec, result_oids) pairs survive
        # pruning in `lineage_specs` so object reconstruction keeps working.
        self.task_retention = int(os.environ.get("RAY_TPU_TASK_RETENTION", "1000"))
        self.lineage_retention = int(os.environ.get("RAY_TPU_LINEAGE_RETENTION", "10000"))
        self.dead_actor_retention = int(os.environ.get("RAY_TPU_DEAD_ACTOR_RETENTION", "512"))
        self._done_task_ids: collections.deque = collections.deque()
        self._dead_actor_ids: collections.deque = collections.deque()
        self.lineage_specs: "collections.OrderedDict[str, tuple]" = collections.OrderedDict()
        self.timeline_events: collections.deque = collections.deque(
            maxlen=int(os.environ.get("RAY_TPU_TIMELINE_RETENTION", "20000")))
        # node controllers (span_ship=True, set by NodeAgent) copy traced
        # phase spans here; the agent's heartbeat drains them to the head
        self.span_ship = False
        self.span_outbox: List[dict] = []
        # runtime_env builder (py_modules/pip/working_dir staging, hash-cached)
        from .runtime_env import RuntimeEnvManager
        self.runtime_envs = RuntimeEnvManager()
        # autoscaler hook: last explicit resource request (sdk.request_resources)
        self.resource_requests: Dict = {}
        # node-provider provisioning (autoscaler/node_provider.py)
        self.node_provider = None
        self.provider_max_nodes = 0
        # handle -> promised resources ({"CPU": c, "num_gpus": t})
        self._provider_nodes: Dict[str, Dict[str, float]] = {}
        # alert-driven reconciler (autoscaler/reconciler.py), built by
        # set_node_provider; ticked from _reaper next to health.tick()
        self.reconciler = None
        # env keys with an async build in flight (built off-loop: a pip venv
        # install can take minutes and must not freeze the controller)
        self._env_building: Set[str] = set()
        # cross-host control plane (ref: raylet federation through the GCS,
        # src/ray/gcs/gcs_server/gcs_node_manager.cc). None = single host.
        self._cluster_port = cluster_port
        self.cluster = None
        # health signal plane: gauges + alert rules + leak detector,
        # evaluated from the reaper tick (see _private/health.py)
        from .health import HealthMonitor
        self.health = HealthMonitor(self)
        # batch application defers the greedy dispatch loop to the end of
        # the batch: one _schedule per frame instead of one per submit entry
        self._sched_defer = 0
        self._sched_dirty = False
        # active only inside a _schedule pass: writer -> [framed exec bytes],
        # joined into one transport write per worker at the end of the pass
        self._dispatch_buf = None
        self._pulls: Dict[str, asyncio.Task] = {}  # in-flight remote pulls
        # eager dependency pulls (single-flight per oid, byte-capped); built
        # in start() once the event loop exists
        self.prefetch = None

    # ------------------------------------------------------------------ setup
    async def start(self):
        self.loop = asyncio.get_running_loop()
        # lazy import: node_agent imports this module at its top level, and
        # Controller never needs PullManager until a loop exists
        from .node_agent import PullManager
        self.prefetch = PullManager(
            self.loop, max_bytes=prefetch_max_bytes(),
            pin=self._pin_for_pull, unpin=self._unpin_for_pull)
        self._server = await asyncio.start_unix_server(self._on_conn, path=self.socket_path)
        self.loop.create_task(self._reaper())
        if self._cluster_port is not None:
            from .cluster import ClusterServer
            self.cluster = ClusterServer(self)
            await self.cluster.start(self._cluster_port)
        if self.gcs is not None:
            await self._restore_from_journal()

    async def _restore_from_journal(self):
        """Replay the session journal: surviving spilled objects re-enter the
        object table; detached actors re-register and restart from their
        creation specs (fresh state, like a reference actor restart)."""
        from .gcs import fold
        records = self.gcs.load()
        actors, objects = fold(records)
        # bound journal growth across restarts: rewrite with the live set
        self.gcs.compact(
            list(actors.values()) +
            [r for r in records if r.get("kind") == "spilled"
             and r["object_id"] in objects])
        for oid, rec in objects.items():
            if not os.path.exists(rec["path"]):
                continue
            self.objects[oid] = ObjectMeta(
                object_id=oid, size=rec["size"], meta_len=rec["meta_len"],
                location="spilled", spill_path=rec["path"],
                refcount=1)  # session-held ref: survives driver turnover
            self.store_spilled_bytes += rec["size"]
            ev = asyncio.Event()
            ev.set()
            self.object_events[oid] = ev
        for rec in actors.values():
            spec, options = rec["spec"], rec["options"]
            try:
                self.register_actor(spec, options, _journal=False)
                await self.submit(spec)
            except Exception as e:  # noqa: BLE001 - a bad record must not
                # take the whole session down; drop it with a tombstone
                self.gcs.record("actor_dead", actor_id=spec.actor_id)
                print(f"[gcs] failed to restore detached actor "
                      f"{options.name!r}: {e}", file=sys.stderr)

    async def shutdown(self):
        self._shutdown = True
        if self.cluster is not None:
            self.cluster.close()
        for w in list(self.workers.values()) + list(self.spawning.values()):
            self._kill_worker_proc(w)
        if self._server:
            self._server.close()
        for oid, meta in list(self.objects.items()):
            if meta.location == "shm":
                self.store.delete_segment(oid)
            elif meta.location == "spilled" and meta.spill_path:
                if self.gcs is not None:
                    continue  # named session: spilled objects outlive us
                try:
                    os.remove(meta.spill_path)
                except OSError:
                    pass
        # the directory is process-global (back-to-back sessions in one
        # process, e.g. tests): drop this session's entries
        for oid in self.objects:
            self.objdir.erase(oid)
        for aid in self.actors:
            self.objdir.erase(aid)
        self.objects.clear()
        if self.gcs is not None:
            self.gcs.close()
        self.store.close(unlink_arena=True)
        os.environ.pop("RTPT_ARENA", None)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    # ------------------------------------------------------- idle worker index
    def _mark_idle(self, w: WorkerConn):
        if w.actor_id is not None:
            return
        self.idle_index.setdefault((w.gpu_capable, w.env_key), {})[w.worker_id] = w

    def _unmark_idle(self, w: WorkerConn):
        bucket = self.idle_index.get((w.gpu_capable, w.env_key))
        if bucket is not None:
            bucket.pop(w.worker_id, None)

    def _retire_idle_worker(self, w: WorkerConn):
        """Kill an idle pool worker to make room for another runtime env.
        Not "dead" (that's _on_worker_dead's transition when the connection
        drops) but no longer dispatchable while the kill is in flight."""
        self._kill_worker_proc(w)
        w.state = "dying"
        self._unmark_idle(w)

    def _kill_worker_proc(self, w: WorkerConn):
        if w.proc is not None and w.proc.poll() is None:
            try:
                w.proc.kill()
            except OSError:
                pass

    async def _reaper(self):
        """Detect spawned workers that died before registering (ref: raylet
        worker-pool startup token timeout)."""
        while not self._shutdown:
            await asyncio.sleep(1.0)
            for wid, w in list(self.spawning.items()):
                if w.proc.poll() is not None:
                    del self.spawning[wid]
                    self._on_worker_dead(w, f"worker process exited code={w.proc.returncode} before registering")
            try:
                self.health.tick()
            except Exception:  # noqa: BLE001 - health must not kill the reaper
                pass
            if self.reconciler is not None:
                try:
                    self.reconciler.tick()
                except Exception:  # noqa: BLE001 - ditto for the reconciler
                    pass
            try:
                self._spill_tick()
            except Exception:  # noqa: BLE001 - spill policy must not kill it
                pass
            self._schedule()

    # ------------------------------------------------------- worker connection
    async def _on_conn(self, reader, writer):
        msg = await protocol.aread_msg(reader)
        if msg is None or msg[0] != "register":
            writer.close()
            return
        wid = msg[1]["worker_id"]
        w = self.spawning.pop(wid, None) or WorkerConn(worker_id=wid)
        w.writer = writer
        w.pid = msg[1].get("pid", 0)
        # codec negotiation: what this peer can decode, capped by what we
        # can encode. Receivers sniff every frame, so this only governs
        # what either side may *send* (RAY_TPU_NATIVE=0 → 0 → all pickle).
        w.codec_ver = _codec.negotiate(msg[1].get("codec_ver", 0))
        # an attached driver (ray_tpu_torch.init(address=...), e.g. a submitted job)
        # shares the API surface over this socket but never executes tasks
        w.state = "driver" if msg[1].get("driver") else "idle"
        for p in msg[1].get("sys_path") or ():
            if p not in self.driver_paths:
                self.driver_paths.append(p)
        self.workers[wid] = w
        if w.state == "idle":
            self._mark_idle(w)
        if w.actor_id:
            # dedicated actor worker: dispatch the pending creation task
            actor = self.actors.get(w.actor_id)
            if actor is None or actor.state == A_DEAD:
                self._kill_worker_proc(w)  # killed before its worker registered
            elif actor.creation_spec is not None:
                rec = self.tasks[actor.creation_spec.task_id]
                self._dispatch(rec, w)
        self._schedule()
        try:
            while True:
                msg = await protocol.aread_msg(reader)
                if msg is None:
                    break
                await self._handle_worker_msg(w, msg[0], msg[1])
        finally:
            if not self._shutdown:
                self.workers.pop(wid, None)
                self._on_worker_dead(w, "worker connection closed")
                self._schedule()

    async def _handle_worker_msg(self, w: WorkerConn, kind: str, p: dict):
        if kind == "task_done":
            self._on_task_done(w, p)
        elif kind == "stream_item":
            self._on_stream_item(p)
        elif kind == "submit":
            oids = await self.submit(p["spec"])
            self._reply(w, p["req_id"], refs=oids)
        elif kind == "submit_async":
            # pipelined path: the client derived result_oids itself and is
            # not waiting for a reply; errors land in the refs' descriptors
            self.submit_pipelined(p["spec"], p["result_oids"])
        elif kind == "batch":
            self._apply_batch(w, p["entries"])
        elif kind == "get":
            self.loop.create_task(self._worker_get(w, p))
        elif kind == "wait":
            self.loop.create_task(self._worker_wait(w, p))
        elif kind == "put":
            self.register_put(p["oid"], p["meta_len"], p["size"], p.get("inline"),
                              p.get("contained"), owner=w.worker_id)
            self._reply(w, p["req_id"], ok=True)
        elif kind == "blocked":
            self._on_blocked(w, p["task_id"])
        elif kind == "unblocked":
            self._on_unblocked(w, p["task_id"])
        elif kind == "decref":
            for oid in p["oids"]:
                self._worker_decref_one(w, oid)
        elif kind == "incref":
            for oid in p["oids"]:
                self._worker_incref_one(w, oid)
        elif kind == "actor_incref":
            self._worker_actor_incref(w, p["actor_id"])
        elif kind == "actor_decref":
            self._worker_actor_decref(w, p["actor_id"])
        elif kind == "obj_sizes":
            self._reply(w, p["req_id"], sizes=[
                self.objects[o].size if o in self.objects else 0
                for o in p["oids"]])
        elif kind == "obj_locations":
            self._reply(w, p["req_id"],
                        locations=[self._object_location(o)
                                   for o in p["oids"]])
        elif kind == "spill":
            self.spill_for_put(p["bytes"], hard=p.get("hard", False))
            self._reply(w, p["req_id"], ok=True)
        elif kind == "hello":
            # attach handshake: the session's shm arena + job identity so a
            # process with no inherited env can join (ref: ray.init(address=))
            self._reply(w, p["req_id"],
                        arena=os.environ.get("RTPT_ARENA"),
                        store_bytes=self.store_capacity,
                        job_id=self.job_id, socket_path=self.socket_path,
                        codec_ver=_codec.negotiate(p.get("codec_ver", 0)))
        elif kind == "state":
            try:
                self._reply(w, p["req_id"], rows=self.state_snapshot(p["which"]))
            except ValueError as e:
                self._reply(w, p["req_id"], error=e)
        elif kind == "timeline":
            self._reply(w, p["req_id"], events=format_timeline(self.timeline_events))
        elif kind == "create_pg":
            self.loop.create_task(self._worker_create_pg(w, p))
        elif kind == "remove_pg":
            self.remove_placement_group(p["pg_id"])
            self._reply(w, p["req_id"], ok=True)
        elif kind == "open_stream":
            self._worker_open_stream(w, p["task_id"])
        elif kind == "close_stream":
            self._worker_close_stream(w, p["task_id"])
        elif kind == "next_stream":
            self.loop.create_task(self._worker_next_stream(w, p))
        elif kind == "register_actor_rpc":
            try:
                aid = self.register_actor(p["spec"], p["options"])
                # the creating handle (handle_refs' initial 1) lives in this
                # worker — tally it so a crash releases it
                w.actor_refs[aid] = w.actor_refs.get(aid, 0) + 1
                self._reply(w, p["req_id"], actor_id=aid)
            except ValueError as e:
                self._reply(w, p["req_id"], error=e)
        elif kind == "get_actor":
            try:
                aid = self.lookup_actor(p["name"], p.get("namespace"))
                w.actor_refs[aid] = w.actor_refs.get(aid, 0) + 1
                self._reply(w, p["req_id"], actor_id=aid)
            except ValueError as e:
                self._reply(w, p["req_id"], error=e)
        elif kind == "kill_actor":
            self.kill_actor(p["actor_id"], no_restart=p.get("no_restart", True))
            self._reply(w, p["req_id"], ok=True)
        elif kind == "cancel":
            self.cancel(p["task_id"], force=p.get("force", False))
            self._reply(w, p["req_id"], ok=True)
        elif kind == "resources":
            self._reply(w, p["req_id"], total=self.res_total(),
                        available=self.res_available())
        elif kind == "request_resources":
            self._reply(w, p["req_id"],
                        **self.request_resources(p.get("num_cpus"), p.get("bundles")))
        elif kind == "autoscaler_status":
            self._reply(w, p["req_id"], **self.autoscaler_status())
        elif kind == "chaos_op":
            try:
                self._reply(w, p["req_id"], **self.chaos_op(p.get("chaos") or {}))
            except ValueError as e:
                self._reply(w, p["req_id"], error=e)
        elif kind == "actor_exit":
            # graceful exit_actor(): mark dead without restart
            actor = self.actors.get(p["actor_id"])
            if actor:
                self._fail_actor(actor, "exit_actor() called", allow_restart=False)

    def _reply(self, w: WorkerConn, req_id, **payload):
        protocol.awrite_msg(w.writer, "resp", req_id=req_id, **payload)

    # --------------------------------------------- coalesced client batches
    # Entry format (client._DeltaFlusher): ("put", oid, meta_len, size,
    # inline, contained) | ("incref"|"decref"|"actor_incref"|"actor_decref"|
    # "open_stream"|"close_stream", id). Entries apply STRICTLY in append
    # order — the client's only ordering obligation is that it flushes before
    # any other frame on the same channel, so a decref can never be applied
    # before the put that created its ref.

    def _worker_incref_one(self, w: WorkerConn, oid: str):
        # contained-id lists carry actor handles and generator task-ids too
        # (prefix dispatch); worker-held refs are tallied for crash release
        if oid.startswith("actor-"):
            self._worker_actor_incref(w, oid)
        elif oid.startswith("task-"):
            self._worker_open_stream(w, oid)
        else:
            self.incref([oid])

    def _worker_decref_one(self, w: WorkerConn, oid: str):
        if oid.startswith("actor-"):
            self._worker_actor_decref(w, oid)
        elif oid.startswith("task-"):
            self._worker_close_stream(w, oid)
        else:
            self.decref([oid])

    def _apply_batch(self, w: WorkerConn, entries):
        self._sched_defer += 1
        try:
            self._apply_batch_inner(w, entries)
        finally:
            self._sched_defer -= 1
            if self._sched_defer == 0 and self._sched_dirty:
                self._sched_dirty = False
                self._schedule()

    def _apply_batch_inner(self, w: WorkerConn, entries):
        for e in entries:
            op = e[0]
            if op == "put":
                self.register_put(e[1], e[2], e[3], e[4], e[5],
                                  owner=w.worker_id)
            elif op == "refdeltas":
                # packed incref/decref run (codec.fold_refdeltas / opcode 1):
                # one bulk directory call instead of per-id entries
                self._apply_refdeltas(e[1])
            elif op == "submit":
                # pipelined fire-and-forget submit riding the ordered batch
                # (client-derived result ids; errors land in descriptors)
                self.submit_pipelined(e[1], e[2])
            elif op == "incref":
                self._worker_incref_one(w, e[1])
            elif op == "decref":
                self._worker_decref_one(w, e[1])
            elif op == "actor_incref":
                self._worker_actor_incref(w, e[1])
            elif op == "actor_decref":
                self._worker_actor_decref(w, e[1])
            elif op == "open_stream":
                self._worker_open_stream(w, e[1])
            elif op == "close_stream":
                self._worker_close_stream(w, e[1])
            elif op == "task_done":
                # fire-and-forget result publication: the worker appended its
                # completion behind its result puts in the SAME ordered batch
                # (put-before-decref holds transitively), freeing it to start
                # the next task without awaiting this application
                from ..util import metrics
                results = e[2] or []
                metrics.get_or_create(
                    metrics.Counter, "result_async_tasks").inc()
                if results:
                    metrics.get_or_create(
                        metrics.Counter, "result_async_results").inc(
                            len(results))
                    nbytes = sum(r[2] or 0 for r in results)
                    if nbytes:
                        metrics.get_or_create(
                            metrics.Counter, "result_async_bytes").inc(nbytes)
                self._on_task_done(
                    w, {"task_id": e[1], "results": results, "error": e[3],
                        # older 4-tuple entries carry no worker span stamps
                        "span": e[4] if len(e) > 4 else None,
                        # 6-tuple entries ship worker app spans (Chrome
                        # dicts) bound for the head timeline
                        "spans": e[5] if len(e) > 5 else None})

    def apply_batch_local(self, entries):
        """Driver-side batch: same entries, no per-worker tally (driver refs
        die with the session, exactly like the former direct calls)."""
        self._sched_defer += 1
        try:
            for e in entries:
                op = e[0]
                if op == "put":
                    self.register_put(e[1], e[2], e[3], e[4], e[5],
                                      owner="driver")
                elif op == "refdeltas":
                    self._apply_refdeltas(e[1])
                elif op == "submit":
                    self.submit_pipelined(e[1], e[2])
                elif op == "incref":
                    self.incref([e[1]])
                elif op == "decref":
                    self.decref([e[1]])
                elif op == "actor_incref":
                    self.actor_incref(e[1])
                elif op == "actor_decref":
                    self.actor_decref(e[1])
                elif op == "open_stream":
                    self.open_stream(e[1])
                elif op == "close_stream":
                    self.close_stream(e[1])
        finally:
            self._sched_defer -= 1
            if self._sched_defer == 0 and self._sched_dirty:
                self._sched_dirty = False
                self._schedule()

    def _apply_refdeltas(self, blob: bytes):
        """Apply a packed incref/decref run through the sharded directory in
        one call. fold_refdeltas only packs plain object ids ("obj-" prefix),
        so the per-id prefix dispatch of incref()/decref() is not needed; the
        directory skips unknown ids exactly like decref's objects.get miss.
        Eviction verdicts come back per id with end-of-batch semantics: a
        dec-to-zero revived by a later incref in the SAME batch stays alive
        (the old per-entry path would have evicted at the crossing — the
        batch is one atomic unit now, and both directory impls agree)."""
        now = None
        for oid, flags, rc in self.objdir.apply_deltas(blob):
            meta = self.objects.get(oid)
            if meta is None:
                continue
            meta._refcount = rc  # re-sync the mirror past the bulk write
            if flags & _objdir.F_RELEASED and meta.ts_released == 0.0:
                if now is None:
                    now = time.time()
                meta.ts_released = now
            if flags & _objdir.F_EVICTABLE and meta.pinned == 0:
                self._evict(oid)

    async def _worker_get(self, w, p):
        try:
            results = await self.get_descriptors(p["oids"], p.get("timeout"))
            self._reply(w, p["req_id"], results=results)
        except Exception as e:  # noqa: BLE001 - ship the error to the caller
            self._reply(w, p["req_id"], error=e)

    async def _worker_wait(self, w, p):
        try:
            ready, not_ready = await self.wait(p["oids"], p["num_returns"], p.get("timeout"))
            self._reply(w, p["req_id"], ready=ready, not_ready=not_ready)
        except Exception as e:  # noqa: BLE001 - ship the error to the caller
            self._reply(w, p["req_id"], error=e)

    async def _worker_create_pg(self, w, p):
        try:
            pg_id = await self.create_pg_any(p["bundles"], p["strategy"],
                                             p.get("name", ""))
            self._reply(w, p["req_id"], pg_id=pg_id)
        except Exception as e:  # noqa: BLE001 - ship to the caller
            self._reply(w, p["req_id"], error=e)

    async def _worker_next_stream(self, w, p):
        try:
            item = await self.next_stream_item(p["task_id"], p["index"], p.get("timeout"))
            self._reply(w, p["req_id"], item=item)
        except Exception as e:  # noqa: BLE001
            self._reply(w, p["req_id"], error=e)

    # ------------------------------------------------------------- submission
    async def submit(self, spec: TaskSpec,
                     result_oids: List[str] = None) -> List[str]:
        """Async façade over `_submit_sync` for the legacy blocking submit
        RPC and cluster-head forwarding."""
        return self._submit_sync(spec, result_oids)

    def submit_pipelined(self, spec: TaskSpec, result_oids: List[str]):
        """Fire-and-forget submission with CLIENT-derived result ids (ref:
        ObjectID::ForTaskReturn): the client already handed out ObjectRefs
        for `result_oids`, so any submission error must surface through the
        refs' descriptors — never raise back to the transport."""
        if type(self).submit is Controller.submit:
            try:
                self._submit_sync(spec, result_oids)
            except BaseException as err:  # noqa: BLE001 - into descriptors
                self._fail_submit(spec, result_oids, err)
            return
        # subclassed submit (node-agent up-spill) awaits internally: run it
        # as a loop task — created here, so FIFO task scheduling still puts
        # its first step (which sends any uplink frame) ahead of the handling
        # of later frames from the same worker
        task = self.loop.create_task(self.submit(spec, result_oids))

        def _done(t):
            if not t.cancelled() and t.exception() is not None:
                self._fail_submit(spec, result_oids, t.exception())

        task.add_done_callback(_done)

    def _fail_submit(self, spec: TaskSpec, result_oids: List[str], err):
        if not isinstance(err, Exception):  # KeyboardInterrupt etc.
            err = RuntimeError(f"submit failed: {err!r}")
        rec = self.tasks.get(spec.task_id)
        if rec is not None:
            self._fail_task(rec, err)
            return
        # submit died before the TaskRecord existed: error the result
        # objects directly so pending gets raise instead of hanging
        for oid in result_oids:
            meta = self.objects.get(oid)
            if meta is None:
                meta = ObjectMeta(object_id=oid, creating_task=spec.task_id)
                self.objects[oid] = meta
                self.object_events[oid] = asyncio.Event()
            meta.error = err
            meta.location = "error"
            if meta.owner is not None or (self.ownership and spec.owner_id):
                self._push_owned(meta.owner or spec.owner_id,
                                 [(oid, "err", err, 0, 0)])
            self.object_events[oid].set()
            self._resolve_dep(oid)
        st = self.streams.get(spec.task_id)
        if st is not None:
            st.error = err
            st.finished = True
            st.cond.set()

    def _submit_sync(self, spec: TaskSpec,
                     result_oids: List[str] = None) -> List[str]:
        """Register a task; returns result object ids immediately (futures).
        `result_oids` preallocates the ids — used when a cluster head
        forwards a task here (so both controllers name the same objects) and
        by pipelined clients that derived the ids themselves. Deliberately
        synchronous: it must run to completion in one loop step so a
        fire-and-forget submit is fully applied before any later frame."""
        if spec.num_returns == "streaming":
            result_oids = result_oids or [ids.object_id()]  # generator handle
            self.streams[spec.task_id] = StreamState()
        else:
            result_oids = result_oids or [
                ids.object_id() for _ in range(max(spec.num_returns, 1))]
        # ownership: the submitter owns its returns (streaming excluded —
        # generator items flow through head stream state)
        owner = (spec.owner_id if self.ownership and spec.owner_id
                 and spec.num_returns != "streaming" else None)
        for oid in result_oids:
            meta = ObjectMeta(object_id=oid, creating_task=spec.task_id)
            meta.owner = owner
            self.objects[oid] = meta
            self.object_events[oid] = asyncio.Event()
        if spec.owned_inline:
            # owned small-object args ride inside the spec (self-contained
            # across forwarding): seal any the head hasn't seen yet BEFORE
            # dep tracking so the task never waits on an owner round-trip
            for a_oid, (a_mlen, a_size, a_bytes) in spec.owned_inline.items():
                meta = self.objects.get(a_oid)
                if meta is None or meta.location == "pending":
                    self.register_put(a_oid, a_mlen, a_size, a_bytes,
                                      owner=spec.owner_id)
        retries = spec.max_retries
        if spec.actor_id and not spec.is_actor_creation and retries == 0:
            # actor method retries come from the actor's max_task_retries
            # (ref: ray actor fault tolerance; -1 = unlimited)
            actor = self.actors.get(spec.actor_id)
            if actor is not None and actor.options is not None:
                mtr = actor.options.max_task_retries
                retries = (1 << 30) if mtr == -1 else mtr
        rec = TaskRecord(spec=spec, result_oids=result_oids,
                        retries_left=retries, ts_submit=time.time())
        self.tasks[spec.task_id] = rec
        if spec.actor_id and not spec.is_actor_creation:
            # a submitted method pins its target: the caller may drop its
            # handle while this task is still waiting on deps, and the actor
            # must not be GC'd out from under it (released in _unpin)
            self.actor_incref(spec.actor_id)
            rec.pinned_actors.append(spec.actor_id)
        # dependency tracking: top-level ref args must be local before dispatch.
        # Pin every ref arg for the task's lifetime so caller-side GC of the
        # ObjectRef can't evict an argument in flight (ref: task specs hold
        # references in the reference counter, reference_count.cc).
        for kind, v in list(spec.args) + list(spec.kwargs.values()):
            if kind == "ref":
                meta = self.objects.get(v)
                if meta is not None:
                    meta.pinned += 1
                    if meta.ts_pinned == 0.0:
                        meta.ts_pinned = time.time()
                    rec.pinned.append(v)
                if meta is None or meta.location == "pending":
                    rec.deps_remaining.add(v)
                    self.dep_waiters[v].add(spec.task_id)
                elif (meta.location.startswith("remote:")
                        and prefetch_enabled()
                        and self._prefetch_worthwhile(spec, meta)):
                    # queue admission: start moving the bytes NOW, long
                    # before a worker slot frees (dispatch gates in
                    # _enqueue_ready until the pull lands)
                    self._prefetch_request(v)
        # refs buried inside inline arg values: pin (alive) but don't treat as
        # dispatch deps — the task body fetches them itself if it wants them.
        # Actor handles ride the same list (prefix dispatch): the actor stays
        # alive until the task finishes, by which point the worker's
        # deserialized handle holds its own ref.
        for v in spec.nested_refs:
            if v.startswith("actor-"):
                self.actor_incref(v)
                rec.pinned_actors.append(v)
                continue
            if v.startswith("task-"):
                # a generator handle in the args keeps its stream open until
                # the task finishes (released via _unpin's pinned_streams)
                self.open_stream(v)
                rec.pinned_streams.append(v)
                continue
            meta = self.objects.get(v)
            if meta is not None:
                meta.pinned += 1
                if meta.ts_pinned == 0.0:
                    meta.ts_pinned = time.time()
                rec.pinned.append(v)
        self._validate_feasible(rec)
        if rec.state == FAILED:
            if spec.is_actor_creation:
                actor = self.actors.get(spec.actor_id)
                if actor is not None:
                    self._fail_actor(actor, "creation infeasible", allow_restart=False)
            return result_oids
        if rec.deps_remaining:
            rec.state = PENDING_DEPS
        else:
            self._enqueue_ready(rec)
        self._schedule()
        return result_oids

    def _validate_feasible(self, rec: TaskRecord):
        need = rec.spec.resources
        if rec.spec.placement_group_id:
            pg = self.pgroups.get(rec.spec.placement_group_id)
            if pg is None:
                self._fail_task(rec, ValueError("placement group not found"))
            return
        for k, v in need.items():
            if v > self.total.get(k, 0):
                if (self.cluster is not None
                        and self.cluster.feasible_somewhere(need)):
                    return  # a cluster node can host it; placement forwards
                self._fail_task(rec, ValueError(
                    f"Resource request {k}={v} exceeds cluster total {self.total.get(k, 0)} "
                    f"(infeasible; reference behavior: hang + warning — we fail fast)"))
                return

    def _enqueue_ready(self, rec: TaskRecord):
        rec.state = PENDING
        # PG-bound work whose group vanished while it waited on deps can
        # never dispatch — fail it now rather than queue it forever
        if (rec.spec.placement_group_id
                and rec.spec.placement_group_id not in self.pgroups):
            self._fail_pg_task(rec, rec.spec.placement_group_id)
            return
        if rec.spec.actor_id and not rec.spec.is_actor_creation:
            actor = self.actors.get(rec.spec.actor_id)
            if actor is None:
                self._fail_task(rec, exc.ActorDiedError(rec.spec.actor_id, "unknown actor"))
                return
            if actor.state == A_DEAD:
                self._fail_task(rec, exc.ActorDiedError(actor.actor_id, actor.death_reason))
                return
            if actor.node_id is not None and self.cluster is not None:
                # the actor lives on a cluster node: methods follow it
                node = self.cluster.nodes.get(actor.node_id)
                if node is None or not node.alive:
                    self._fail_task(rec, exc.ActorDiedError(
                        actor.actor_id, f"node {actor.node_id} died"))
                    return
                if rec.spec.num_returns == "streaming":
                    self._fail_task(rec, ValueError(
                        "streaming generator methods on remote-node actors "
                        "are not supported yet; place the actor on the head "
                        "node (NodeAffinity) to stream"))
                    return
                actor.in_flight.add(rec.spec.task_id)
                self.cluster.forward_method(rec, node)
                return
            if self._gate_on_prefetch(rec):
                return  # head-hosted actor: hold until eager pulls land
            actor.queue.append(rec)
        else:
            if (self.cluster is not None
                    and rec.spec.placement_group_id):
                pg = self.pgroups.get(rec.spec.placement_group_id)
                if pg is not None:
                    idx = rec.spec.placement_group_bundle_index
                    bundle = pg.bundles[idx if idx >= 0 else 0]
                    if bundle.node_id is not None:
                        # the bundle lives on a worker node: the task follows
                        node = self.cluster.nodes.get(bundle.node_id)
                        if node is None or not node.alive:
                            self._fail_pg_task(
                                rec, rec.spec.placement_group_id,
                                reason=f"bundle {idx}'s host node "
                                       f"{bundle.node_id} is not alive")
                            return
                        if rec.spec.num_returns == "streaming":
                            self._fail_task(rec, ValueError(
                                "streaming tasks bound to a remote-node "
                                "bundle are not supported yet"))
                            return
                        self.cluster.forward_pg_task(rec, node, bundle)
                        return
            if (self.cluster is not None and self.cluster.nodes
                    and not rec.spec.placement_group_id
                    and rec.spec.num_returns != "streaming"):
                node = self.cluster.place(rec)
                if rec.state == FAILED:
                    return  # hard NodeAffinity to a dead node
                if node is not None:
                    # actor-creation options resolve inside _forward
                    self.cluster.forward_task(rec, node)
                    return
            if self._gate_on_prefetch(rec):
                return  # head-bound task: hold until eager pulls land
            self.ready_queue.append(rec)

    # -------------------------------------------------------------- scheduling
    def _resources_fit(self, need: Dict[str, float], pool: Dict[str, float]) -> bool:
        return all(pool.get(k, 0) + 1e-9 >= v for k, v in need.items())

    def res_total(self) -> Dict[str, float]:
        """Cluster-wide totals (just this host when not clustered)."""
        return self.cluster.totals() if self.cluster else dict(self.total)

    def res_available(self) -> Dict[str, float]:
        return self.cluster.availables() if self.cluster else dict(self.available)

    def _claim(self, need: Dict[str, float], pool: Optional[Dict[str, float]]):
        # pool None = the task's placement group was removed while it ran.
        # Removal returns only each bundle's UNCLAIMED remainder to the
        # cluster pool, so in-flight claims settle here: both claim (blocked
        # task resuming) and release (task finishing) fall back to the
        # cluster pool, keeping `available` exact instead of transiently
        # over-committed.
        if pool is None:
            pool = self.available
        for k, v in need.items():
            pool[k] = pool.get(k, 0) - v
        self.ready_queue.adjust(pool, need, -1)

    def _release(self, need: Dict[str, float], pool: Optional[Dict[str, float]]):
        if pool is None:
            pool = self.available  # see _claim: settle removed-PG claims
        for k, v in need.items():
            pool[k] = pool.get(k, 0) + v
        self.ready_queue.adjust(pool, need, +1)

    def _task_pool(self, spec: TaskSpec) -> Optional[Dict[str, float]]:
        """The pool a task draws from; None when its placement group is gone
        (the task is being failed by remove_placement_group)."""
        if spec.placement_group_id:
            pg = self.pgroups.get(spec.placement_group_id)
            if pg is None:
                return None
            idx = spec.placement_group_bundle_index
            bundle = pg.bundles[idx if idx >= 0 else 0]
            return bundle.available
        return self.available

    def _schedule(self):
        """Greedy dispatch loop; called after every state change (ref:
        raylet's ScheduleAndDispatchTasks)."""
        if self._shutdown:
            return
        if self._sched_defer:
            self._sched_dirty = True  # batch application runs us once, at end
            return
        buf: Dict[object, list] = {}
        self._dispatch_buf = buf
        try:
            self._schedule_pass()
        finally:
            self._dispatch_buf = None
            for writer, frames in buf.items():
                try:
                    writer.write(frames[0] if len(frames) == 1
                                 else b"".join(frames))
                except (ConnectionResetError, BrokenPipeError, OSError):
                    pass  # worker died mid-pass; the reaper handles it

    def _schedule_pass(self):
        # 1. plain tasks → idle pool workers: the batched native pass by
        # default, the per-dispatch oracle loop under RAY_TPU_NATIVE=0 /
        # RAY_TPU_NATIVE_SCHED=0 (and as the reference the equivalence tests
        # hold the batch path to).
        if self._sched_batch:
            self._dispatch_ready_batch()
        else:
            self._dispatch_ready_oracle()
        # spawn workers to match queued demand (never more than cpu slots),
        # grouped by runtime_env so each env gets workers built for it.
        # Aggregated per signature — O(#signatures), not O(pending tasks).
        demand: Dict[Optional[str], int] = {}
        gpu_demand: Dict[Optional[str], int] = {}
        env_specs: Dict[Optional[str], Optional[dict]] = {}
        for meta, n in self.ready_queue.demand_by_sig():
            key = meta["env_key"]
            env_specs.setdefault(key, meta["runtime_env"])
            if meta["gpu"]:
                gpu_demand[key] = gpu_demand.get(key, 0) + n
            else:
                demand[key] = demand.get(key, 0) + n
        self._spawn_for_demand(demand, gpu_demand, env_specs)
        # 2. actor method calls → their dedicated workers
        for actor in self.actors.values():
            if actor.state != A_ALIVE:
                continue
            w = self.workers.get(actor.worker_id)
            if w is None:
                continue
            limit = max(actor.options.max_concurrency, 1) if actor.options else 1
            while actor.queue and len(actor.in_flight) < limit:
                rec = actor.queue.popleft()
                if rec.state != PENDING:
                    continue
                actor.in_flight.add(rec.spec.task_id)
                self._dispatch(rec, w)

    def _dispatch_ready_oracle(self):
        # The ready index returns the earliest queued task whose demand fits
        # its pool among signatures with an idle matching worker; the mask is
        # rebuilt per dispatch so one pass drains everything currently
        # dispatchable. A signature is deferred for the rest of this pass
        # when its env is still building or the index/dict accounting
        # disagrees (invariant re-check).
        deferred: Set[int] = set()
        while True:
            rec, sig, seq = self.ready_queue.next_rec(
                self.ready_queue.sig_mask(deferred))
            if seq == -1:
                break
            if rec is None or rec.state != PENDING:
                self.ready_queue.drop_seq(seq)
                continue
            pool = self._task_pool(rec.spec)
            if pool is None or not self._resources_fit(rec.spec.resources, pool):
                deferred.add(sig)  # mirror drift; dict pool is the truth
                continue
            if rec.spec.is_actor_creation:
                self.ready_queue.take(rec)
                if not self._start_actor_worker(rec, pool):
                    deferred.add(sig)  # env building; rec was re-queued
                continue
            w = self._find_idle_worker(
                need_gpu=rec.spec.resources.get("GPU", 0) > 0,
                env_key=runtime_env_key(rec.spec.runtime_env))
            if w is None:
                deferred.add(sig)
                continue
            self.ready_queue.take(rec)
            self._claim(rec.spec.resources, pool)
            self._assign_gpus(rec)
            self._dispatch(rec, w)

    def _dispatch_ready_batch(self):
        """Batched schedule pass: one `schedule_batch` call (sq_schedule —
        a single GIL release on the native queue) selects, pops, and claims
        every dispatchable task; Python then only applies the decisions
        (validate against the dict truth, pick the concrete idle worker,
        assign GPUs, build the exec frame). Actor creations act as barriers:
        the native pass stops where the oracle loop would have run
        `_start_actor_worker`, Python handles the creation, and the pass
        resumes — preserving the oracle's exact FIFO interleaving."""
        rq = self.ready_queue
        deferred: Set[int] = set()
        while True:
            if not rq.recs:
                return
            modes, buckets, idle_counts = rq.batch_inputs(deferred)
            decisions, barrier_sig, barrier_seq = rq.q.schedule_batch(
                modes, buckets, idle_counts, max_out=_SCHED_BATCH_MAX)
            undid = False
            for seq, sig in decisions:
                rec = rq.recs.pop(seq, None)
                meta = rq._sig_meta[sig]
                if rec is None or rec.state != PENDING:
                    rq.unclaim(sig)  # stale entry: drop it, refund the claim
                    continue
                pool = self._task_pool(rec.spec)
                if pool is None or not self._resources_fit(rec.spec.resources,
                                                           pool):
                    # index/dict drift: dict pool is the truth — refund the
                    # native claim, requeue, and sit the signature out
                    rq.unclaim(sig)
                    deferred.add(sig)
                    rq.append(rec)
                    undid = True
                    continue
                w = self._find_idle_worker(meta["gpu"], meta["env_key"])
                if w is None:
                    rq.unclaim(sig)
                    deferred.add(sig)
                    rq.append(rec)
                    undid = True
                    continue
                # dict-side claim WITHOUT re-mirroring — the native pass
                # already debited its pool for this decision
                for k, v in rec.spec.resources.items():
                    pool[k] = pool.get(k, 0) - v
                self._assign_gpus(rec)
                self._dispatch(rec, w)
            if barrier_sig >= 0:
                # actor creation won the FIFO race: handle it exactly like
                # the oracle iteration would, then resume the batch pass
                rec = rq.recs.get(barrier_seq)
                if rec is None or rec.state != PENDING:
                    rq.drop_seq(barrier_seq)
                    continue
                pool = self._task_pool(rec.spec)
                if pool is None or not self._resources_fit(
                        rec.spec.resources, pool):
                    deferred.add(barrier_sig)
                    continue
                rq.take(rec)
                if not self._start_actor_worker(rec, pool):
                    deferred.add(barrier_sig)  # env building; rec re-queued
                continue
            if undid or len(decisions) >= _SCHED_BATCH_MAX:
                continue  # refunds freed resources / output array was full
            return

    def _find_idle_worker(self, need_gpu: bool = False,
                          env_key: Optional[str] = None) -> Optional[WorkerConn]:
        bucket = self.idle_index.get((need_gpu, env_key))
        if not bucket:
            return None
        for wid in list(bucket):
            w = bucket[wid]
            if w.state == "idle" and w.actor_id is None:
                return w
            del bucket[wid]  # stale entry: self-heal and keep looking
        return None

    _SPAWN_FAILURE_LIMIT = 5

    def _note_spawn_failure(self, env_key: Optional[str], err: Exception):
        """A worker Popen failed (the env itself already built — _env_ready
        gates every spawn). Transient causes (fork EAGAIN) resolve on the
        _reaper's next 1s _schedule pass; persistent ones (cached venv
        interpreter deleted from under us) would otherwise retry silently
        forever, so after N consecutive failures fail the queued work."""
        n = self._spawn_failures.get(env_key, 0) + 1
        self._spawn_failures[env_key] = n
        print(f"[controller] worker spawn failed for env {env_key!r} "
              f"({n}/{self._SPAWN_FAILURE_LIMIT}): {err!r}", file=sys.stderr)
        if n >= self._SPAWN_FAILURE_LIMIT:
            self._spawn_failures.pop(env_key, None)
            self._fail_env_tasks(env_key, exc.RuntimeEnvSetupError(
                f"worker spawn failed {n} times in a row: {err}"))

    def _fail_env_tasks(self, env_key: Optional[str], err: Exception):
        """Runtime env build failed: fail every queued task/actor needing it."""
        for rec in list(self.ready_queue):
            if (rec.state == PENDING
                    and runtime_env_key(rec.spec.runtime_env) == env_key):
                if rec.spec.is_actor_creation:
                    actor = self.actors.get(rec.spec.actor_id)
                    if actor is not None:
                        self._fail_actor(actor, f"runtime_env setup failed: {err}",
                                         allow_restart=False)
                else:
                    self._fail_task(rec, exc.RuntimeEnvSetupError(str(err)))

    def _env_ready(self, runtime_env: Optional[dict]) -> bool:
        """True when the task's runtime env is built (default env counts).
        Otherwise kicks an off-loop build (venv creation + pip installs run
        in an executor thread; the event loop keeps scheduling everything
        else) and returns False — the caller leaves the work queued, and the
        completion callback re-runs _schedule."""
        key = runtime_env_key(runtime_env)
        if self.runtime_envs.is_built(key):
            return True
        if key in self._env_building:
            return False
        self._env_building.add(key)
        fut = self.loop.run_in_executor(
            None, self.runtime_envs.get_context, runtime_env)

        def _done(f):
            self._env_building.discard(key)
            err = f.exception()
            if err is not None:
                self._fail_env_tasks(key, err)
            self._schedule()

        fut.add_done_callback(_done)
        return False

    def _spawn_for_demand(self, demand: Dict[Optional[str], int],
                          gpu_demand: Dict[Optional[str], int],
                          env_specs: Dict[Optional[str], Optional[dict]]):
        n_alive = sum(1 for w in list(self.workers.values()) + list(self.spawning.values())
                      if w.actor_id is None and w.state not in ("dead", "driver"))
        n_blocked = sum(1 for w in self.workers.values()
                        if w.actor_id is None and w.blocked_tasks)
        headroom = self.max_workers - (n_alive - n_blocked)
        for env_key, n in demand.items():
            if not self._env_ready(env_specs.get(env_key)):
                continue  # async build in flight; tasks stay queued
            spawning = sum(1 for w in self.spawning.values()
                           if w.actor_id is None and not w.gpu_capable
                           and w.env_key == env_key)
            for _ in range(max(0, n - spawning)):
                if headroom <= 0:
                    # pool full of OTHER envs' idle workers → recycle one, or
                    # this env's demand would starve forever (workers are
                    # env-dedicated; cross-env dispatch is never allowed)
                    victim = next(
                        (w for w in self.workers.values()
                         if w.state == "idle" and w.actor_id is None
                         and not w.gpu_capable and w.env_key != env_key),
                        None)
                    if victim is None:
                        break
                    self._retire_idle_worker(victim)
                    headroom += 1
                try:
                    self._spawn_worker(env_key=env_key,
                                       runtime_env=env_specs.get(env_key))
                except Exception as e:  # noqa: BLE001
                    self._note_spawn_failure(env_key, e)
                    break
                self._spawn_failures.pop(env_key, None)
                headroom -= 1
        # GPU pool-workers: one persistent worker serves the card queue (a
        # second process can't initialize the platform while the first
        # computes, so more would just block at startup). If the sole worker
        # was built for a different runtime_env and sits idle, recycle it.
        for env_key in gpu_demand:
            gpu_workers = [
                w for w in list(self.workers.values()) + list(self.spawning.values())
                if w.actor_id is None and w.gpu_capable and w.state != "dead"]
            if any(w.env_key == env_key for w in gpu_workers):
                continue
            if any(w.state != "idle" or w.running for w in gpu_workers):
                # a busy OR still-starting worker owns the card; never run
                # two processes against the platform at once
                continue
            if not self._env_ready(env_specs.get(env_key)):
                continue
            for w in gpu_workers:
                self._retire_idle_worker(w)
            try:
                self._spawn_worker(gpu_capable=True, env_key=env_key,
                                   runtime_env=env_specs.get(env_key))
            except Exception as e:  # noqa: BLE001
                self._note_spawn_failure(env_key, e)
            else:
                self._spawn_failures.pop(env_key, None)
            break

    # ------------------------------------------------------------ autoscaler
    def request_resources(self, num_cpus=None, bundles=None) -> dict:
        """Autoscaler hook (ref: python/ray/autoscaler/sdk.py
        request_resources → autoscaler/_private/autoscaler.py:1-1572). The
        reference records the demand and adds nodes; on one host the
        "cluster" is the worker pool, so meeting the request means warming
        idle CPU workers up to it, bounded by max_workers. A bundle's cards
        are "GPU", the resource GPU nodes advertise (their bound cards). Overwrite
        semantics (a new call replaces the prior request), like the
        reference. Returns what was fulfilled vs clamped."""
        target = int(num_cpus or 0)
        target_gpus = 0.0
        for b in bundles or []:
            target += int(b.get("CPU", 0) or 0)
            target_gpus += float(b.get("GPU", 0) or 0)
        self.resource_requests = {
            "num_cpus": num_cpus, "bundles": bundles, "target_cpus": target,
            "target_gpus": target_gpus, "ts": time.time()}
        n_alive = sum(
            1 for w in list(self.workers.values()) + list(self.spawning.values())
            if w.actor_id is None and not w.gpu_capable
            and w.state not in ("dead", "driver"))
        want = min(target, self.max_workers)
        spawned = 0
        for _ in range(max(0, want - n_alive)):
            self._spawn_worker()
            spawned += 1
        # beyond this host: ask the node provider for worker NODES (ref: the
        # reference autoscaler's StandardAutoscaler adding nodes through its
        # NodeProvider). Launched-but-unregistered capacity counts, so a
        # repeated request doesn't double-launch; dead handles are pruned so
        # a crashed node doesn't count as capacity forever.
        launched_nodes = []
        # without a provider, a GPU demand beyond current capacity can never
        # be met — report it clamped instead of silently "satisfied"
        clamped = (target > want
                   or target_gpus > self.res_total().get("GPU", 0.0)
                   + 1e-9)
        if (self.cluster is not None and self.node_provider is not None
                and (target > 0 or target_gpus > 0)):
            live = set(self.node_provider.non_terminated_nodes())
            self._provider_nodes = {
                h: c for h, c in self._provider_nodes.items() if h in live}
            # registered nodes (provider-launched or manually joined) are in
            # res_total; add only the promise of live handles whose agent
            # has not registered yet (matched by pid when the provider can)
            pid_of = getattr(self.node_provider, "pid_of", lambda _h: None)
            pids_of = getattr(self.node_provider, "pids_of", None)
            reg_pids = {n.pid for n in self.cluster.nodes.values()}
            # pid-less providers (real cloud APIs) drain promises by
            # counting registered nodes carrying their marker resource
            marker = getattr(self.node_provider, "registration_marker", None)
            hosts_per_handle = float(getattr(self.node_provider,
                                             "hosts_per_node", 1.0)) or 1.0
            marker_arrived = (sum(
                1 for n in self.cluster.nodes.values()
                if n.alive and n.resources.get(marker))
                if marker is not None else 0.0)
            promised = {"CPU": 0.0, "GPU": 0.0}
            for h, c in self._provider_nodes.items():
                pids = pids_of(h) if pids_of is not None else None
                if pids:
                    # multi-host handles (GPU slices): the promise drains
                    # fractionally as each host registers — a half-arrived
                    # pod must not trigger a second whole-pod launch
                    frac = (sum(1 for p in pids if p not in reg_pids)
                            / len(pids))
                elif pids is None and marker is not None:
                    # attribute arrived marker hosts to handles oldest-first
                    take = min(hosts_per_handle, marker_arrived)
                    marker_arrived -= take
                    frac = 1.0 - take / hosts_per_handle
                else:
                    frac = 0.0 if pid_of(h) in reg_pids else 1.0
                promised["CPU"] += c.get("CPU", 0.0) * frac
                promised["GPU"] += c.get("GPU", 0.0) * frac
            per_node = {
                "CPU": float(getattr(self.node_provider, "cpus_per_node",
                                     2.0)),
                "GPU": float(getattr(self.node_provider,
                                          "gpus_per_node", 0.0))}
            totals = self.res_total()
            projected = {
                "CPU": totals.get("CPU", 0.0) + promised["CPU"],
                "GPU": totals.get("GPU", 0.0)
                + promised["GPU"]}

            def unmet():
                cpu_short = (projected["CPU"] + 1e-9 < target
                             and per_node["CPU"] > 0)
                gpu_short = (projected["GPU"] + 1e-9 < target_gpus
                             and per_node["GPU"] > 0)
                return cpu_short or gpu_short

            # zero-valued entries must not reach providers as resources
            # (a subprocess node would register a pointless GPU: 0)
            launch_res = {k: v for k, v in per_node.items() if v > 0}
            while unmet() and len(self._provider_nodes) < \
                    self.provider_max_nodes:
                try:
                    handle = self.node_provider.create_node(
                        launch_res, self.cluster.address)
                except Exception as e:  # noqa: BLE001 - provisioning failure
                    print(f"[autoscaler] node launch failed: {e!r}",
                          file=sys.stderr)
                    break
                self._provider_nodes[handle] = dict(per_node)
                launched_nodes.append(handle)
                projected["CPU"] += per_node["CPU"]
                projected["GPU"] += per_node["GPU"]
            clamped = (projected["CPU"] + 1e-9 < target
                       or projected["GPU"] + 1e-9 < target_gpus)
        return {"target_cpus": target, "fulfilled_cpus": want,
                "target_gpus": target_gpus, "clamped": clamped,
                "spawned_workers": spawned, "launched_nodes": launched_nodes}

    def set_node_provider(self, provider, max_nodes: int = 4):
        """Install the provisioning backend for cluster scale-up (ref:
        autoscaler NodeProvider). Requires a cluster head (cluster_port)."""
        if self.cluster is None:
            raise ValueError("node providers require a cluster head: "
                             "init(cluster_port=...) first")
        self.node_provider = provider
        self.provider_max_nodes = max_nodes
        # installing a provider arms the alert-driven reaction loop (dead
        # node replacement, pressure scale-up); RAY_TPU_AUTOSCALE=0 keeps
        # provisioning strictly manual
        if autoscale_enabled():
            from ..autoscaler.reconciler import Reconciler
            self.reconciler = Reconciler(self)
        else:
            self.reconciler = None

    def autoscaler_status(self) -> dict:
        workers = list(self.workers.values()) + list(self.spawning.values())
        pool = [w for w in workers if w.actor_id is None
                and w.state not in ("dead", "driver")]
        out = {
            "request": dict(self.resource_requests),
            "max_workers": self.max_workers,
            "pool_workers": len(pool),
            "idle_workers": sum(1 for w in pool if w.state == "idle"),
            "pending_tasks": len(self.ready_queue),
            "total": self.res_total(),
            "available": self.res_available(),
        }
        if self.cluster is not None:
            out["nodes"] = len(self.cluster.nodes) + 1
            out["provider_nodes"] = list(self._provider_nodes)
        if self.reconciler is not None:
            out["reconciler"] = self.reconciler.status()
        return out

    def chaos_op(self, op: dict) -> dict:
        """Dev chaos surface behind /api/chaos (see _private/chaos.py).
        Ops: snapshot (default — injector state + live node pid map),
        configure (arm/seed/probabilities at runtime), drop_object (delete
        a head-local shm segment → lineage path), kill_node (SIGKILL a
        registered node agent's process group by node_id → death path)."""
        from . import chaos as _chaos
        what = op.get("op", "snapshot")
        if what == "snapshot":
            out = _chaos.get_injector().snapshot()
            out["nodes"] = (
                {n.node_id: n.pid for n in self.cluster.nodes.values()
                 if n.alive}
                if self.cluster is not None else {})
            return out
        if what == "configure":
            kw = {k: v for k, v in op.items() if k != "op"}
            return _chaos.get_injector().configure(**kw)
        if what == "drop_object":
            return {"dropped": _chaos.ChaosInjector.drop_object(
                self, op.get("oid", ""))}
        if what == "kill_node":
            node = (self.cluster.nodes.get(op.get("node_id"))
                    if self.cluster is not None else None)
            if node is None or not node.pid:
                return {"killed": False, "error": "unknown node"}
            return {"killed": _chaos.ChaosInjector.kill_node_pid(node.pid),
                    "pid": node.pid}
        raise ValueError(f"unknown chaos op {what!r}")

    # ------------------------------------------------- health signal plane
    def health_snapshot(self) -> dict:
        """This process's node-local health gauges. On the head this is the
        head row of cluster_health(); on node agents the same dict rides
        every heartbeat (node_agent._heartbeat) — no extra round trips."""
        busy = sum(1 for w in self.workers.values() if w.state == "busy")
        idle = sum(1 for w in self.workers.values() if w.state == "idle")
        pool = busy + idle
        from . import object_store as _os_mod
        return {
            "ts": time.time(),
            "queue_depth": len(self.ready_queue),
            # tasks parked on unresolved deps (deduped: one task can wait on
            # several objects)
            "dispatch_backlog": len({tid for s in self.dep_waiters.values()
                                     for tid in s}),
            "workers_total": len(self.workers),
            "workers_busy": busy,
            "workers_idle": idle,
            "worker_occupancy": (busy / pool) if pool else 0.0,
            "store_used": self.store_used,
            "store_capacity": self.store_capacity,
            "store_free": max(self.store_capacity - self.store_used, 0),
            "store_spilled_bytes": self.store_spilled_bytes,
            "store_pinned_bytes": sum(m.size for m in self.objects.values()
                                      if m.pinned > 0 and m.location == "shm"),
            "store_objects": len(self.objects),
            "store_alloc_failures": _os_mod.alloc_failures(),
        }

    def cluster_health(self) -> dict:
        """Aggregate health view served at GET /api/cluster and by
        `python -m ray_tpu_torch status`: one row per node (head first), dead-node
        tombstones included so a killed node stays visible, plus resource
        totals, the alert tail, and the current leak list."""
        now = time.time()
        head = dict(self.health_snapshot())
        head.update(node_id=self.node_id, is_head=True, alive=True,
                    host="head", heartbeat_age_s=0.0)
        rows = [head]
        live = {self.node_id}
        if self.cluster is not None:
            for n in list(self.cluster.nodes.values()):
                live.add(n.node_id)
                row = dict(n.health or {})
                row.update(node_id=n.node_id, is_head=False, alive=n.alive,
                           host=n.host,
                           heartbeat_age_s=max(now - n.last_seen, 0.0),
                           hb_interval_s=n.hb_interval_s,
                           hb_latency_s=n.hb_latency_s,
                           inflight=len(n.inflight))
                rows.append(row)
        for node_id, tomb in self.health.dead_nodes.items():
            if node_id not in live:
                rows.append(dict(tomb))
        alerts = self.health.alerts
        return {
            "ts": now,
            "nodes": rows,
            "resources": {"total": self.res_total(),
                          "available": self.res_available()},
            "queue": {"ready": len(self.ready_queue),
                      "pending_deps": len({tid for s in self.dep_waiters.values()
                                           for tid in s})},
            "alerts": {"count": len(alerts.events()),
                       "active": alerts.active_count(),
                       "recent": alerts.events()[-5:]},
            "leaks": list(self.health.leaks),
        }

    def _spawn_worker(self, actor: ActorRecord = None,
                      gpu_capable: bool = False,
                      env_key: Optional[str] = None,
                      runtime_env: Optional[dict] = None) -> WorkerConn:
        if actor is not None and actor.creation_spec is not None:
            runtime_env = actor.creation_spec.runtime_env
            env_key = runtime_env_key(runtime_env)
        # build (or fetch cached) runtime env BEFORE claiming a worker id —
        # raises on bad py_modules paths / failed pip installs
        renv_ctx = self.runtime_envs.get_context(runtime_env)
        wid = ids.worker_id()
        env = dict(os.environ)
        env["RTPT_WORKER_ID"] = wid
        # spawned workers have no reply channel on register: ship the codec
        # ceiling in the env; the worker sends min(env, its own version)
        env["RTPT_CODEC_VER"] = str(_codec.wire_version())
        # joins worker log records to traces (logging_config.ContextFilter)
        env["RTPT_NODE_ID"] = self.node_id
        # Propagate the driver's sys.path so by-reference cloudpickle (module
        # -level fns/classes) resolves in workers even when the driver added
        # path entries at runtime (pytest rootdir insertion, scripts mutating
        # sys.path) — the reference assumes identical envs across the cluster.
        extra = [p if p else os.getcwd() for p in sys.path
                 if p == "" or os.path.isdir(p)]
        extra += [p for p in self.driver_paths if p not in extra and os.path.isdir(p)]
        if extra:
            env["PYTHONPATH"] = os.pathsep.join(
                extra + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        if actor is not None:
            gpu_capable = (actor.creation_spec is not None and
                           actor.creation_spec.resources.get("GPU", 0) > 0)
            env.update({k: str(v) for k, v in (actor.env or {}).items()})
            # the worker's exec pool honors the actor's declared concurrency
            # (ref: ray core max_concurrency) instead of a fixed 64 threads
            mc = getattr(actor.options, "max_concurrency", 1) or 1
            env["RTPT_MAX_CONCURRENCY"] = str(max(1, int(mc)))
        if not gpu_capable:
            # the card-binding vars removed and CUDA_VISIBLE_DEVICES empty
            # (util/gpu.py is their single source of truth)
            env = scrub_accel_env(env)
            env["JAX_PLATFORMS"] = "cpu"
        renv_ctx.apply(env)  # env_vars, staged py_modules/working_dir paths
        proc = subprocess.Popen(
            [renv_ctx.python_exe, "-m", "ray_tpu_torch._private.worker_main",
             self.socket_path, wid],
            env=env, stdin=subprocess.DEVNULL)
        w = WorkerConn(worker_id=wid, proc=proc,
                       actor_id=actor.actor_id if actor else None,
                       gpu_capable=gpu_capable, env_key=env_key)
        self.spawning[wid] = w
        return w

    def _start_actor_worker(self, rec: TaskRecord, pool: Dict[str, float]) -> bool:
        """Actor creation always gets a dedicated worker (ref: raylet leases a
        worker for the actor's lifetime). GPU actors get card binding env.
        Returns False (rec left queued) while its runtime env is still
        building asynchronously."""
        if not self._env_ready(rec.spec.runtime_env):
            self.ready_queue.append(rec)
            return False
        self._claim(rec.spec.resources, pool)
        actor = self.actors[rec.spec.actor_id]
        actor.resources_claimed = True
        rec.state = "SPAWNING"
        self._assign_gpus(rec, actor)
        try:
            self._spawn_worker(actor)
        except Exception as e:  # noqa: BLE001 - runtime_env build failure
            self._fail_actor(actor, f"runtime_env setup failed: {e}",
                             allow_restart=False)
        return True

    def _assign_gpus(self, rec: TaskRecord, actor: ActorRecord = None):
        n = int(rec.spec.resources.get("GPU", 0))
        if n <= 0:
            return
        if len(self.gpu_free) < n:
            # accounting says it fits, so this is an internal invariant break —
            # fail loudly rather than silently under-assigning cards
            raise RuntimeError(
                f"GPU accounting mismatch: need {n} cards, free list has "
                f"{self.gpu_free}")
        assigned, self.gpu_free = self.gpu_free[:n], self.gpu_free[n:]
        rec.spec.runtime_env = dict(rec.spec.runtime_env or {})
        rec.spec.runtime_env["_gpu_ids"] = assigned
        if actor is not None:
            # the actor's release reads its cards from its creation spec: an
            # actor created from a worker (a serve controller's replica)
            # registers one copy of the spec and submits another, so the
            # ids go on both, or a killed replica's card never returns
            if actor.creation_spec is not None:
                actor.creation_spec.runtime_env = rec.spec.runtime_env
            # card visibility must be set before the new process starts
            # CUDA; a pooled worker's visibility cannot change under a live
            # CUDA context, so a task gets its ids in runtime_env only
            actor.env["CUDA_VISIBLE_DEVICES"] = ",".join(_physical_cards(assigned))
            actor.env["RTPT_GPU_IDS"] = ",".join(map(str, assigned))

    def _dispatch(self, rec: TaskRecord, w: WorkerConn):
        rec.state = RUNNING
        rec.worker_id = w.worker_id
        rec.ts_start = time.time()
        w.running.add(rec.spec.task_id)
        if w.actor_id is None:
            w.state = "busy"
            self._unmark_idle(w)
        if prefetch_enabled():
            # natively coded (KIND_EXEC) when the worker negotiated
            # codec_ver > 0 — the dispatch hot path skips pickle like the
            # batch plane does; exotic specs fall back inside frame_bytes
            frame = protocol.frame_bytes("exec", dict(
                spec=rec.spec, result_oids=rec.result_oids,
                arg_descs=self._arg_descriptors(rec)),
                codec_on=w.codec_ver > 0)
        else:  # legacy frame, byte-identical to the pre-prefetch protocol
            frame = protocol.frame_bytes("exec", dict(
                spec=rec.spec, result_oids=rec.result_oids))
        buf = self._dispatch_buf
        if buf is None:
            w.writer.write(frame)
        else:
            # inside a _schedule pass: coalesce every exec frame bound for
            # the same worker into one transport write (framing makes the
            # byte stream identical either way)
            buf.setdefault(w.writer, []).append(frame)

    # -------------------------------------------------------------- completion
    def _on_task_done(self, w: WorkerConn, p: dict):
        task_id = p["task_id"]
        rec = self.tasks.get(task_id)
        w.running.discard(task_id)
        if task_id in w.blocked_tasks:
            # done while marked blocked (no unblocked msg): re-claim the CPU
            # released at block time so the release below stays balanced
            w.blocked_tasks.discard(task_id)
            if rec is not None:
                self._reclaim_blocked_cpu(rec)
        if w.actor_id is None and not w.running:
            w.state = "idle"
            self._mark_idle(w)
        if rec is None:
            self._schedule()
            return
        rec.ts_end = time.time()
        # raw tuple; formatted lazily at timeline query (format_timeline)
        self.timeline_events.append(
            ("_task", rec.spec.name or task_id, w.pid or 1, rec.ts_start,
             rec.ts_end, rec.spec.trace_id, task_id))
        self._record_task_spans(rec, w.pid or 1, p.get("span"))
        shipped = p.get("spans")
        if shipped:
            # worker app spans (tracing.ship_window — already Chrome dicts;
            # format_timeline passes dicts through). On a worker node this
            # controller's outbox forwards them to the head via heartbeat.
            self.timeline_events.extend(shipped)
            if getattr(self, "span_ship", False):
                outbox = self.span_outbox
                outbox.extend(shipped)
                if len(outbox) > 20000:
                    del outbox[:len(outbox) - 20000]
        spec = rec.spec
        actor = self.actors.get(spec.actor_id) if spec.actor_id else None
        if actor is not None and not spec.is_actor_creation:
            actor.in_flight.discard(task_id)
        err = p.get("error")
        if err is not None and rec.cancelled:
            err = exc.TaskCancelledError(task_id)
        if err is not None:
            retryable = (not spec.actor_id and rec.retries_left > 0 and
                         (spec.retry_exceptions or isinstance(err, exc.WorkerCrashedError))
                         and not rec.cancelled)
            if retryable:
                rec.retries_left -= 1
                self._release_task_resources(rec)
                self._enqueue_ready(rec)
                self._schedule()
                return
            self._fail_task(rec, err)
            if spec.is_actor_creation and actor is not None:
                self._fail_actor(actor, f"creation failed: {err}", allow_restart=False)
            self._release_task_resources(rec)
            self._schedule()
            if actor is not None and actor.pending_gc:
                self._maybe_gc_actor(actor)
            return
        # success: record result objects (owner attribution: the executing
        # worker — if it also OWNS a result, register_put skips the push and
        # the worker resolved its own table at put_result time)
        for oid, meta_len, size, inline, contained in p["results"]:
            self.register_put(oid, meta_len, size, inline, contained,
                              owner=w.worker_id)
        if spec.num_returns == "streaming":
            st = self.streams.get(task_id)
            if st:
                st.finished = True
                st.cond.set()
                self._maybe_drop_stream(task_id, st)  # already abandoned?
        rec.state = DONE
        rec.done.set()
        self._mark_task_terminal(rec)
        if spec.is_actor_creation and actor is not None:
            if actor.state == A_DEAD:
                # killed while creation was in flight: don't resurrect
                self._kill_worker_proc(w)
            else:
                actor.state = A_ALIVE
                actor.worker_id = w.worker_id
        self._release_task_resources(rec)
        if not (spec.is_actor_creation and actor is not None and actor.state != A_DEAD
                and actor.options is not None and actor.options.max_restarts != 0):
            # a restartable actor's creation arguments stay pinned: a restart
            # runs the creation spec again (released at its final death)
            self._unpin(rec)
        self._schedule()
        if actor is not None and actor.pending_gc:
            self._maybe_gc_actor(actor)

    def _record_task_spans(self, rec: TaskRecord, tid, wspan):
        """Derive the task's per-phase spans at completion:

          queued   = submit -> dispatch (dep wait + queue + gate)
          prefetch = eager-pull wall window(s) claimed for its args
                     (overlaps `queued` by design — that IS the overlap the
                     pull manager buys; never extends past dispatch)
          exec     = dispatch -> worker-reported exec end
          publish  = worker exec end -> completion applied here (the
                     fire-and-forget result path: flusher batch + transit)

        Durations land on rec.phases (state API); for traced tasks ONE
        raw tuple lands on timeline_events (and on span_outbox when this
        controller is a node — the agent's heartbeat ships them to the
        head). Formatting into Chrome "X" events — dict + f-string per
        phase — happens lazily at query/ship time (format_timeline): this
        runs on the completion hot path, in the loop thread that shares
        the GIL with submitting drivers. `wspan` is the worker's
        (resolve_t0, exec_t0, exec_t1) epoch stamps; the worker and this
        controller share a host (unix socket), so the clocks are
        comparable."""
        rec.worker_span = wspan
        t_sub = rec.ts_submit or rec.ts_start
        t_start, t_end = rec.ts_start, rec.ts_end
        exec_end = t_end
        exec_start = t_start
        if wspan:
            try:
                exec_end = min(max(float(wspan[2]), t_start), t_end)
                # dispatch -> worker exec start: frame transit + arg
                # resolve/fetch on the worker — the per-task "xfer" phase
                # (the inter-stage hop for pipeline-shaped workloads)
                exec_start = min(max(float(wspan[1]), t_start), exec_end)
            except (TypeError, IndexError, ValueError):
                exec_end, exec_start = t_end, t_start
        phases = {"queued": max(t_start - t_sub, 0.0),
                  "exec": max(exec_end - exec_start, 0.0),
                  "publish": max(t_end - exec_end, 0.0)}
        if exec_start > t_start:
            phases["xfer"] = exec_start - t_start
        pw = rec.prefetch_windows
        if pw:
            p0 = min(a for a, _ in pw)
            p1 = max(b for _, b in pw)
            p1 = min(p1, t_start)  # gated pulls land before dispatch
            p0 = min(p0, p1)
            phases["prefetch"] = max(p1 - p0, 0.0)
        rec.phases = phases
        trace_id = rec.spec.trace_id
        if trace_id is None or not tracing.enabled():
            return
        windows = [("queued", t_sub, t_start),
                   ("exec", exec_start, exec_end),
                   ("publish", exec_end, t_end)]
        if exec_start > t_start:
            windows.insert(1, ("xfer", t_start, exec_start))
        if pw:
            windows.insert(1, ("prefetch", p0, p1))
        entry = ("_phases", rec.spec.name or rec.spec.task_id, tid,
                 trace_id, rec.spec.task_id, windows)
        self.timeline_events.append(entry)
        if getattr(self, "span_ship", False):
            outbox = self.span_outbox
            outbox.append(entry)
            if len(outbox) > 20000:
                del outbox[:len(outbox) - 20000]

    def _release_task_resources(self, rec: TaskRecord):
        if rec.spec.actor_id:
            # methods run within the actor's standing allocation; the actor
            # lifecycle (_fail_actor / _release_actor_allocation) owns the
            # creation allocation — releasing here would double-free
            return
        self._release(rec.spec.resources, self._task_pool(rec.spec))
        gpus = (rec.spec.runtime_env or {}).get("_gpu_ids", [])
        self.gpu_free.extend(gpus)

    def _release_actor_allocation(self, actor: ActorRecord):
        """Exactly-once release of an actor's standing resources + cards."""
        if not actor.resources_claimed or actor.creation_spec is None:
            return
        actor.resources_claimed = False
        self._release(actor.creation_spec.resources, self._task_pool(actor.creation_spec))
        gpus = (actor.creation_spec.runtime_env or {}).get("_gpu_ids", [])
        self.gpu_free.extend(gpus)

    def _unpin(self, rec: TaskRecord):
        for oid in rec.pinned:
            meta = self.objects.get(oid)
            if meta:
                meta.pinned = max(meta.pinned - 1, 0)
                if meta.pinned == 0:
                    meta.ts_pinned = 0.0
                    if meta.refcount <= 0:
                        self._evict(oid)
        rec.pinned.clear()
        for aid in rec.pinned_actors:
            self.actor_decref(aid)
        rec.pinned_actors.clear()
        for sid in rec.pinned_streams:
            self.close_stream(sid)
        rec.pinned_streams.clear()

    # ---------------------------------------------------------------- task GC
    def _mark_task_terminal(self, rec: TaskRecord):
        """Queue a finished task record for pruning. Actor creation records are
        exempt while their actor lives (restart paths index them directly)."""
        if rec.spec.is_actor_creation:
            return
        self._done_task_ids.append(rec.spec.task_id)
        self._gc_tasks()

    def _gc_tasks(self):
        while len(self._done_task_ids) > self.task_retention:
            tid = self._done_task_ids.popleft()
            rec = self.tasks.get(tid)
            if rec is None:
                continue
            if rec.state not in (DONE, FAILED, CANCELLED):
                continue  # resurrected by lineage recovery; re-queued on redo
            spec = rec.spec
            if not spec.actor_id and spec.num_returns != "streaming" and rec.state == DONE:
                # keep the slim spec (plus the remaining reconstruction budget
                # — resurrection must not re-grant an exhausted one) so
                # reconstruction stays possible after the record is dropped
                self.lineage_specs[tid] = (spec, list(rec.result_oids),
                                           rec.reconstructions_left)
                while len(self.lineage_specs) > self.lineage_retention:
                    self.lineage_specs.popitem(last=False)
            del self.tasks[tid]
            st = self.streams.get(tid)
            if st is not None:
                self._maybe_drop_stream(tid, st)

    def _fail_task(self, rec: TaskRecord, err: Exception):
        was_terminal = rec.state in (DONE, FAILED, CANCELLED)
        rec.state = CANCELLED if isinstance(err, exc.TaskCancelledError) else FAILED
        self.ready_queue.remove(rec)  # no-op unless still queued
        if not was_terminal:
            self._mark_task_terminal(rec)
        self._unpin(rec)
        owned_errs = []
        for oid in rec.result_oids:
            meta = self.objects.get(oid)
            if meta is not None:
                meta.error = err
                meta.location = "error"
                if meta.owner is not None:
                    # owners wait locally: the error must reach them too or
                    # their owned-table get would hang (same chokepoint
                    # discipline as register_put)
                    owned_errs.append((meta.owner, oid))
                ev = self.object_events.get(oid)
                if ev:
                    ev.set()
        for owner, oid in owned_errs:
            self._push_owned(owner, [(oid, "err", err, 0, 0)])
        st = self.streams.get(rec.spec.task_id)
        if st is not None:
            st.error = err
            st.finished = True
            st.cond.set()
        rec.done.set()
        # wake tasks depending on these now-errored objects
        for oid in rec.result_oids:
            self._resolve_dep(oid)

    # ------------------------------------------------------------ object table
    def register_put(self, oid: str, meta_len: int, size: int, inline: Optional[bytes],
                     contained: Optional[List[str]] = None, owner: Optional[str] = None):
        """`owner` is the client id of the sender ("driver"/worker id) for
        puts arriving over the control plane. Under the ownership model the
        head is a write-behind cache for owned small objects: a fresh put
        from its owner just records ownership, while a put that seals an
        object some OTHER client owns (a worker finishing the owner's task)
        triggers a descriptor push back to the owner so its local gets never
        round-trip here (ref: Ray ownership, reference_count.cc)."""
        meta = self.objects.get(oid)
        if meta is None:
            meta = ObjectMeta(object_id=oid)
            self.objects[oid] = meta
            self.object_events[oid] = asyncio.Event()
            if owner is not None and self.ownership:
                meta.owner = owner  # sender owns its own fresh put
        if contained:
            # Containment pinning (ref: reference_count.h nested ids): the
            # object's bytes hold serialized ObjectRefs; keep those alive for
            # as long as this object is — released in _evict.
            meta.contained = list(contained)
            self.incref(meta.contained)
        meta.meta_len = meta_len
        meta.size = size
        if meta.ts_sealed == 0.0:
            meta.ts_sealed = time.time()
        if inline is not None:
            meta.location = "inline"
            meta.inline_value = inline
        else:
            meta.location = "shm"
            self.store_used += size
            self._maybe_spill()
            from . import chaos as _chaos
            if _chaos.enabled():
                # seeded drop-a-just-sealed-segment fault: bytes vanish, the
                # meta survives, the next read MISSes into lineage recovery
                _chaos.get_injector().maybe_drop_segment(self, oid)
        if meta.owner is not None and meta.owner != owner:
            # sealed by someone other than its owner: push the descriptor
            # home. Inline bytes ship whole; shm-backed results fall back to
            # "head" (the owner's get fetches bytes through the normal RPC).
            if inline is not None:
                self._push_owned(meta.owner,
                                 [(oid, "inline", inline, meta_len, size)])
            else:
                self._push_owned(meta.owner, [(oid, "head", None, 0, 0)])
        self.object_events[oid].set()
        self._resolve_dep(oid)

    def _push_owned(self, owner: str, entries: list):
        """One-way descriptor push to an object's owner. Three transports:
        an in-process sink (the driver registers its owned-table resolve in
        owner_sinks), a live worker connection ("owned" frame), or — when
        the owner is gone — nothing: the head's cache stays authoritative
        and ownership transfer already cleared meta.owner in
        _on_worker_dead."""
        sink = self.owner_sinks.get(owner)
        if sink is not None:
            try:
                sink(entries)
            except Exception as e:  # noqa: BLE001 - owner bug must not kill us
                print(f"[controller] owned-descriptor sink for {owner!r} "
                      f"failed: {e!r}", file=sys.stderr)
            return
        w = self.workers.get(owner)
        if w is not None and w.state not in ("dead", "dying") and w.writer:
            try:
                protocol.awrite_msg(w.writer, "owned", entries=entries)
            except Exception:  # noqa: BLE001 - peer died mid-write
                pass

    def _object_location(self, oid: str):
        """Node id holding the object's bytes (this controller's own id for
        local copies, None for pending/unknown) — the read behind the
        clients' object_locations()."""
        meta = self.objects.get(oid)
        if meta is None:
            return None
        if meta.location.startswith("remote:"):
            return meta.location.split(":", 1)[1]
        if meta.location in ("shm", "spilled", "inline"):
            return self.node_id
        return None

    # ------------------------------------------------- cluster object table
    def _register_remote(self, oid: str, node_id: str, size: int = 0,
                         meta_len: int = 0, contained=None):
        """Record that `oid`'s bytes live in a cluster node's store (ref:
        object directory locations, src/ray/object_manager)."""
        meta = self.objects.get(oid)
        if meta is None:
            meta = ObjectMeta(object_id=oid)
            self.objects[oid] = meta
            self.object_events[oid] = asyncio.Event()
        if contained and not meta.contained:
            meta.contained = list(contained)
            self.incref(meta.contained)
        meta.size = size
        meta.meta_len = meta_len
        if meta.ts_sealed == 0.0:
            meta.ts_sealed = time.time()
        meta.location = f"remote:{node_id}"
        meta.holders = []  # fresh authoritative copy: old holders are stale
        if meta.owner is not None:
            # bytes landed on a cluster node: ownership transfers to the
            # head (cross-node pull path) — the owner's get comes here
            self._push_owned(meta.owner, [(oid, "head", None, 0, 0)])
            meta.owner = None
        self.object_events[oid].set()
        if prefetch_enabled():
            # production moment: if a queued task is waiting on this object
            # and can't follow it to the holder, start the pull before the
            # waiter even dispatches (must run BEFORE _resolve_dep pops the
            # waiter set)
            for tid in self.dep_waiters.get(oid, ()):
                rec = self.tasks.get(tid)
                if (rec is not None
                        and self._prefetch_worthwhile(rec.spec, meta)):
                    self._prefetch_request(oid)
                    break
        self._resolve_dep(oid)

    def _ingest_bytes(self, oid: str, p: dict):
        """Materialize shipped object bytes into the local table/store.
        `p`: {"kind": "inline"|"blob", "data", "size", ["meta_len"],
        ["contained"]} — the wire format for deps, pulls, and fetches."""
        meta = self.objects.get(oid)
        if meta is None:
            meta = ObjectMeta(object_id=oid)
            self.objects[oid] = meta
            self.object_events[oid] = asyncio.Event()
        if p.get("contained") and not meta.contained:
            meta.contained = list(p["contained"])
            self.incref(meta.contained)
        if meta.ts_sealed == 0.0:
            meta.ts_sealed = time.time()
        if p["enc"] == "inline":
            meta.location = "inline"
            meta.inline_value = p["data"]
            meta.size = p["size"]
        else:
            if p["enc"] == "direct":
                # bytes already landed in the local store: a parallel fetch
                # recv_into'd them straight into the preallocated segment
                self.store_used += p["size"]
            elif not self.store.exists(oid):
                self.store.put_raw(oid, p["data"])
                self.store_used += p["size"]
            meta.meta_len = p["meta_len"]
            meta.size = p["size"]
            meta.location = "shm"
            meta.spill_path = None
            self._maybe_spill()
        self.object_events[oid].set()
        self._resolve_dep(oid)

    def _ingest_result(self, r: dict, node_id: str):
        """A forwarded task's per-oid result: inline values arrive by value,
        large values stay in the producing node's store (lazy pull)."""
        if r["enc"] == "inline":
            self.register_put(r["oid"], 0, r["size"], r["data"],
                              r.get("contained"))
        else:
            self._register_remote(r["oid"], node_id, r["size"],
                                  r["meta_len"], r.get("contained"))

    async def _pull_remote(self, oid: str) -> bool:
        """Pull a remote-located object's bytes into the head store,
        deduplicating concurrent pulls of the same oid."""
        if self.cluster is None:
            return False
        task = self._pulls.get(oid)
        if task is None:
            meta = self.objects.get(oid)
            if meta is None:
                return False
            if not meta.location.startswith("remote:"):
                return True  # raced: someone else already pulled it
            node_id = meta.location.split(":", 1)[1]
            task = self.loop.create_task(self.cluster.pull_object(oid, node_id))
            self._pulls[oid] = task
            task.add_done_callback(lambda _f: self._pulls.pop(oid, None))
        return await task

    # ---------------------------------------- dependency-prefetching dispatch
    def _pin_for_pull(self, oid: str):
        """Pull-manager pin hook: an object being eagerly pulled must not be
        spilled/evicted out from under the landing bytes."""
        meta = self.objects.get(oid)
        if meta is not None:
            meta.pinned += 1
            if meta.ts_pinned == 0.0:
                meta.ts_pinned = time.time()

    def _unpin_for_pull(self, oid: str):
        meta = self.objects.get(oid)
        if meta is not None and meta.pinned > 0:
            meta.pinned -= 1
            if meta.pinned == 0:
                meta.ts_pinned = 0.0

    def _prefetch_worthwhile(self, spec: TaskSpec, meta: ObjectMeta) -> bool:
        """Would an eager HEAD-side pull of this remote arg help this task?
        Locality-aware placement (compute moves to data) stays the first
        choice: pull only when the task is bound for the head while its
        bytes sit on a node that cannot host it. A false positive costs one
        early transfer; dispatch stays correct either way."""
        if self.cluster is None or not meta.location.startswith("remote:"):
            return False
        if spec.placement_group_id:
            return False  # the bundle's node decides; its agent pulls deps
        if spec.actor_id and not spec.is_actor_creation:
            actor = self.actors.get(spec.actor_id)
            # methods follow their actor; node_id None = hosted on the head
            return actor is not None and actor.node_id is None
        if spec.is_actor_creation:
            return False  # creation placement resolves in the scheduler
        if spec.num_returns == "streaming":
            return True  # generators always run on the head
        holder = meta.location.split(":", 1)[1]
        strat = spec.scheduling_strategy
        node_id = getattr(strat, "node_id", None)
        if node_id and not getattr(strat, "locality_hint", False):
            return node_id == self.node_id  # user pin: pull only if to head
        node = self.cluster.nodes.get(holder)
        if node is None or not node.alive:
            return True  # holder going away: grab the bytes while we can
        # the holder lacks a resource KEY the task needs (e.g. a head-only
        # marker resource): placement must move the task off the data's node
        needed = [k for k, v in spec.resources.items() if v > 0]
        if all(k in node.resources for k in needed):
            return False  # can run where the data is: locality wins
        # ...but only pull to the HEAD if no other alive node could host it
        # either (a node-to-node move rides the direct data plane instead,
        # and a head-side copy would just stage bytes nobody dispatches on)
        for other in self.cluster.nodes.values():
            if (other is not node and other.alive
                    and all(k in other.resources for k in needed)):
                return False
        return True

    def _prefetch_request(self, oid: str):
        """Start (or join) an eager pull of a remote object the dispatcher
        wants head-local. Fire-and-forget: success lands the bytes through
        the normal ingest path (which resolves gated waiters); failure
        resolves them too, so the task dispatches anyway and its worker
        falls back to the blocking exec-time fetch (a miss, not an error)."""
        if self.prefetch is None or not prefetch_enabled():
            return
        meta = self.objects.get(oid)
        if meta is None:
            return
        if meta.location == "spilled":
            self._restore_request(oid, meta)
            return
        if not meta.location.startswith("remote:"):
            return

        async def fetch():
            ok = False
            try:
                ok = bool(await self._pull_remote(oid))
            finally:
                m = self.objects.get(oid)
                if ok and m is not None and m.location in ("shm", "inline"):
                    m.prefetched = True
                if not ok:
                    self._resolve_dep(oid)
            return ok

        self.prefetch.request(oid, meta.size, fetch)

    def _restore_request(self, oid: str, meta):
        """Restore-before-dispatch: a spilled task arg is promoted back to
        shm through the same PullManager as remote pulls — single-flight,
        byte-capped, and pin/unpin-bracketed so the landing object can't be
        re-demoted mid-restore. File I/O runs in the executor; the loop
        thread re-checks location before mutating meta (idempotent against
        a concurrent inline _ensure_local, whose store.restore early-returns
        once the segment exists). Unlike remote pulls there is no ingest
        path to resolve gated waiters, so both outcomes resolve here; a
        failed restore degrades to the dispatch-time _ensure_local fallback
        in _arg_descriptors (a miss, not an error)."""

        async def fetch():
            ok = False
            try:
                m = self.objects.get(oid)
                if m is None:
                    return False
                if m.location != "spilled":
                    return m.location in ("shm", "inline")
                path = m.spill_path
                self._make_room_for_restore(m.size)
                try:
                    size = await self.loop.run_in_executor(
                        None, self.store.restore, oid, path)
                except MemoryError:  # fragmentation: demote harder, retry
                    self._spill_down(0, pressure=True)
                    size = await self.loop.run_in_executor(
                        None, self.store.restore, oid, path)
                m2 = self.objects.get(oid)
                if m2 is not None and m2.location == "spilled":
                    m2.location = "shm"
                    m2.spill_path = None
                    self.store_used += size
                    self.store_spilled_bytes = max(
                        self.store_spilled_bytes - size, 0)
                    if self.gcs is not None:
                        self.gcs.record("object_gone", object_id=oid)
                from ..util import metrics
                metrics.get_or_create(
                    metrics.Counter, "restored_objects_total",
                    "objects promoted disk → shm").inc()
                ok = True
            except Exception:  # noqa: BLE001 - degrade to exec-time restore
                ok = False
            finally:
                m = self.objects.get(oid)
                if ok and m is not None:
                    m.prefetched = True
                self._resolve_dep(oid)
            return ok

        self.prefetch.request(oid, meta.size, fetch)

    def _gate_on_prefetch(self, rec: TaskRecord) -> bool:
        """Ready-arg accounting at dispatch time: a head-bound task whose
        remote ref args have an eager pull in flight goes back to
        PENDING_DEPS until the bytes land, keeping the worker slot free and
        letting the exec frame ship a zero-copy descriptor instead of a
        blocking fetch. Each arg gates at most once (prefetch_tried), so a
        failed pull degrades to the legacy exec-time path on re-enqueue."""
        if self.cluster is None or not prefetch_enabled():
            return False
        gated = False
        for kind, v in list(rec.spec.args) + list(rec.spec.kwargs.values()):
            if kind != "ref" or v in rec.prefetch_tried:
                continue
            meta = self.objects.get(v)
            if meta is None or not (meta.location.startswith("remote:")
                                    or meta.location == "spilled"):
                continue
            rec.prefetch_tried.add(v)
            rec.deps_remaining.add(v)
            self.dep_waiters[v].add(rec.spec.task_id)
            self._prefetch_request(v)
            gated = True
        if gated:
            rec.state = PENDING_DEPS
        return gated

    def _arg_descriptors(self, rec: TaskRecord) -> Dict[str, tuple]:
        """Per-arg descriptors for every locally resident ref arg, shipped in
        the exec frame so the worker materializes zero-copy from the shared
        store instead of a blocking round trip. Dispatch-time ready-arg
        accounting: resident → prefetch_hits, anything the worker must fetch
        at exec time → prefetch_misses; the wall time of pulls that landed
        before dispatch accrues to prefetch_overlap_saved_ms."""
        from ..util import metrics
        descs: Dict[str, tuple] = {}
        hits = misses = 0
        saved_ms = 0.0
        seen: Set[str] = set()
        for kind, v in list(rec.spec.args) + list(rec.spec.kwargs.values()):
            if kind != "ref" or v in seen:
                continue
            seen.add(v)
            meta = self.objects.get(v)
            d = None
            if meta is not None and meta.error is None:
                if meta.location == "spilled":
                    try:
                        self._ensure_local(v)
                    except Exception:  # noqa: BLE001 - spill file gone:
                        pass           # worker-side fetch reconstructs
                if meta.location == "inline":
                    d = ("inline", meta.inline_value)
                elif meta.location == "shm":
                    d = ("shm", meta.meta_len)
            if d is None:
                misses += 1
                continue
            descs[v] = d
            hits += 1
            if meta.prefetched:
                meta.prefetched = False  # credit each pull once
                if self.prefetch is not None:
                    saved_ms += self.prefetch.durations_ms.pop(v, 0.0)
            if self.prefetch is not None:
                # trace window claimed on existence, NOT meta.prefetched: a
                # gated task dispatches in the same loop turn the pull's
                # ingest resolves its deps — before the pull coroutine's
                # finally stamps prefetched/duration. The open window (end
                # None) is closed at claim time: the bytes landed this turn
                win = self.prefetch.windows.pop(v, None)
                if win is not None:
                    rec.prefetch_windows.append(
                        (win[0], win[1] if win[1] is not None else time.time()))
        if hits:
            metrics.get_or_create(metrics.Counter, "prefetch_hits").inc(hits)
        if misses:
            metrics.get_or_create(metrics.Counter, "prefetch_misses").inc(misses)
        if saved_ms:
            metrics.get_or_create(
                metrics.Counter, "prefetch_overlap_saved_ms").inc(saved_ms)
        return descs

    def _resolve_dep(self, oid: str):
        for tid in self.dep_waiters.pop(oid, ()):
            rec = self.tasks.get(tid)
            if rec is None or rec.state != PENDING_DEPS:
                continue
            rec.deps_remaining.discard(oid)
            if not rec.deps_remaining:
                self._enqueue_ready(rec)
        self._schedule()

    def _spill_protected(self) -> set:
        """Oids the spiller must leave alone beyond the pin count: objects a
        pull manager is landing or has committed to land (the pin brackets
        the transfer, but a spill racing the park→launch gap would evict the
        segment out from under the admission queue), and prefetched objects
        whose dispatch gate hasn't attached yet (pin released at ingest,
        descriptor claimed at dispatch — spilling in between turns the
        prefetch win into a restore)."""
        out = set()
        if self.prefetch is not None:
            out |= self.prefetch.protected()
        agent = getattr(self, "agent", None)  # node controllers: the
        if agent is not None:                 # redirected-dep pull manager
            pm = agent._pull_manager
            if pm is not None:
                out |= pm.protected()
        return out

    def spill_for_put(self, size: int, hard: bool = False):
        """Synchronous make-room call for a client whose arena allocation
        failed: clients write puts straight into shm, so the background
        pressure loop can be behind (or the slab fragmented below the
        accounting watermark) when they hit the wall. hard drains every
        unpinned shm object — the last resort before the put errors out."""
        if hard:
            self._spill_down(0, pressure=True)
        else:
            self._spill_down(
                max(0.0, min(self.store_capacity * spill_target(),
                             self.store_capacity - size)), pressure=True)

    def _maybe_spill(self):
        """Spill oldest unpinned shm objects when over capacity (ref: plasma
        eviction + object spilling, src/ray/object_manager/spilled_object).
        The synchronous backstop of the ladder — the background _spill_tick
        usually drains before this fires."""
        if self.store_used <= self.store_capacity:
            return
        self._spill_down(self.store_capacity * 0.8)

    def _spill_tick(self):
        """Background demotion loop: runs off the reaper at
        spill_interval_s cadence, watching the same store-pressure gauge
        the health plane exports. Past RAY_TPU_SPILL_THRESHOLD it demotes
        shm → disk down to RAY_TPU_SPILL_TARGET, so the synchronous
        over-capacity path on the put hot path rarely has work left."""
        now = time.monotonic()
        if now - self._last_spill_scan < spill_interval_s():
            return
        self._last_spill_scan = now
        if self.store_used > self.store_capacity * spill_threshold():
            self._spill_down(self.store_capacity * spill_target(),
                             pressure=True)
        self._tier_gauges()

    def _spill_down(self, target_bytes: float, pressure: bool = False):
        """Demote oldest unpinned shm objects until store_used ≤ target.
        Prefetch pinning is honored twice: the snapshot skip (counted on
        spill_pinned_skips_total) and a fresh re-check right before each
        spill — a protected object demoted anyway would land on
        spill_pinned_demotions_total, the invariant counter the chain-bench
        smoke asserts stays zero."""
        from ..util import metrics
        protected = self._spill_protected()
        skips = spilled = 0
        for oid, meta in list(self.objects.items()):
            if self.store_used <= target_bytes:
                break
            if meta.location != "shm" or meta.pinned != 0:
                continue
            if oid in protected or meta.prefetched:
                skips += 1
                continue
            m2 = self.objects.get(oid)
            if (m2 is not meta or meta.pinned != 0 or meta.prefetched
                    or oid in self._spill_protected()):
                metrics.get_or_create(
                    metrics.Counter, "spill_pinned_demotions_total",
                    "protected objects demoted anyway (must stay 0)").inc()
                continue
            try:
                meta.spill_path = self.store.spill(oid)
                meta.location = "spilled"
                self.store_used -= meta.size
                self.store_spilled_bytes += meta.size
                spilled += 1
                if self.gcs is not None:
                    self.gcs.record("spilled", object_id=oid,
                                    path=meta.spill_path, size=meta.size,
                                    meta_len=meta.meta_len)
            except Exception:  # noqa: BLE001 - best-effort under pressure
                continue
        if spilled:
            metrics.get_or_create(
                metrics.Counter, "spilled_objects_total",
                "objects demoted shm → disk").inc(spilled)
            if pressure:
                metrics.get_or_create(
                    metrics.Counter, "spill_pressure_total",
                    "objects demoted by the background pressure loop"
                ).inc(spilled)
        if skips:
            metrics.get_or_create(
                metrics.Counter, "spill_pinned_skips_total",
                "demotion candidates spared by prefetch/pull pinning"
            ).inc(skips)

    def _tier_gauges(self):
        """Export per-tier occupancy (owner=store series; the serve-side KV
        stash publishes owner=kv_stash on the same families)."""
        try:
            from ..util import metrics
            tags = {"owner": "store"}
            shm_objects = disk_objects = 0
            for m in self.objects.values():
                if m.location == "shm":
                    shm_objects += 1
                elif m.location == "spilled":
                    disk_objects += 1

            def g(name, desc):
                return metrics.get_or_create(metrics.Gauge, name, desc,
                                             tag_keys=("owner",))
            g("store_tier_shm_bytes",
              "bytes resident in the shm tier").set(self.store_used, tags)
            g("store_tier_disk_bytes",
              "bytes demoted to the disk tier").set(
                  self.store_spilled_bytes, tags)
            g("store_tier_shm_objects",
              "objects resident in the shm tier").set(shm_objects, tags)
            g("store_tier_disk_objects",
              "objects demoted to the disk tier").set(disk_objects, tags)
        except Exception:  # noqa: BLE001 - gauges must not break the reaper
            pass

    def _make_room_for_restore(self, size: int):
        """Demote cold shm objects so a promotion from disk fits. Working
        sets ≫ RAM churn both directions through the ladder — a full arena
        must never fail a get() on a spilled object."""
        if self.store_used + size > self.store_capacity:
            self._spill_down(
                max(0.0, min(self.store_capacity * spill_target(),
                             self.store_capacity - size)), pressure=True)

    def _restore_segment(self, oid: str, spill_path):
        """store.restore with the make-room dance: slab fragmentation can
        exhaust the arena below the accounting watermark, so a MemoryError
        here means "demote harder and retry once", not "fail the get"."""
        self._make_room_for_restore(self.objects[oid].size)
        try:
            return self.store.restore(oid, spill_path)
        except MemoryError:
            self._spill_down(0, pressure=True)
            return self.store.restore(oid, spill_path)

    def _ensure_local(self, oid: str):
        meta = self.objects[oid]
        if meta.location == "spilled":
            self._restore_segment(oid, meta.spill_path)
            meta.location = "shm"
            meta.spill_path = None
            self.store_used += meta.size
            self.store_spilled_bytes = max(
                self.store_spilled_bytes - meta.size, 0)
            from ..util import metrics
            metrics.get_or_create(
                metrics.Counter, "restored_objects_total",
                "objects promoted disk → shm").inc()
            if self.gcs is not None:  # restore deletes the spill file
                self.gcs.record("object_gone", object_id=oid)

    async def get_descriptors(self, oids: List[str], timeout: Optional[float]):
        """Wait for availability; return per-object descriptors the caller can
        materialize locally: ("shm", meta_len) | ("inline", bytes) | ("err", e).
        Lost objects (evicted registry entry, vanished shm segment, missing
        spill file) are transparently reconstructed from lineage."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for oid in oids:
            ev = self.object_events.get(oid)
            if ev is None:
                if not await self._recover_object(oid):
                    raise exc.ObjectLostError(oid)
                ev = self.object_events[oid]
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0 and not ev.is_set():
                raise exc.GetTimeoutError(f"get() timed out waiting for {oid}")
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                raise exc.GetTimeoutError(f"get() timed out waiting for {oid}") from None
        self._start_batched_pulls(oids)
        out = []
        for oid in oids:
            out.append(await self._descriptor(oid, deadline))
        return out

    _BULK_PULL_MAX = 1 << 20  # small objects coalesce into one pull RPC

    def _start_batched_pulls(self, oids: List[str]):
        """Coalesce a get()-list's remote pulls BEFORE the per-oid
        descriptor pass: small objects grouped per owner node ride ONE
        pull_objects RPC each (O(nodes) round trips, not O(refs)); large
        objects start their (chunked-parallel) pulls concurrently instead
        of serially inside _descriptor."""
        if self.cluster is None:
            return
        by_node: Dict[str, List[str]] = {}
        for oid in dict.fromkeys(oids):
            meta = self.objects.get(oid)
            if (meta is None or oid in self._pulls
                    or not meta.location.startswith("remote:")):
                continue
            by_node.setdefault(meta.location.split(":", 1)[1], []).append(oid)
        for node_id, group in by_node.items():
            bulk = [o for o in group
                    if 0 < self.objects[o].size <= self._BULK_PULL_MAX]
            if len(bulk) > 1:
                shared = self.loop.create_task(
                    self.cluster.pull_objects(bulk, node_id))
                for oid in bulk:
                    task = self.loop.create_task(
                        self._join_bulk_pull(shared, oid))
                    self._pulls[oid] = task
                    task.add_done_callback(
                        lambda _f, o=oid: self._pulls.pop(o, None))
            else:
                bulk = []
            for oid in group:
                if oid not in bulk:
                    # kicks the dedup task in _pull_remote; _descriptor's
                    # own await joins it (parallel across oids and nodes)
                    self.loop.create_task(self._pull_remote(oid))

    async def _join_bulk_pull(self, shared: asyncio.Task, oid: str) -> bool:
        """Per-oid view of one shared pull_objects RPC (the _pulls table
        maps oid -> awaitable-of-bool)."""
        try:
            pulled = await shared
        except Exception:  # noqa: BLE001 - node hiccup = not pulled
            return False
        if oid in pulled:
            return True
        # not in the bulk reply (evicted there?): one individual retry via
        # the normal pull path before _descriptor declares it lost
        meta = self.objects.get(oid)
        if meta is None or not meta.location.startswith("remote:"):
            return True  # raced: landed some other way
        return await self.cluster.pull_object(
            oid, meta.location.split(":", 1)[1])

    async def _descriptor(self, oid: str, deadline, _depth: int = 0):
        meta = self.objects[oid]
        if meta.location == "error":
            return ("err", meta.error)
        if meta.location == "inline":
            return ("inline", meta.inline_value)
        lost = False
        if meta.location.startswith("remote:"):
            # bytes live in a cluster node's store; pull them in (ref:
            # object_manager.cc Pull). Failure = node gone → lost → lineage.
            lost = not await self._pull_remote(oid)
            if not lost and meta.location == "inline":
                return ("inline", meta.inline_value)
        if not lost:
            try:
                self._ensure_local(oid)  # restores spilled data
                lost = meta.location == "shm" and not self.store.exists(oid)
            except (FileNotFoundError, OSError):
                lost = True  # spill file vanished
        if not lost:
            return ("shm", meta.meta_len)
        if _depth >= 3 or not await self._recover_object(oid):
            return ("err", exc.ObjectLostError(oid))
        remaining = None if deadline is None else deadline - time.monotonic()
        try:
            await asyncio.wait_for(self.object_events[oid].wait(), remaining)
        except asyncio.TimeoutError:
            raise exc.GetTimeoutError(
                f"get() timed out reconstructing {oid}") from None
        return await self._descriptor(oid, deadline, _depth + 1)

    async def wait(self, oids, num_returns, timeout):
        for oid in oids:
            if oid not in self.object_events:
                if not await self._recover_object(oid):
                    raise exc.ObjectLostError(oid)
        deadline = None if timeout is None else time.monotonic() + timeout
        events = {oid: self.object_events[oid] for oid in oids}
        waiters = {oid: asyncio.ensure_future(ev.wait())
                   for oid, ev in events.items() if not ev.is_set()}
        try:
            while True:
                n_ready = sum(1 for ev in events.values() if ev.is_set())
                if n_ready >= num_returns or not waiters:
                    break
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                done, _ = await asyncio.wait(list(waiters.values()),
                                             timeout=remaining,
                                             return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    break  # timed out
                for oid in [o for o, f in waiters.items() if f.done()]:
                    del waiters[oid]
        finally:
            for f in waiters.values():
                f.cancel()
        ready = [oid for oid in oids if events[oid].is_set()][:num_returns]
        ready_set = set(ready)
        return ready, [oid for oid in oids if oid not in ready_set]

    def decref(self, oids: List[str]):
        for oid in oids:
            if oid.startswith("actor-"):
                # contained-id lists carry actor handles and generator
                # task-ids too (prefix dispatch)
                self.actor_decref(oid)
                continue
            if oid.startswith("task-"):
                self.close_stream(oid)
                continue
            meta = self.objects.get(oid)
            if meta is None:
                continue
            meta.refcount -= 1
            if meta.refcount <= 0:
                if meta.ts_released == 0.0:
                    meta.ts_released = time.time()
                if meta.pinned == 0:
                    self._evict(oid)

    def incref(self, oids: List[str]):
        for oid in oids:
            if oid.startswith("actor-"):
                self.actor_incref(oid)
                continue
            if oid.startswith("task-"):
                self.open_stream(oid)
                continue
            meta = self.objects.get(oid)
            if meta is not None:
                meta.refcount += 1

    # -------------------------------------------------- actor handle refcount
    def _worker_actor_incref(self, w: WorkerConn, actor_id: str):
        """Handle ref held by code inside worker `w` — tallied per worker so a
        crash releases it (ref: reference_count.cc borrower reconciliation)."""
        self.actor_incref(actor_id)
        w.actor_refs[actor_id] = w.actor_refs.get(actor_id, 0) + 1

    def _worker_actor_decref(self, w: WorkerConn, actor_id: str):
        n = w.actor_refs.get(actor_id, 0)
        if n <= 1:
            w.actor_refs.pop(actor_id, None)
        else:
            w.actor_refs[actor_id] = n - 1
        self.actor_decref(actor_id)

    def actor_incref(self, actor_id: str):
        actor = self.actors.get(actor_id)
        if actor is not None and actor.state != A_DEAD:
            # the sharded directory holds the authoritative count (actor ids
            # shard alongside object ids); the record mirrors it for readers
            v = self.objdir.add_refcount(actor_id, 1)
            actor.handle_refs = v if v is not None else actor.handle_refs + 1
            actor.pending_gc = False

    def actor_decref(self, actor_id: str):
        actor = self.actors.get(actor_id)
        if actor is None or actor.state == A_DEAD:
            return
        v = self.objdir.add_refcount(actor_id, -1)
        actor.handle_refs = v if v is not None else actor.handle_refs - 1
        if actor.handle_refs <= 0:
            self._maybe_gc_actor(actor)

    def _maybe_gc_actor(self, actor: ActorRecord):
        """Terminate an actor no handle can reach any more (ref: Ray GCs
        non-detached actors when all handles go out of scope,
        src/ray/gcs/gcs_server/gcs_actor_manager.cc OnActorOutOfScope).
        Named and detached actors are exempt: they die only via kill() or
        shutdown. Queued/in-flight work finishes first — the GC re-fires from
        _on_task_done when the actor drains."""
        if actor.handle_refs > 0 or actor.state == A_DEAD:
            return
        if actor.name or (actor.options is not None and
                          getattr(actor.options, "lifetime", None) == "detached"):
            return
        # cancelled/failed records linger in the queue until _schedule pops
        # them — only live work defers collection
        if actor.in_flight or any(r.state == PENDING for r in actor.queue):
            actor.pending_gc = True
            return
        actor.pending_gc = False
        self.kill_actor(actor.actor_id, no_restart=True,
                        reason="all handles out of scope")

    def _evict(self, oid: str):
        meta = self.objects.pop(oid, None)
        if meta is None:
            self.objdir.erase(oid)  # self-heal a directory-only orphan
            return
        self.objdir.erase(oid)  # counters freeze into the meta's mirrors
        if meta.location == "shm":
            self.store.delete_segment(oid)
            self.store_used -= meta.size
        elif meta.location.startswith("remote:") and self.cluster is not None:
            # the bytes live on a node; release that node's creation ref
            self.cluster.free_object(oid, meta.location.split(":", 1)[1])
        elif meta.location == "spilled" and meta.spill_path:
            try:
                os.remove(meta.spill_path)
            except OSError:
                pass
            self.store_spilled_bytes = max(
                self.store_spilled_bytes - meta.size, 0)
            if self.gcs is not None:
                self.gcs.record("object_gone", object_id=oid)
        self.object_events.pop(oid, None)
        if meta.creating_task:
            # lineage survives the data: a borrowed ref deserialized later can
            # still trigger reconstruction (ref: object_recovery_manager.cc)
            self.lineage[oid] = meta.creating_task
        if meta.contained:
            # the container's bytes are gone; drop its holds on nested objects
            self.decref(meta.contained)

    # ------------------------------------------------------ lineage recovery
    def _lineage_rec(self, oid: str) -> Optional[TaskRecord]:
        """The creating task's record, if this object is reconstructable
        (plain task output; actor methods would re-run against mutated state
        and streams have per-item ids — both non-deterministic, refused,
        matching the reference's plain-task-only recovery)."""
        meta = self.objects.get(oid)
        tid = meta.creating_task if meta is not None else self.lineage.get(oid)
        rec = self.tasks.get(tid) if tid else None
        if rec is None and tid in self.lineage_specs:
            # record was GC'd; resurrect a slim DONE record from the kept spec
            spec, roids, budget = self.lineage_specs[tid]
            rec = TaskRecord(spec=spec, result_oids=roids, state=DONE)
            rec.reconstructions_left = budget
            rec.done.set()
            self.tasks[tid] = rec
            # re-enroll for pruning — a probe that aborts recovery must not
            # leave an immortal record behind
            self._mark_task_terminal(rec)
        if rec is None:
            return None
        spec = rec.spec
        if spec.actor_id or spec.num_returns == "streaming":
            return None
        return rec

    async def _recover_object(self, oid: str) -> bool:
        """Re-execute the creating task so `oid` materializes again
        (reference: src/ray/core_worker/object_recovery_manager.cc:1-191).
        Returns True when a reconstruction is running (or already queued)."""
        rec = self._lineage_rec(oid)
        if rec is None:
            if self.cluster is not None:
                # an oid the head never allocated (a node-local sub-task's
                # result serialized into data): ask the cluster who has it
                return await self.cluster.search_object(oid)
            return False
        if rec.state in (PENDING, PENDING_DEPS, "SPAWNING", RUNNING):
            return True  # reconstruction already in flight
        if rec.reconstructions_left < 0:
            # budget: at least one recovery even for max_retries=0 tasks —
            # losing a result to eviction is not the task's failure
            rec.reconstructions_left = max(rec.spec.max_retries, 1)
        if rec.reconstructions_left == 0:
            return False
        rec.reconstructions_left -= 1
        spec = rec.spec
        # resurrect result object slots
        for roid in rec.result_oids:
            meta = self.objects.get(roid)
            if meta is None:
                self.objects[roid] = ObjectMeta(object_id=roid,
                                                creating_task=spec.task_id,
                                                refcount=1)
            else:
                meta.location = "pending"
                meta.inline_value = None
                meta.spill_path = None
            ev = self.object_events.get(roid)
            if ev is None or ev.is_set():
                self.object_events[roid] = asyncio.Event()
            self.lineage.pop(roid, None)
        fresh = TaskRecord(spec=spec, result_oids=rec.result_oids,
                           retries_left=spec.max_retries,
                           ts_submit=time.time())
        fresh.reconstructions_left = rec.reconstructions_left
        self.tasks[spec.task_id] = fresh
        # recover lost ref args first (recursive lineage walk), then wire
        # deps exactly like submit()
        for kind, v in list(spec.args) + list(spec.kwargs.values()):
            if kind != "ref":
                continue
            arg_meta = self.objects.get(v)
            arg_lost = (arg_meta is None or
                        self._remote_holder_dead(arg_meta) or
                        (arg_meta.location == "shm"
                         and not self.store.exists(v)))
            if arg_lost and not await self._recover_object(v):
                err = exc.ObjectLostError(v)
                self._fail_task(fresh, err)
                return False
            arg_meta = self.objects.get(v)
            if arg_meta is not None:
                arg_meta.pinned += 1
                if arg_meta.ts_pinned == 0.0:
                    arg_meta.ts_pinned = time.time()
                fresh.pinned.append(v)
            if arg_meta is None or arg_meta.location == "pending":
                fresh.deps_remaining.add(v)
                self.dep_waiters[v].add(spec.task_id)
        if fresh.deps_remaining:
            fresh.state = PENDING_DEPS
        else:
            self._enqueue_ready(fresh)
        self._schedule()
        return True

    def _remote_holder_dead(self, meta: ObjectMeta) -> bool:
        """True when an object's bytes live only on dead nodes: the
        authoritative remote location's node is gone AND no surviving holder
        has a copy. The recursive lineage walk treats such args as lost
        (same as a vanished shm segment) instead of queueing a pull that can
        only time out against a corpse."""
        if self.cluster is None or not meta.location.startswith("remote:"):
            return False
        node = self.cluster.nodes.get(meta.location.split(":", 1)[1])
        if node is not None and node.alive:
            return False
        for h in meta.holders:
            n = self.cluster.nodes.get(h)
            if n is not None and n.alive:
                return False
        return True

    async def _recover_lost_objects(self, oids: List[str], node_id: str,
                                    t_seen: float, t_detect: float):
        """Eager recovery sweep after a node death (cluster._on_node_dead):
        re-enqueue the creating task of every object whose only copy died
        with the node. Objects with no usable lineage (actor/stream outputs,
        exhausted reconstruction budget) resolve to ObjectLostError NOW so
        waiters fail fast instead of timing out. Trace windows land in the
        head timeline (`recover.detect` = last heartbeat → detection,
        `recover.reconstruct` = the sweep itself) so `python -m ray_tpu_torch
        timeline` attributes recovery cost per phase."""
        from ..util import metrics
        t0 = time.time()
        tracing.record_window("recover.detect", "recovery", None,
                              t_seen, t_detect,
                              args={"node_id": node_id, "objects": len(oids)})
        recovered = 0
        for oid in oids:
            ok = False
            try:
                ok = await self._recover_object(oid)
            except Exception:  # noqa: BLE001 - recovery must sweep every oid
                ok = False
            if ok:
                recovered += 1
                continue
            meta = self.objects.get(oid)
            if meta is not None and meta.location != "error" and not (
                    meta.location in ("shm", "inline", "spilled")):
                meta.error = exc.ObjectLostError(oid)
                meta.location = "error"
            ev = self.object_events.get(oid)
            if ev is not None:
                ev.set()
            self._resolve_dep(oid)
        metrics.get_or_create(
            metrics.Counter, "reconstructions_total",
            "lineage reconstructions started after node death").inc(recovered)
        if recovered < len(oids):
            metrics.get_or_create(
                metrics.Counter, "reconstruction_failures_total",
                "objects resolved to ObjectLostError after node death"
            ).inc(len(oids) - recovered)
        tracing.record_window("recover.reconstruct", "recovery", None,
                              t0, time.time(),
                              args={"node_id": node_id, "lost": len(oids),
                                    "reconstructing": recovered})
        self._schedule()

    # ---------------------------------------------------------------- streaming
    def _on_stream_item(self, p: dict):
        self.register_put(p["oid"], p["meta_len"], p["size"], p.get("inline"),
                          p.get("contained"))
        st = self.streams.get(p["task_id"])
        if st is not None:
            st.items.append(p["oid"])
            st.cond.set()

    async def next_stream_item(self, task_id: str, index: int, timeout=None):
        st = self.streams.get(task_id)
        if st is None:
            raise ValueError(f"no stream for task {task_id}")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if index < len(st.items):
                st.max_served = max(st.max_served, index + 1)
                return st.items[index]
            if st.error is not None:
                self._mark_stream_drained(task_id, st)
                raise st.error if isinstance(st.error, Exception) else exc.TaskError("stream", str(st.error))
            if st.finished:
                self._mark_stream_drained(task_id, st)
                return None  # StopIteration sentinel
            st.cond.clear()
            remaining = None if deadline is None else deadline - time.monotonic()
            try:
                await asyncio.wait_for(st.cond.wait(), remaining)
            except asyncio.TimeoutError:
                raise exc.GetTimeoutError("stream next() timed out") from None

    def _maybe_drop_stream(self, task_id: str, st: StreamState):
        """Single deletion rule: the producer finished, a consumer saw the end
        (or every handle is gone), and no generator copy remains open. Items
        never handed to a consumer drop the register_put refcount no consumer
        ObjectRef will ever balance."""
        if st.finished and st.drained and st.open_handles <= 0:
            if self.streams.pop(task_id, None) is not None:
                self.decref(st.items[st.max_served:])

    def _mark_stream_drained(self, task_id: str, st: StreamState):
        st.drained = True
        self._maybe_drop_stream(task_id, st)

    def open_stream(self, task_id: str):
        st = self.streams.get(task_id)
        if st is not None:
            st.open_handles += 1

    def _worker_open_stream(self, w: WorkerConn, task_id: str):
        if task_id in self.streams:
            w.stream_refs[task_id] = w.stream_refs.get(task_id, 0) + 1
        self.open_stream(task_id)

    def _worker_close_stream(self, w: WorkerConn, task_id: str):
        n = w.stream_refs.get(task_id, 0)
        if n <= 1:
            w.stream_refs.pop(task_id, None)
        else:
            w.stream_refs[task_id] = n - 1
        self.close_stream(task_id)

    def close_stream(self, task_id: str):
        """A generator handle was GC'd. Only when the LAST copy goes (a copy in
        a worker must not tear the stream down under the driver's iterator) is
        an abandoned stream's buffered state released."""
        st = self.streams.get(task_id)
        if st is None:
            return
        st.open_handles -= 1
        if st.open_handles > 0:
            return
        st.drained = True
        self._maybe_drop_stream(task_id, st)

    # ------------------------------------------------------------------ actors
    def register_actor(self, spec: TaskSpec, options, _journal: bool = True) -> str:
        actor = ActorRecord(actor_id=spec.actor_id, creation_spec=spec, options=options,
                            name=options.name, namespace=options.namespace or "default")
        # seed the directory with the creating handle's ref (handle_refs=1)
        self.objdir.register(spec.actor_id, refcount=1, location="other:actor")
        if options.name:
            key = (actor.namespace, options.name)
            if key in self.named_actors:
                raise ValueError(f"Actor name '{options.name}' already taken in namespace "
                                 f"'{actor.namespace}'")
            self.named_actors[key] = actor.actor_id
        self.actors[actor.actor_id] = actor
        if (_journal and self.gcs is not None and options.name
                and options.lifetime == "detached"):
            self.gcs.record("detached_actor", durable=True,
                            actor_id=actor.actor_id,
                            spec=spec, options=options)
        return actor.actor_id

    def lookup_actor(self, name: str, namespace: Optional[str]) -> str:
        key = (namespace or "default", name)
        aid = self.named_actors.get(key)
        if aid is None or self.actors[aid].state == A_DEAD:
            raise ValueError(f"Failed to look up actor '{name}' in namespace '{key[0]}'")
        self.actor_incref(aid)  # the handle about to be built owns this ref
        return aid

    def kill_actor(self, actor_id: str, no_restart: bool = True,
                   reason: str = "killed via kill()"):
        actor = self.actors.get(actor_id)
        if actor is None:
            return
        if actor.node_id is not None and self.cluster is not None:
            # the hosting node kills its local worker and owns any restart;
            # permanent death there comes back as an actor_dead report
            self.cluster.kill_actor(actor_id, actor.node_id, no_restart)
            if no_restart:
                actor.restarts_used = (actor.options.max_restarts + 1
                                       if actor.options else 1)
                self._fail_actor(actor, reason, allow_restart=False)
            return
        w = self.workers.get(actor.worker_id)
        if w is not None:
            self._kill_worker_proc(w)
        for sw in self.spawning.values():  # creation still spawning its worker
            if sw.actor_id == actor_id:
                self._kill_worker_proc(sw)
        if no_restart:
            actor.restarts_used = actor.options.max_restarts + 1 if actor.options else 1
        self._fail_actor(actor, reason, allow_restart=not no_restart)

    def _requeue_actor_creation(self, actor: ActorRecord) -> bool:
        """Re-place a restartable actor whose cluster node died: a fresh
        creation TaskRecord through the normal placement path (may land on
        the head or any other node). Returns False when out of restarts."""
        if not (actor.options is not None
                and (actor.options.max_restarts == -1
                     or actor.restarts_used < actor.options.max_restarts)):
            return False
        actor.restarts_used += 1
        actor.state = A_RESTARTING
        actor.worker_id = None
        actor.node_id = None
        actor.resources_claimed = False
        cspec = actor.creation_spec
        old_rec = self.tasks[cspec.task_id]
        rec = TaskRecord(spec=cspec, result_oids=old_rec.result_oids,
                         ts_submit=time.time())
        rec.pinned, old_rec.pinned = old_rec.pinned, []
        rec.pinned_actors, old_rec.pinned_actors = old_rec.pinned_actors, []
        rec.pinned_streams, old_rec.pinned_streams = old_rec.pinned_streams, []
        self.tasks[cspec.task_id] = rec
        self._enqueue_ready(rec)
        self._schedule()
        return True

    def _fail_actor(self, actor: ActorRecord, reason: str, allow_restart: bool):
        if actor.state == A_DEAD:
            return
        can_restart = (allow_restart and actor.options is not None and
                       (actor.options.max_restarts == -1 or
                        actor.restarts_used < actor.options.max_restarts))
        if can_restart:
            actor.restarts_used += 1
            actor.state = A_RESTARTING
            actor.worker_id = None
            # re-run the creation spec on a fresh dedicated worker
            cspec = actor.creation_spec
            old_rec = self.tasks[cspec.task_id]
            rec = TaskRecord(spec=cspec, result_oids=old_rec.result_oids,
                             ts_submit=time.time())
            # carry the arg/nested-ref pins submit() took — the replaced rec
            # would otherwise leak them (its _unpin never runs)
            rec.pinned, old_rec.pinned = old_rec.pinned, []
            rec.pinned_actors, old_rec.pinned_actors = old_rec.pinned_actors, []
            rec.pinned_streams, old_rec.pinned_streams = old_rec.pinned_streams, []
            self.tasks[cspec.task_id] = rec
            self._spawn_worker(actor)
            rec.state = "SPAWNING"
            return
        actor.state = A_DEAD
        actor.death_reason = reason
        self.objdir.erase(actor.actor_id)
        if self.gcs is not None:
            self.gcs.record("actor_dead", durable=True,
                            actor_id=actor.actor_id)
        if actor.name:
            self.named_actors.pop((actor.namespace, actor.name), None)
        err = exc.ActorDiedError(actor.actor_id, reason)
        for rec in list(actor.queue):
            self._fail_task(rec, err)
        actor.queue.clear()
        for tid in list(actor.in_flight):
            rec = self.tasks.get(tid)
            if rec:
                self._fail_task(rec, err)
        actor.in_flight.clear()
        # A creation still SPAWNING never enters w.running, so no other path
        # resolves its result oid (e.g. kill() before the worker registered).
        if actor.creation_spec is not None:
            crec = self.tasks.get(actor.creation_spec.task_id)
            if crec is not None and crec.state not in (DONE, FAILED, CANCELLED):
                self._fail_task(crec, err)
            elif crec is not None:
                self._unpin(crec)       # the arguments kept for restarts
            # final death: the creation record (exempt from normal GC while the
            # actor lived — restart paths index it) can now be pruned
            self._done_task_ids.append(actor.creation_spec.task_id)
        self._dead_actor_ids.append(actor.actor_id)
        while len(self._dead_actor_ids) > self.dead_actor_retention:
            old = self._dead_actor_ids.popleft()
            stale = self.actors.get(old)
            if stale is not None and stale.state == A_DEAD:
                del self.actors[old]
        self._gc_tasks()
        self._release_actor_allocation(actor)

    def _on_worker_dead(self, w: WorkerConn, reason: str):
        if w.state == "dead":
            return
        w.state = "dead"
        self._unmark_idle(w)
        if self.ownership:
            # ownership transfer on owner death: the head's write-behind
            # cache already holds every descriptor, so clearing the owner
            # makes it authoritative (lineage recovery keys off creating_task
            # as before)
            for meta in self.objects.values():
                if meta.owner == w.worker_id:
                    meta.owner = None
        if w.pid:
            # reclaim the dead client's arena pins (plasma disconnect
            # cleanup) so its zero-copy reads can't zombie blocks forever
            try:
                self.store.release_pins_of(w.pid)
            except Exception:  # noqa: BLE001 - arena already closed
                pass
        # Undo outstanding blocked-CPU releases first: the failure paths below
        # release each task's full resources, which would double-release the
        # CPU that _on_blocked already handed back.
        for tid in list(w.blocked_tasks):
            rec = self.tasks.get(tid)
            if rec is not None:
                self._reclaim_blocked_cpu(rec)
        w.blocked_tasks.clear()
        crash = exc.WorkerCrashedError(reason)
        for tid in list(w.running):
            rec = self.tasks.get(tid)
            if rec is None:
                continue
            spec = rec.spec
            if spec.is_actor_creation and w.actor_id:
                # the actor lifecycle below (_fail_actor via w.actor_id) owns
                # creation retry/failure; re-enqueueing the creation rec here
                # would race it and double-claim the actor's resources
                continue
            if spec.actor_id and not spec.is_actor_creation:
                actor = self.actors.get(spec.actor_id)
                if actor:
                    actor.in_flight.discard(tid)
                can_retry = (actor is not None and actor.options and
                             rec.retries_left > 0 and actor.options.max_task_retries != 0)
                if can_retry:
                    rec.retries_left -= 1
                    actor.queue.appendleft(rec)
                    rec.state = PENDING
                else:
                    self._fail_task(rec, exc.ActorDiedError(spec.actor_id, reason)
                                    if spec.actor_id else crash)
            elif rec.retries_left > 0 and not rec.cancelled:
                rec.retries_left -= 1
                self._release_task_resources(rec)
                self._enqueue_ready(rec)
            else:
                self._fail_task(rec, crash)
                self._release_task_resources(rec)
        w.running.clear()
        if w.actor_id:
            actor = self.actors.get(w.actor_id)
            if actor is not None and actor.state in (A_ALIVE, A_PENDING):
                self._fail_actor(actor, f"worker died: {reason}", allow_restart=True)
        # release handle/stream refs the dead worker's deserialized handles
        # held — a crash must not pin other actors or streams alive forever
        for aid, n in list(w.actor_refs.items()):
            for _ in range(n):
                self.actor_decref(aid)
        w.actor_refs.clear()
        for sid, n in list(w.stream_refs.items()):
            for _ in range(n):
                self.close_stream(sid)
        w.stream_refs.clear()

    # ----------------------------------------------------------- cancel / kill
    def cancel(self, task_id: str, force: bool = False):
        if task_id.startswith("obj-"):
            meta = self.objects.get(task_id)
            task_id = meta.creating_task if meta else task_id
        rec = self.tasks.get(task_id)
        if rec is None:
            return
        rec.cancelled = True
        if (rec.state == RUNNING and rec.node_id is not None
                and self.cluster is not None):
            node = self.cluster.nodes.get(rec.node_id)
            if node is not None and node.alive:
                self.cluster.cancel(task_id, rec.node_id, force)
                return
            # stale node_id (node died; task since failed or retried
            # elsewhere): fall through to the local paths
        if rec.state in (PENDING, PENDING_DEPS):
            # _fail_task also removes the rec from the ready index
            self._fail_task(rec, exc.TaskCancelledError(task_id))
            if rec.spec.actor_id and not rec.spec.is_actor_creation:
                actor = self.actors.get(rec.spec.actor_id)
                if actor is not None:
                    try:
                        actor.queue.remove(rec)
                    except ValueError:
                        pass
        elif rec.state == RUNNING:
            w = self.workers.get(rec.worker_id)
            if w is None:
                return
            if force:
                self._kill_worker_proc(w)  # reaper/EOF path marks the task failed
            else:
                protocol.awrite_msg(w.writer, "cancel_exec", task_id=task_id)

    # ------------------------------------------------------------- blocked mgmt
    def _blocked_cpu_eligible(self, rec: TaskRecord) -> bool:
        """Actor methods run inside the actor's standing allocation, so
        block/unblock must not touch the pool for them."""
        return not (rec.spec.actor_id and not rec.spec.is_actor_creation)

    def _reclaim_blocked_cpu(self, rec: TaskRecord):
        """Inverse of _on_blocked's release; every path that clears a task
        from blocked_tasks must call this to keep the pool balanced."""
        if self._blocked_cpu_eligible(rec):
            self._claim(self._cpu_only(rec.spec.resources), self._task_pool(rec.spec))

    def _on_blocked(self, w: WorkerConn, task_id: str):
        """Worker blocked in get(): release its cpu so the pool can make
        progress (ref: raylet's NotifyWorkerBlocked / resource borrowing)."""
        rec = self.tasks.get(task_id)
        if rec is None or task_id in w.blocked_tasks:
            return
        w.blocked_tasks.add(task_id)
        if self._blocked_cpu_eligible(rec):
            # CPU only: GPU cards stay bound to the blocked task (releasing
            # them would let the scheduler double-book physical cards)
            self._release(self._cpu_only(rec.spec.resources), self._task_pool(rec.spec))
        self._schedule()

    def _on_unblocked(self, w: WorkerConn, task_id: str):
        rec = self.tasks.get(task_id)
        if rec is None or task_id not in w.blocked_tasks:
            return
        w.blocked_tasks.discard(task_id)
        # may drive available negative: intentional oversubscription, the
        # scheduler simply won't dispatch until it recovers
        self._reclaim_blocked_cpu(rec)

    @staticmethod
    def _cpu_only(resources: Dict[str, float]) -> Dict[str, float]:
        return {k: v for k, v in resources.items() if k != "GPU"}

    # --------------------------------------------------------- placement groups
    def create_placement_group(self, bundles: List[Dict[str, float]], strategy: str,
                               name: str = "") -> str:
        """Single-host reservation (every bundle on the head). Cluster mode
        goes through create_pg_any, which distributes bundles across nodes
        per strategy (ref: gcs_placement_group_scheduler.cc)."""
        pg_id = ids.group_id()
        committed: Dict[str, float] = {}
        for b in bundles:  # cumulative: co-located bundles must fit TOGETHER
            if not all(self.available.get(k, 0) - committed.get(k, 0) + 1e-9
                       >= v for k, v in b.items()):
                raise ValueError(f"Cannot reserve bundle {b}: insufficient resources "
                                 f"(available={self.available}, "
                                 f"already reserved={committed})")
            for k, v in b.items():
                committed[k] = committed.get(k, 0) + v
        bs = []
        for b in bundles:
            self._claim(b, self.available)
            bundle = Bundle(resources=dict(b), available=dict(b))
            self.ready_queue.register_pool(bundle.available)
            bs.append(bundle)
        self.pgroups[pg_id] = PlacementGroupRecord(pg_id=pg_id, bundles=bs,
                                                   strategy=strategy, name=name)
        return pg_id

    def _plan_pg_hosts(self, bundles: List[Dict[str, float]],
                       strategy: str,
                       use_totals: bool = False) -> List[Optional[str]]:
        """Per-bundle host assignment (None = head). Cumulative fit is
        tracked so co-located bundles must fit TOGETHER. `use_totals` plans
        against host TOTALS instead of current availability — the
        feasibility oracle that separates 'retry later' from 'never'."""
        import collections as _c
        hosts: List[Optional[str]] = [None] + [
            nid for nid, n in self.cluster.nodes.items() if n.alive]

        def pool(h):
            if use_totals:
                return (self.total if h is None
                        else self.cluster.nodes[h].resources)
            return (self.available if h is None
                    else self.cluster.nodes[h].available)

        committed: Dict[Optional[str], Dict[str, float]] = {
            h: _c.defaultdict(float) for h in hosts}

        def fits(b, h):
            p = pool(h)
            return all(p.get(k, 0) - committed[h][k] + 1e-9 >= v
                       for k, v in b.items())

        def take(b, h):
            for k, v in b.items():
                committed[h][k] += v

        if strategy in ("PACK", "STRICT_PACK"):
            for h in hosts:  # one host for everything; head preferred
                ok = True
                for b in bundles:
                    if fits(b, h):
                        take(b, h)
                    else:
                        ok = False
                        break
                if ok:
                    return [h] * len(bundles)
                committed[h] = _c.defaultdict(float)
            if strategy == "STRICT_PACK":
                raise ValueError(
                    "STRICT_PACK: no single node fits every bundle")
            # PACK falls through to best-effort dispersal
        assign: List[Optional[str]] = []
        used: set = set()
        for b in bundles:
            if strategy == "STRICT_SPREAD":
                cands = [h for h in hosts if h not in used]
            elif strategy == "PACK":
                # overflow dispersal keeps PACK's locality bias: fill hosts
                # already in use before opening a new one
                cands = ([h for h in hosts if h in used]
                         + [h for h in hosts if h not in used])
            else:  # SPREAD: prefer unused hosts, allow reuse
                cands = ([h for h in hosts if h not in used]
                         + [h for h in hosts if h in used])
            # the head's id IS None — a None default would shadow it
            h = _MISSING = object()
            for cand in cands:
                if fits(b, cand):
                    h = cand
                    break
            if h is _MISSING:
                raise ValueError(
                    f"Cannot reserve bundle {b} under {strategy}: no "
                    f"{'distinct ' if strategy == 'STRICT_SPREAD' else ''}"
                    f"node fits it")
            take(b, h)
            used.add(h)
            assign.append(h)
        return assign

    async def create_pg_any(self, bundles: List[Dict[str, float]],
                            strategy: str, name: str = "") -> str:
        """Cluster-aware placement group creation: bundles land on the head
        AND worker nodes per strategy; remote bundles reserve through a
        node-local single-bundle-group (ref: the GCS placement group
        scheduler's 2-phase reserve)."""
        if self.cluster is None or not self.cluster.nodes:
            return self.create_placement_group(bundles, strategy, name)
        try:
            assign = self._plan_pg_hosts(bundles, strategy)
        except ValueError:
            # transient shortage, or can-never-fit? Plan against TOTALS to
            # tell them apart, so callers retry only the retryable
            # (placement_group()'s poll loop keys on the error type)
            try:
                self._plan_pg_hosts(bundles, strategy, use_totals=True)
            except ValueError as e:
                raise exc.PlacementGroupInfeasibleError(str(e)) from None
            raise
        pg_id = ids.group_id()
        bs: List[Bundle] = []
        created_remote: List[tuple] = []  # (node_id, remote_pg_id, resources)
        try:
            # head claims are sync; remote reservations on DISTINCT nodes go
            # out concurrently (one slow node overlaps, not serializes)
            remote_items = []
            for i, (b, host) in enumerate(zip(bundles, assign)):
                if host is None:
                    if not self._resources_fit(b, self.available):
                        raise ValueError(f"Cannot reserve bundle {b} on head")
                    self._claim(b, self.available)
                    bundle = Bundle(resources=dict(b), available=dict(b))
                    self.ready_queue.register_pool(bundle.available)
                    bs.append(bundle)
                else:
                    remote_items.append((i, b, host))
                    bs.append(None)  # filled below
            results = await asyncio.gather(
                *(self.cluster.create_remote_pg(host, [b])
                  for _i, b, host in remote_items),
                return_exceptions=True)
            first_err = None
            for (i, b, host), res in zip(remote_items, results):
                if isinstance(res, BaseException):
                    first_err = first_err or res
                    continue
                created_remote.append((host, res, dict(b)))
                bs[i] = Bundle(resources=dict(b), available=dict(b),
                               node_id=host, remote_pg_id=res,
                               remote_index=0)
            if first_err is not None:
                raise first_err
        except BaseException:
            for bundle in bs:  # rollback partial reservations
                if bundle is not None and bundle.node_id is None:
                    self.ready_queue.drop_pool(bundle.available)
                    self._release(bundle.resources, self.available)
            for host, rid, res in created_remote:
                self.cluster.remove_remote_pg(host, rid)
                self.cluster.restore_mirror_bundle(host, res)
            raise
        self.pgroups[pg_id] = PlacementGroupRecord(pg_id=pg_id, bundles=bs,
                                                   strategy=strategy,
                                                   name=name)
        return pg_id

    def _fail_pg_task(self, rec: TaskRecord, pg_id: str,
                      reason: str = "removed before this work could run"):
        """Fail work whose placement group is gone; actor creations go
        through _fail_actor so the actor record dies too (method calls fail
        instead of queueing forever — same as the infeasible-creation path)."""
        err = ValueError(f"placement group {pg_id} {reason}")
        if rec.spec.is_actor_creation:
            actor = self.actors.get(rec.spec.actor_id)
            if actor is not None:
                self._fail_actor(actor, str(err), allow_restart=False)
                return
        self._fail_task(rec, err)

    def remove_placement_group(self, pg_id: str):
        pg = self.pgroups.pop(pg_id, None)
        if pg is None:
            return
        # queued tasks bound to this group can never run (ref: reference
        # fails tasks of a removed PG) — fail them before dropping the pools
        for rec in list(self.ready_queue):
            if (rec.state == PENDING
                    and rec.spec.placement_group_id == pg_id):
                self._fail_pg_task(rec, pg_id)
        self.ready_queue.retire_pg_sigs(pg_id)
        for b in pg.bundles:
            if b.node_id is not None:
                # remote bundle: the hosting node releases its own reserve
                if self.cluster is not None:
                    self.cluster.remove_remote_pg(b.node_id, b.remote_pg_id)
                    node = self.cluster.nodes.get(b.node_id)
                    if node is not None:  # restore the optimistic mirror
                        for k, v in b.resources.items():
                            node.available[k] = node.available.get(k, 0) + v
                continue
            self.ready_queue.drop_pool(b.available)
            # Return only what no running task holds; each still-running PG
            # task settles its own claim into the cluster pool when it
            # finishes (_release with pool=None). Releasing b.resources here
            # would over-commit `available` until those tasks drain.
            self._release(b.available, self.available)

    # ------------------------------------------------------------------- state
    def state_snapshot(self, kind: str):
        if kind == "actors":
            return [{"actor_id": a.actor_id, "state": a.state, "name": a.name,
                     "namespace": a.namespace, "pid": (self.workers.get(a.worker_id).pid
                                                       if a.worker_id in self.workers else None),
                     "restarts": a.restarts_used}
                    for a in self.actors.values()]
        if kind == "tasks":
            # most-recent first: callers pass a limit, and the freshest tasks
            # are the ones a `list_tasks()` right after a submit must surface
            return [{"task_id": t.spec.task_id, "name": t.spec.name, "state": t.state,
                     "worker_id": t.worker_id,
                     "duration_s": (t.ts_end - t.ts_start) if t.ts_end else None,
                     "trace_id": t.spec.trace_id,
                     "phases": t.phases}
                    for t in sorted(self.tasks.values(),
                                    key=lambda t: t.ts_submit, reverse=True)]
        if kind == "objects":
            from .health import ledger_ages
            now = time.time()
            return [{"object_id": o.object_id, "size": o.size, "location": o.location,
                     "refcount": o.refcount, "pinned": o.pinned,
                     "creating_task": o.creating_task,
                     **ledger_ages(o, now)}
                    for o in self.objects.values()]
        if kind == "workers":
            return [{"worker_id": w.worker_id, "state": w.state, "pid": w.pid,
                     "actor_id": w.actor_id, "running": len(w.running)}
                    for w in self.workers.values()]
        if kind == "nodes":
            rows = [{"node_id": self.node_id, "alive": True, "is_head": True,
                     "resources": dict(self.total),
                     "available": dict(self.available),
                     "object_store_used": self.store_used,
                     "object_store_capacity": self.store_capacity,
                     # node↔node bytes the head had to stage (fallback path;
                     # ~0 when the direct data plane is healthy)
                     "staged_bytes": (self.cluster.staged_bytes
                                      if self.cluster is not None else 0)}]
            if self.cluster is not None:
                rows.extend(self.cluster.node_rows())
            return rows
        if kind == "placement_groups":
            return [{"pg_id": pg.pg_id, "name": pg.name, "strategy": pg.strategy,
                     "bundles": [dict(b.resources) for b in pg.bundles]}
                    for pg in self.pgroups.values()]
        if kind == "metrics":
            # this process's util.metrics registry — the controller process
            # holds the scheduler/prefetch/transfer series, so remote
            # surfaces (dashboard actor) scrape through here; gauges are
            # refreshed at scrape time so a scrape never races the 1 Hz tick
            from ..util import metrics
            try:
                self.health.publish_gauges()
            except Exception:  # noqa: BLE001 - a scrape never fails
                pass
            return metrics.collect()
        if kind == "cluster_health":
            return self.cluster_health()
        if kind == "alerts":
            return self.health.alerts.events()
        raise ValueError(f"unknown state kind {kind}")
