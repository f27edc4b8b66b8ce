"""Cross-host control plane: a head controller federating worker-node agents.

Reference parity: the reference cluster is raylets federated through the GCS
(src/ray/raylet/node_manager.h:142 NodeManager, node table in
src/ray/gcs/gcs_server/gcs_node_manager.cc), with the object manager moving
objects between per-node plasma stores on demand
(src/ray/object_manager/object_manager.cc Push/Pull). GPU-first re-design:

- The HEAD is the driver's in-process controller (api.init(cluster_port=N)).
  It owns the cluster-wide object table, the actor/task registries, naming,
  and placement. There is no separate GCS process — the head IS the GCS,
  which is the right cut for the GPU topology this serves (one driver host
  orchestrating CPU-actor fleets that feed GPU hosts; SPMD compute scales
  through torch.distributed on the data plane, not through this plane).
- A NODE is `python -m ray_tpu_torch._private.node_main --address head:port`: a
  full local Controller (own shm arena, own worker pool, own scheduler) plus
  one TCP uplink. A node looks like a single fat worker to the head and like
  a normal controller to its local workers, so every single-host mechanism
  (runtime envs, streams, actor restarts, spilling) works unchanged on it.
- Placement happens once, at the head, when a task's deps are satisfied:
  DEFAULT = local-first with overflow to the least-loaded fitting node;
  SPREAD = round-robin across fitting nodes; NodeAffinity = that node (hard
  fails if gone, soft falls back). Placement groups SPAN nodes: STRICT_PACK
  bundles reserve on one host, PACK/SPREAD/STRICT_SPREAD distribute bundles
  across fitting nodes via create_remote_pg (node-local reservation groups
  keyed by a head correlation ref).
- Objects move lazily, pull-based, like the reference: results stay in the
  producing node's store and the head records location "remote:<node_id>",
  pulling bytes only when something actually `get`s them. Node↔node moves
  are DIRECT: every node runs a token-gated data server
  (node_agent.ObjectDataServer); the head brokers LOCATION only, handing
  the consumer a redirect {addr, owner} so dep bytes and fetch misses flow
  producer→consumer in one hop instead of staging through the head (ref:
  object_manager.cc Push/Pull between plasma stores). The head stages
  bytes itself only as a fallback (producer gone/evicted) and counts every
  staged byte in `staged_bytes` so tests can assert the direct path held.
- A worker ON a node submits work to its local controller; work the node
  cannot or should not place (infeasible there, SPREAD/NodeAffinity
  strategies, methods on actors living elsewhere) spills UP to the head,
  which places it cluster-wide — the analog of raylet spillback scheduling.

Wire: the same length-prefixed pickle framing as the worker protocol, over
TCP, with bidirectional request/response multiplexing. A shared secret
(RTPT_CLUSTER_TOKEN) gates node registration and the per-node data
servers; when unset, the head AUTO-GENERATES one at start (exported into
os.environ so node_main / providers spawned from this process inherit it) —
an empty token would let any local user speak the pickle wire protocol to
the loopback port. The trust model otherwise matches the reference's
in-cluster gRPC (flat trusted network).
"""

import asyncio
import os
import socket as _socket
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .. import exceptions as exc
from .._native import codec as _codec
from ..util.scheduling_strategies import NodeAffinitySchedulingStrategy
from . import protocol
from .task_spec import TaskSpec

HEARTBEAT_S = 1.0


def node_death_timeout_s() -> float:
    """Head-side silence threshold before a node is declared dead. Generous
    vs HEARTBEAT_S: a node mid-compile on a loaded 1-core host can lag
    heartbeats by seconds without being gone."""
    return float(os.environ.get("RAY_TPU_NODE_DEATH_S", 15 * HEARTBEAT_S))


def cluster_token() -> str:
    return os.environ.get("RTPT_CLUSTER_TOKEN", "")


@dataclass
class NodeConn:
    """Head-side record of one registered worker node (ref: GcsNodeInfo)."""

    node_id: str
    writer: asyncio.StreamWriter
    resources: Dict[str, float]
    available: Dict[str, float]      # optimistic mirror, trued by heartbeats
    host: str = ""
    pid: int = 0
    data_addr: str = ""              # node's ObjectDataServer "host:port"
    inflight: Dict[str, object] = field(default_factory=dict)  # task_id -> rec
    actors: Set[str] = field(default_factory=set)
    alive: bool = True
    last_seen: float = field(default_factory=time.time)
    ship_seq: int = 0                # per-node fwd_task sequence (see "stats")
    direct_pull_bytes: int = 0       # node-reported data-plane counters
    direct_serve_bytes: int = 0
    # health signal plane: latest node-side health_snapshot() dict riding
    # the heartbeat, plus observed heartbeat cadence/latency (latency from
    # the node-stamped ts inside the payload; clocks on one host, so skew
    # is bounded by NTP on multi-host)
    health: Dict[str, object] = field(default_factory=dict)
    hb_interval_s: float = 0.0
    hb_latency_s: float = 0.0
    # negotiated native-codec version for frames TO this node (0 = pickle)
    codec_ver: int = 0


class ClusterServer:
    """Runs inside the head controller's event loop."""

    def __init__(self, controller):
        self.c = controller
        self.nodes: Dict[str, NodeConn] = {}
        self.port: Optional[int] = None
        self.host: str = "127.0.0.1"
        self._server = None
        self._reqs: Dict[int, asyncio.Future] = {}
        self._req_counter = 0
        self._rr = 0  # SPREAD round-robin cursor
        # Grow-only union of every known node's static resource keys,
        # rebuilt lazily when the node count changes. place()'s hot path
        # uses it to prove "no node could EVER fit this demand" in
        # O(demand kinds) — head-pinned tasks (a custom resource only the
        # head advertises) skip the O(nodes) fitting/feasible scans
        # entirely. Never shrunk on node death: a stale key only disables
        # the shortcut, and the full scans handle dead nodes.
        self._node_res_keys: Set[str] = set()
        self._node_res_len = -1  # len(self.nodes) at last union rebuild
        self._sweeper: Optional[asyncio.Task] = None
        self.staged_bytes = 0  # bytes the head staged for node↔node moves
        #                        (fallback path only — should stay ~0)

    async def start(self, port: int, host: str = None):
        # loopback by default: binding all interfaces is opt-in
        # (RAY_TPU_CLUSTER_HOST=0.0.0.0) and then a cluster token is
        # mandatory — the wire is pickle, so an open unauthenticated port
        # would hand code execution to any network peer.
        host = host or os.environ.get("RAY_TPU_CLUSTER_HOST", "127.0.0.1")
        if host not in ("127.0.0.1", "localhost", "::1") and not cluster_token():
            raise ValueError(
                f"refusing to bind cluster port on {host!r} without "
                f"RTPT_CLUSTER_TOKEN set (pickle wire protocol)")
        if not cluster_token():
            # even on loopback an EMPTY token would let any other local user
            # on a multi-user host speak the pickle wire protocol (= code
            # execution as this user). Generate one; children (node_main,
            # node providers, workers) inherit it through the environment.
            import secrets
            os.environ["RTPT_CLUSTER_TOKEN"] = secrets.token_hex(16)
        self._server = await asyncio.start_server(self._on_node, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        self.host = (_socket.gethostname()
                     if host not in ("127.0.0.1", "localhost", "::1")
                     else "127.0.0.1")
        self._sweeper = self.c.loop.create_task(self._liveness_sweep())

    async def _liveness_sweep(self):
        """Declare nodes dead on heartbeat SILENCE, not just TCP EOF: a
        network partition or half-open connection (no FIN/RST) otherwise
        leaves a vanished node alive=True forever with its inflight tasks
        hung (ref: gcs_heartbeat_manager.cc num_heartbeats_timeout). Closing
        the writer tears the socket down, which pops the node out of
        _on_node's read loop → the single _on_node_dead failover path."""
        while not self.c._shutdown:
            await asyncio.sleep(2 * HEARTBEAT_S)
            now = time.time()
            for node in list(self.nodes.values()):
                if node.alive and now - node.last_seen > node_death_timeout_s():
                    print(f"[cluster] node {node.node_id} heartbeat-silent "
                          f"{now - node.last_seen:.1f}s; declaring dead",
                          file=sys.stderr)
                    try:
                        self.c.health.note_heartbeat_missed(
                            node.node_id, now - node.last_seen)
                    except Exception:  # noqa: BLE001
                        pass
                    node.alive = False
                    try:
                        node.writer.close()
                    except Exception:  # noqa: BLE001
                        pass

    def close(self):
        if self._sweeper is not None:
            self._sweeper.cancel()
        if self._server is not None:
            self._server.close()
        for node in self.nodes.values():
            try:
                node.writer.close()
            except Exception:  # noqa: BLE001
                pass

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # ----------------------------------------------------------- connections
    async def _on_node(self, reader, writer):
        # auth happens on a PLAINTEXT hello line BEFORE any pickle frame is
        # read — the framing is pickle, and unpickling pre-auth bytes would
        # hand code execution to whoever reached the port
        import hmac
        try:
            hello = await asyncio.wait_for(reader.readline(), timeout=10)
        except (asyncio.TimeoutError, OSError):
            writer.close()
            return
        expect = f"RTPT1 {cluster_token()}\n".encode()
        if not hmac.compare_digest(hello, expect):
            try:
                writer.write(b"DENIED bad cluster token\n")
                await writer.drain()
            except OSError:
                pass
            writer.close()
            return
        msg = await protocol.aread_msg(reader)
        if msg is None or msg[0] != "register_node":
            writer.close()
            return
        p = msg[1]
        node = NodeConn(node_id=p["node_id"], writer=writer,
                        resources=dict(p["resources"]),
                        available=dict(p["resources"]),
                        host=p.get("host", ""), pid=p.get("pid", 0),
                        data_addr=p.get("data_addr", ""))
        node.codec_ver = _codec.negotiate(p.get("codec_ver", 0))
        self.nodes[node.node_id] = node
        try:
            self.c.health.note_node_alive(node.node_id)
        except Exception:  # noqa: BLE001
            pass
        protocol.awrite_msg(writer, "register_ok", head_node_id=self.c.node_id,
                            codec_ver=node.codec_ver)
        self.c._schedule()
        try:
            while True:
                msg = await protocol.aread_msg(reader)
                if msg is None:
                    break
                await self._handle_node_msg(node, msg[0], msg[1])
        finally:
            node.alive = False
            self.nodes.pop(node.node_id, None)
            if not self.c._shutdown:
                self._on_node_dead(node)

    async def _handle_node_msg(self, node: NodeConn, kind: str, p: dict):
        c = self.c
        if kind == "task_result":
            self._on_task_result(node, p)
        elif kind == "stats":
            # The heartbeat is a BASELINE, not the truth: tasks forwarded
            # but not yet received by the node (the ship is async; dep
            # collection can await pulls) are invisible to the node's own
            # accounting, and a wholesale overwrite would erase the head's
            # synchronous mirror debits for them → over-forwarding bursts.
            # Each fwd_task carries a per-node sequence number; the node
            # echoes the highest it has PROCESSED, and the head re-debits
            # every inflight claim the echo can't cover yet.
            base = dict(p["available"])
            acked = p.get("fwd_seq", 0)
            for rec in node.inflight.values():
                spec = rec.spec
                if spec.actor_id and not spec.is_actor_creation:
                    continue  # methods carry no mirror claim
                if spec.placement_group_id:
                    continue  # PG tasks draw from their bundle
                seq = getattr(rec, "fwd_seq", None)
                if seq is None or seq > acked:
                    for k, v in spec.resources.items():
                        base[k] = base.get(k, 0) - v
            node.available = base
            node.direct_pull_bytes = p.get("direct_pull_bytes", 0)
            node.direct_serve_bytes = p.get("direct_serve_bytes", 0)
            now = time.time()
            node.hb_interval_s = now - node.last_seen
            h = p.get("health")
            if h:
                node.health = dict(h)
                hts = node.health.get("ts")
                if hts:
                    node.hb_latency_s = max(now - hts, 0.0)
            node.last_seen = now
            # traced spans shipped from the node (fire-and-forget batches)
            # merge into the head's timeline; pid was stamped node-side so
            # Perfetto groups them per process
            for ev in p.get("spans") or ():
                c.timeline_events.append(ev)
            c._schedule()
        elif kind == "resp":
            fut = self._reqs.pop(p.pop("req_id"), None)
            if fut is not None and not fut.done():
                fut.set_result(p)
        elif kind == "fetch_object":
            # a node worker needs an object the node doesn't have: serve it
            # from the head store, or pull it from whichever node has it
            c.loop.create_task(self._serve_fetch(node, p))
        elif kind == "up_submit":
            c.loop.create_task(self._serve_up_submit(node, p))
        elif kind == "up_lookup_actor":
            try:
                aid = c.lookup_actor(p["name"], p.get("namespace"))
                self._node_reply(node, p["req_id"], actor_id=aid)
            except ValueError as e:
                self._node_reply(node, p["req_id"], error=e)
        elif kind == "up_kill_actor":
            c.kill_actor(p["actor_id"], no_restart=p.get("no_restart", True))
            self._node_reply(node, p["req_id"], ok=True)
        elif kind == "up_cancel":
            c.cancel(p["task_id"], force=p.get("force", False))
            self._node_reply(node, p["req_id"], ok=True)
        elif kind == "holds_object":
            # a node finished a direct pull: record it as an extra source so
            # later fetches can stripe streams across several holders
            meta = c.objects.get(p["oid"])
            if (meta is not None and meta.location.startswith("remote:")
                    and node.node_id != meta.location.split(":", 1)[1]
                    and node.node_id not in meta.holders):
                meta.holders.append(node.node_id)
        elif kind == "actor_dead":
            actor = c.actors.get(p["actor_id"])
            node.actors.discard(p["actor_id"])
            if actor is not None:
                c._fail_actor(actor, p.get("reason", "died on remote node"),
                              allow_restart=False)

    def _node_reply(self, node: NodeConn, req_id, **payload):
        protocol.awrite_msg(node.writer, "resp", req_id=req_id, **payload)

    def _rpc(self, node: NodeConn, kind: str, **payload) -> asyncio.Future:
        self._req_counter += 1
        req_id = self._req_counter
        fut = self.c.loop.create_future()
        self._reqs[req_id] = fut
        protocol.awrite_msg(node.writer, kind, req_id=req_id, **payload)
        return fut

    # ------------------------------------------------------------- placement
    def place(self, rec) -> Optional[NodeConn]:
        """Pick a node for a deps-ready task. None = run on the head.

        Called from _enqueue_ready; placement-group work, streaming
        generators, and actor methods never reach here — PG tasks follow
        their BUNDLE's host via forward_pg_task, streams need the head's
        stream table, and methods follow their actor."""
        spec: TaskSpec = rec.spec
        strat = spec.scheduling_strategy
        if isinstance(strat, NodeAffinitySchedulingStrategy):
            live = self._live()
            if getattr(strat, "locality_hint", False):
                # data-layer owner tag: run WHERE THE BLOCK IS. A merely
                # busy target still wins — the task queues there (ref: the
                # locality lease policy; task wait ≪ block transfer, and
                # the data layer's in-flight caps bound the pileup). Only a
                # dead or never-feasible target falls back to DEFAULT
                # (which chases holders itself).
                target_head = strat.node_id == self.c.node_id
                node = None if target_head else self.nodes.get(strat.node_id)
                if target_head or (node is not None and node.alive):
                    feasible_pool = (self.c.total if target_head
                                     else node.resources)
                    if self._fits(spec.resources, feasible_pool):
                        self._note_locality(
                            True,
                            self._locality_bytes(spec).get(
                                None if target_head else strat.node_id, 0))
                        return node
                return self._default_place(spec, live)
            if strat.node_id == self.c.node_id:
                return None
            node = self.nodes.get(strat.node_id)
            if node is not None and node.alive:
                return node
            if strat.soft:
                return self._default_place(spec, live)
            self.c._fail_task(rec, ValueError(
                f"NodeAffinity(hard) node {strat.node_id!r} is not alive"))
            return None
        if strat == "SPREAD":
            # round-robin over head + fitting nodes (ref: SPREAD is
            # best-effort dispersal, scheduling_policy.cc); the head only
            # when it could ever run the task (a GPU actor under a head
            # that owns no card would queue there for good)
            head = [None] if self._fits(spec.resources, self.c.total) else []
            slots = head + [n for n in self._live()
                            if self._fits(spec.resources, n.available)]
            if not slots:
                return None
            self._rr += 1
            return slots[self._rr % len(slots)]
        return self._default_place(spec)

    def _live(self) -> List[NodeConn]:
        return [n for n in self.nodes.values() if n.alive]

    def _node_keys(self) -> Set[str]:
        if len(self.nodes) != self._node_res_len:
            self._node_res_len = len(self.nodes)
            for n in self.nodes.values():
                self._node_res_keys.update(n.resources)
        return self._node_res_keys

    def _head_free(self) -> Dict[str, float]:
        """Head resources not yet spoken for: `available` minus the demand
        of locally-queued tasks (claims happen at dispatch, so the raw pool
        would let every task in one burst 'fit locally' and never overflow
        to a node). Reads the ready queue's incrementally-maintained
        aggregate — place() runs once per submit, so an O(queue) rescan
        here turns a burst quadratic and sinks multi-node submit tps.
        Unit-test doubles hand us a plain list of recs; scan those."""
        free = dict(self.c.available)
        pending = getattr(self.c.ready_queue, "pending_demand", None)
        if pending is not None:
            for k, v in pending.items():
                free[k] = free.get(k, 0) - v
            return free
        for rec in self.c.ready_queue:
            if rec.state == "PENDING":
                for k, v in rec.spec.resources.items():
                    free[k] = free.get(k, 0) - v
        return free

    def _locality_bytes(self, spec: TaskSpec):
        """Bytes of the task's ref args resident per candidate, read from
        the head's object table (the GCS location registry). Key None = the
        head itself; extra holders credit every node with a copy."""
        oids = [v for kind, v in
                list(spec.args) + list(spec.kwargs.values()) if kind == "ref"]
        oids += [v for v in spec.nested_refs
                 if not v.startswith(("actor-", "task-"))]
        by: Dict[Optional[str], int] = {}
        for oid in dict.fromkeys(oids):
            meta = self.c.objects.get(oid)
            if meta is None or not meta.size:
                continue
            loc = meta.location
            if loc.startswith("remote:"):
                nid = loc.split(":", 1)[1]
                by[nid] = by.get(nid, 0) + meta.size
                for h in meta.holders:
                    by[h] = by.get(h, 0) + meta.size
            elif loc in ("shm", "spilled", "inline"):
                by[None] = by.get(None, 0) + meta.size
        return by

    def _note_locality(self, hit: bool, nbytes: int):
        """sched_locality_* tallies; read via
        util.metrics.sched_locality_counters()."""
        from ..util import metrics
        metrics.get_or_create(
            metrics.Counter,
            "sched_locality_hits" if hit else "sched_locality_misses").inc()
        if nbytes:
            metrics.get_or_create(metrics.Counter,
                                  "sched_locality_bytes").inc(nbytes)

    def _default_place(self, spec: TaskSpec, live: List[NodeConn] = None):
        """Locality first: among candidates with free resources, place on
        the one already holding the most arg bytes (ref: the Ray paper's
        locality-aware lease policy; scheduling_policy.cc hybrid policy).
        No locality signal — or no holder with room — falls back to the plain
        resource policy: local if it fits now; else the least-loaded node
        where it fits now; else local if EVER feasible locally; else any
        node where it is feasible (queue there).

        Runs once per submitted task, so the hot path (no locality signal,
        head-bound demand) must stay O(1) in node count — the `live` list
        and per-node scans are built only on the branches that need them."""
        res = spec.resources
        head_fits = self._fits(res, self._head_free())
        local = self._locality_bytes(spec)
        if local:
            if live is None:
                live = self._live()
            options = [(None, None)] if head_fits else []
            options += [(n.node_id, n) for n in live
                        if self._fits(res, n.available)]
            if options:
                # max() keeps the FIRST best, so ties prefer the head then
                # registration order — stable with the plain policy
                key, node = max(options, key=lambda kv: local.get(kv[0], 0))
                got = local.get(key, 0)
                if got > 0:
                    self._note_locality(got >= max(local.values()), got)
                    return node
            # arg bytes exist somewhere, but no candidate holding them had
            # room (or no candidate at all): locality miss, resource-FIFO
            self._note_locality(False, 0)
        if head_fits:
            return None
        if any(v > 1e-9 and k not in self._node_keys()
               for k, v in res.items()):
            # demands a resource no node has ever advertised: the fitting
            # and feasible scans below cannot succeed, so the task is
            # head-bound either way — skip the O(nodes) work
            return None
        if live is None:
            live = self._live()
        fitting = [n for n in live if self._fits(res, n.available)]
        if fitting:
            return max(fitting, key=lambda n: n.available.get("CPU", 0.0))
        if self._fits(res, self.c.total):
            return None
        feasible = [n for n in live if self._fits(res, n.resources)]
        return feasible[0] if feasible else None

    @staticmethod
    def _fits(need: Dict[str, float], pool: Dict[str, float]) -> bool:
        return all(pool.get(k, 0) + 1e-9 >= v for k, v in need.items())

    def feasible_somewhere(self, res: Dict[str, float]) -> bool:
        return (self._fits(res, self.c.total)
                or any(self._fits(res, n.resources)
                       for n in self.nodes.values() if n.alive))

    # ------------------------------------------------------------ forwarding
    def _forward(self, rec, node: NodeConn, options=None, wire_spec=None):
        """Common forwarding tail: mirror claim (plain tasks/creations only
        — methods run in their actor's standing allocation and PG tasks in
        their bundle's node-side reserve), bookkeeping, async ship. The
        claim is SYNC so one _schedule pass cannot double-place."""
        spec: TaskSpec = rec.spec
        is_method = spec.actor_id and not spec.is_actor_creation
        if not is_method and not spec.placement_group_id:
            for k, v in spec.resources.items():
                node.available[k] = node.available.get(k, 0) - v
        rec.state = "RUNNING"
        rec.node_id = node.node_id
        rec.ts_start = time.time()
        node.inflight[spec.task_id] = rec
        if spec.is_actor_creation:
            actor = self.c.actors.get(spec.actor_id)
            if actor is not None:
                actor.node_id = node.node_id
                node.actors.add(spec.actor_id)
                if options is None:
                    options = actor.options
        self.c.loop.create_task(self._ship(rec, node, options, wire_spec))

    def forward_task(self, rec, node: NodeConn, options=None):
        """Hand a deps-ready task (or actor creation) to `node`."""
        self._forward(rec, node, options)

    def forward_method(self, rec, node: NodeConn):
        """Actor method call → the node hosting the actor."""
        self._forward(rec, node)

    def forward_pg_task(self, rec, node: NodeConn, bundle):
        """A task bound to a REMOTE bundle: ship it with the spec rewritten
        to the node-local group."""
        import dataclasses as _dc
        wire = _dc.replace(rec.spec,
                           placement_group_id=bundle.remote_pg_id,
                           placement_group_bundle_index=bundle.remote_index)
        self._forward(rec, node, wire_spec=wire)

    async def _ship(self, rec, node: NodeConn, options, wire_spec=None):
        spec: TaskSpec = rec.spec
        try:
            deps = await self._collect_deps(spec, node)
        except Exception as e:  # noqa: BLE001 - dep pull failed
            node.inflight.pop(spec.task_id, None)
            self._release_mirror(node, spec)
            if spec.actor_id and not spec.is_actor_creation:
                actor = self.c.actors.get(spec.actor_id)
                if actor is not None:
                    actor.in_flight.discard(spec.task_id)
            self.c._fail_task(rec, e)
            return
        if not node.alive:
            return  # _on_node_dead already requeued/failed rec
        # seq assigned at SEND time (not forward time — ships complete out
        # of order) so the node's stats echo covers exactly the messages it
        # has seen; see the "stats" handler
        node.ship_seq += 1
        rec.fwd_seq = node.ship_seq
        protocol.awrite_msg(node.writer, "fwd_task",
                            spec=wire_spec if wire_spec is not None else spec,
                            result_oids=rec.result_oids, deps=deps,
                            options=options, seq=node.ship_seq)

    def _holder_addrs(self, meta, exclude: Optional[NodeConn] = None):
        """Live data-server addresses holding `meta`'s bytes — the
        authoritative owner first, then registered extra holders. The
        parallel fetch stripes its streams across all of them."""
        addrs = []
        ids = []
        if meta.location.startswith("remote:"):
            ids.append(meta.location.split(":", 1)[1])
        ids.extend(meta.holders)
        for nid in ids:
            n = self.nodes.get(nid)
            if (n is not None and n.alive and n.data_addr
                    and n is not exclude and n.data_addr not in addrs):
                addrs.append(n.data_addr)
        return addrs

    async def _collect_deps(self, spec: TaskSpec, node: NodeConn):
        """Bytes for every ref the task needs, except those already on the
        target node. Objects on a THIRD node are handed over as a REDIRECT
        to the owner's data server — the consuming node pulls the bytes
        producer→consumer in one hop (ref: object_manager.cc Pull); the
        head stages bytes itself only when the owner has no data server
        (older node build) and counts them in staged_bytes."""
        deps = []
        oids = [v for kind, v in
                list(spec.args) + list(spec.kwargs.values()) if kind == "ref"]
        oids += [v for v in spec.nested_refs
                 if not v.startswith(("actor-", "task-"))]
        for oid in dict.fromkeys(oids):
            meta = self.c.objects.get(oid)
            if meta is None:
                continue  # node resolves via fetch_object at run time
            loc = meta.location
            if loc == f"remote:{node.node_id}":
                continue  # already local to the target
            if loc.startswith("remote:"):
                owner = self.nodes.get(loc.split(":", 1)[1])
                if (owner is not None and owner.alive and owner.data_addr
                        and owner is not node):
                    deps.append({"oid": oid, "enc": "redirect",
                                 "addr": owner.data_addr,
                                 "addrs": self._holder_addrs(meta,
                                                             exclude=node),
                                 "owner": owner.node_id, "size": meta.size,
                                 "meta_len": meta.meta_len,
                                 "contained": list(meta.contained)})
                    continue
                await self.c._pull_remote(oid)  # fallback: stage via head
                meta = self.c.objects.get(oid)
                if meta is None:
                    continue
                if meta.location in ("shm", "spilled"):
                    self.staged_bytes += meta.size
            if meta.location == "inline":
                deps.append({"oid": oid, "enc": "inline",
                             "data": meta.inline_value, "size": meta.size,
                             "contained": list(meta.contained)})
            elif meta.location in ("shm", "spilled"):
                self.c._ensure_local(oid)
                blob = self.c.store.read_raw(oid)
                deps.append({"oid": oid, "enc": "blob", "data": blob,
                             "size": meta.size, "meta_len": meta.meta_len,
                             "contained": list(meta.contained)})
        return deps

    def _release_mirror(self, node: NodeConn, spec: TaskSpec):
        if spec.actor_id and not spec.is_actor_creation:
            return  # methods carry no mirror claim
        if spec.placement_group_id:
            return  # PG tasks draw from their bundle, not the node pool
        for k, v in spec.resources.items():
            node.available[k] = node.available.get(k, 0) + v

    # -------------------------------------------------------------- results
    def _on_task_result(self, node: NodeConn, p: dict):
        c = self.c
        rec = node.inflight.pop(p["task_id"], None)
        if rec is None:
            return
        spec: TaskSpec = rec.spec
        self._release_mirror(node, spec)
        err = p.get("error")
        actor = c.actors.get(spec.actor_id) if spec.actor_id else None
        if actor is not None and not spec.is_actor_creation:
            actor.in_flight.discard(spec.task_id)
        if err is not None:
            retryable = (not spec.actor_id and rec.retries_left > 0
                         and not rec.cancelled
                         and (spec.retry_exceptions
                              or isinstance(err, exc.WorkerCrashedError)))
            if retryable:
                rec.retries_left -= 1
                rec.node_id = None  # re-placed from scratch
                rec.fwd_seq = None
                c._enqueue_ready(rec)
                c._schedule()
                return
            c._fail_task(rec, err)
            if spec.is_actor_creation and actor is not None:
                node.actors.discard(spec.actor_id)
                c._fail_actor(actor, f"creation failed on {node.node_id}: "
                              f"{err}", allow_restart=False)
            c._unpin(rec)
            c._schedule()
            return
        for r in p["results"]:
            c._ingest_result(r, node.node_id)
        if p.get("phases"):
            rec.phases = p["phases"]  # node controller's phase durations
        rec.ts_end = rec.ts_end or time.time()
        rec.state = "DONE"
        rec.done.set()
        c._mark_task_terminal(rec)
        if spec.is_actor_creation and actor is not None:
            from .controller import A_DEAD, A_ALIVE
            if actor.state != A_DEAD:
                actor.state = A_ALIVE
        c._unpin(rec)
        c._schedule()

    # ------------------------------------------------------- object movement
    async def pull_object(self, oid: str, node_id: str) -> bool:
        """Fetch an object's bytes from the node that has it into the head
        store. True on success. Prefers the chunked-parallel data plane
        (streams recv_into the head store directly); the pickle-staged RPC
        remains the fallback (and the sync path when parallelism is off)."""
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return False
        from .node_agent import parallel_fetch, use_parallel_transfer
        meta = self.c.objects.get(oid)
        if (use_parallel_transfer() and node.data_addr and meta is not None
                and meta.size and meta.location == f"remote:{node_id}"):
            payload = await parallel_fetch(
                self._holder_addrs(meta), oid, meta.size, meta.meta_len,
                meta.contained, self.c.store)
            if payload is not None:
                self.c._ingest_bytes(oid, payload)
                self.free_object(oid, node_id)
                return True
        try:
            # the node waits out still-computing objects (locate_object may
            # have found the oid "pending"); give its wait headroom
            p = await asyncio.wait_for(
                self._rpc(node, "pull_object", oid=oid, timeout=90),
                timeout=105)
        except (asyncio.TimeoutError, OSError):
            return False
        if not p.get("found"):
            return False
        self.c._ingest_bytes(oid, p)
        # ownership moved to the head: release the node's creation ref (node
        # -side borrowers hold their own increfs, so this only drops the
        # producing store's copy once nothing there needs it)
        self.free_object(oid, node_id)
        return True

    async def pull_objects(self, oids: List[str], node_id: str) -> set:
        """Batched pull: ONE round trip fetches a whole get()-list's worth
        of (small) objects from `node_id`. Returns the oids actually
        ingested; callers pull stragglers individually."""
        node = self.nodes.get(node_id)
        if node is None or not node.alive or not oids:
            return set()
        try:
            p = await asyncio.wait_for(
                self._rpc(node, "pull_objects", oids=list(oids), timeout=90),
                timeout=105)
        except (asyncio.TimeoutError, OSError):
            return set()
        pulled = set()
        for r in p.get("results", ()):
            if r.get("found"):
                self.c._ingest_bytes(r["oid"], r)
                self.free_object(r["oid"], node_id)
                pulled.add(r["oid"])
        return pulled

    async def search_object(self, oid: str) -> bool:
        """Cluster-wide lookup for an oid the head has never seen (e.g. a
        ref allocated by a node-local sub-task, later serialized into a
        result the driver deserialized). Ref: object directory
        (src/ray/object_manager/object_directory.h)."""
        for node in list(self.nodes.values()):
            if not node.alive:
                continue
            try:
                p = await asyncio.wait_for(
                    self._rpc(node, "locate_object", oid=oid), timeout=30)
            except (asyncio.TimeoutError, OSError):
                continue
            if p.get("status") in ("ready", "pending"):
                self.c._register_remote(oid, node.node_id,
                                        size=p.get("size", 0),
                                        meta_len=p.get("meta_len", 0))
                return True
        return False

    async def _serve_fetch(self, node: NodeConn, p: dict):
        """A node asks the head for an object (uplink miss path). If the
        bytes live on ANOTHER node with a data server, answer with a
        redirect so the puller goes producer→consumer direct; the head
        serves bytes itself only for head-local objects or on explicit
        no_redirect retry (the direct pull failed: owner died/evicted)."""
        oid = p["oid"]
        meta = self.c.objects.get(oid)
        if (meta is not None and meta.location.startswith("remote:")
                and not p.get("no_redirect")):
            owner = self.nodes.get(meta.location.split(":", 1)[1])
            if (owner is not None and owner.alive and owner.data_addr
                    and owner is not node):
                self._node_reply(node, p["req_id"], found=True,
                                 enc="redirect", addr=owner.data_addr,
                                 addrs=self._holder_addrs(meta, exclude=node),
                                 owner=owner.node_id, size=meta.size,
                                 meta_len=meta.meta_len,
                                 contained=list(meta.contained))
                return
        try:
            descs = await self.c.get_descriptors([oid], p.get("timeout", 120))
            kind, payload = descs[0]
            if kind == "err":
                self._node_reply(node, p["req_id"], found=False, error=payload)
            elif kind == "inline":
                meta = self.c.objects[oid]
                self._node_reply(node, p["req_id"], found=True, enc="inline",
                                 data=payload, size=meta.size,
                                 contained=list(meta.contained))
            else:  # shm at head (a remote location was pulled in by
                   # get_descriptors before the descriptor was returned)
                was_remote = (meta is not None
                              and meta.location.startswith("remote:"))
                meta = self.c.objects[oid]
                blob = self.c.store.read_raw(oid)
                if was_remote:
                    self.staged_bytes += meta.size
                self._node_reply(node, p["req_id"], found=True, enc="blob",
                                 data=blob, size=meta.size,
                                 meta_len=meta.meta_len,
                                 contained=list(meta.contained))
        except Exception as e:  # noqa: BLE001 - ship the failure
            self._node_reply(node, p["req_id"], found=False, error=e)

    async def _serve_up_submit(self, node: NodeConn, p: dict):
        """A node worker submitted work its node can't place; the head
        registers shipped deps and places it cluster-wide (spillback)."""
        try:
            for d in p.get("deps") or []:
                self.c._ingest_bytes(d["oid"], d)
            oids = await self.c.submit(p["spec"],
                                       result_oids=p.get("result_oids"))
            self._node_reply(node, p["req_id"], refs=oids)
        except Exception as e:  # noqa: BLE001
            self._node_reply(node, p["req_id"], error=e)

    async def create_remote_pg(self, node_id: str, bundles) -> str:
        """Reserve bundles on a node via a node-local placement group;
        returns the node's pg id. Debits the optimistic mirror (trued by
        the next heartbeat). The request carries a head-chosen correlation
        ref: on timeout the head best-effort cancels BY REF, so a late
        node-side creation cannot leak its reservation."""
        from . import ids as _ids
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            raise ValueError(f"node {node_id} is not alive")
        ref = _ids.new_id("pgref")
        try:
            p = await asyncio.wait_for(
                self._rpc(node, "create_pg", bundles=bundles, ref=ref),
                timeout=60)
        except asyncio.TimeoutError:
            if node.alive:
                protocol.awrite_msg(node.writer, "remove_pg_ref", ref=ref)
            raise ValueError(f"node {node_id} did not reserve the bundle "
                             f"in time") from None
        if "error" in p:
            raise p["error"]
        for b in bundles:
            for k, v in b.items():
                node.available[k] = node.available.get(k, 0) - v
        return p["pg_id"]

    def restore_mirror_bundle(self, node_id: str, resources):
        node = self.nodes.get(node_id)
        if node is not None:
            for k, v in resources.items():
                node.available[k] = node.available.get(k, 0) + v

    def remove_remote_pg(self, node_id: str, remote_pg_id: str):
        node = self.nodes.get(node_id)
        if node is not None and node.alive:
            protocol.awrite_msg(node.writer, "remove_pg",
                                pg_id=remote_pg_id)

    def free_object(self, oid: str, node_id: str):
        node = self.nodes.get(node_id)
        if node is not None and node.alive:
            protocol.awrite_msg(node.writer, "free_object", oid=oid)

    def cancel(self, task_id: str, node_id: str, force: bool):
        node = self.nodes.get(node_id)
        if node is not None and node.alive:
            protocol.awrite_msg(node.writer, "cancel", task_id=task_id,
                                force=force)

    def kill_actor(self, actor_id: str, node_id: str, no_restart: bool):
        node = self.nodes.get(node_id)
        if node is not None and node.alive:
            node.actors.discard(actor_id)
            protocol.awrite_msg(node.writer, "kill_actor", actor_id=actor_id,
                                no_restart=no_restart)

    # ------------------------------------------------------------ node death
    def _on_node_dead(self, node: NodeConn):
        c = self.c
        print(f"[cluster] node {node.node_id} ({node.host}) disconnected; "
              f"failing over {len(node.inflight)} tasks, "
              f"{len(node.actors)} actors", file=sys.stderr)
        try:
            c.health.note_node_dead(node.node_id, node.host, pid=node.pid)
        except Exception:  # noqa: BLE001
            pass
        for tid, rec in list(node.inflight.items()):
            spec = rec.spec
            self._release_mirror(node, spec)
            if spec.actor_id and not spec.is_actor_creation:
                # clear the method from its actor's in-flight set or a
                # restarted actor would never dispatch again (concurrency
                # gate counts stale entries)
                actor = c.actors.get(spec.actor_id)
                if actor is not None:
                    actor.in_flight.discard(tid)
            if (not spec.actor_id and rec.retries_left > 0
                    and not rec.cancelled):
                rec.retries_left -= 1
                rec.node_id = None  # re-placed from scratch
                rec.fwd_seq = None
                c._enqueue_ready(rec)
            else:
                c._fail_task(rec, exc.WorkerCrashedError(
                    f"node {node.node_id} died while running {tid}"))
        node.inflight.clear()
        for aid in list(node.actors):
            actor = c.actors.get(aid)
            if actor is not None:
                actor.node_id = None
                # re-place through the scheduler (may land anywhere) rather
                # than _fail_actor's local respawn, which assumes a head
                # worker and head-held resources
                if not c._requeue_actor_creation(actor):
                    c._fail_actor(actor, f"node {node.node_id} died",
                                  allow_restart=False)
        node.actors.clear()
        # drop the dead node from holder lists (fetches would just MISS and
        # redistribute, but no point handing out known-dead sources) — one
        # sharded sweep inside the directory instead of a pass over every
        # ObjectMeta building a holder list per object
        c.objdir.drop_node(node.node_id)
        # EAGER location purge (not lazily at the next fetch): a replacement
        # node re-registering on a recycled host:port must never find the
        # dead id still authoritative for an object, and every object whose
        # only copy died is either promoted to a surviving holder or handed
        # to lineage recovery right now
        dead_loc = f"remote:{node.node_id}"
        lost = []
        for oid, meta in list(c.objects.items()):
            if meta.location != dead_loc:
                continue
            survivors = []
            for h in meta.holders:
                n = self.nodes.get(h)
                if h != node.node_id and n is not None and n.alive:
                    survivors.append(h)
            if survivors:
                # an extra holder becomes the authoritative copy; pulls and
                # _collect_deps redirects keep working without a reconstruct
                meta.location = f"remote:{survivors[0]}"
                meta.holders = survivors[1:]
            else:
                lost.append(oid)
        if lost:
            from .controller import reconstruct_enabled
            if reconstruct_enabled():
                c.loop.create_task(c._recover_lost_objects(
                    lost, node.node_id, node.last_seen, time.time()))
            # else: losses surface lazily (meta stays remote:<dead>, the
            # pull fails, _descriptor → _recover_object at the next get())
        c._schedule()

    # --------------------------------------------------------------- surface
    def node_rows(self) -> List[dict]:
        now = time.time()
        return [{"node_id": n.node_id, "alive": n.alive, "host": n.host,
                 "resources": dict(n.resources),
                 "available": dict(n.available),
                 "inflight": len(n.inflight), "actors": len(n.actors),
                 "data_addr": n.data_addr,
                 "direct_pull_bytes": n.direct_pull_bytes,
                 "direct_serve_bytes": n.direct_serve_bytes,
                 "heartbeat_age_s": max(now - n.last_seen, 0.0),
                 "hb_interval_s": n.hb_interval_s,
                 "hb_latency_s": n.hb_latency_s,
                 "health": dict(n.health)}
                for n in self.nodes.values()]

    def totals(self) -> Dict[str, float]:
        out = dict(self.c.total)
        for n in self.nodes.values():
            if n.alive:
                for k, v in n.resources.items():
                    out[k] = out.get(k, 0) + v
        return out

    def availables(self) -> Dict[str, float]:
        out = dict(self.c.available)
        for n in self.nodes.values():
            if n.alive:
                for k, v in n.available.items():
                    out[k] = out.get(k, 0) + v
        return out
