"""Worker-node agent: a full local controller plus one TCP uplink to the head.

Run with:  python -m ray_tpu_torch._private.node_main --address HEAD_HOST:PORT

Reference parity: a raylet joining a cluster (src/ray/raylet/main.cc →
NodeManager registration with the GCS). The re-design keeps every
single-host mechanism intact by running a complete Controller locally (own
shm arena, own worker pool, own scheduler, runtime envs, streams, restarts)
and adding exactly two cross-host behaviors:

- DOWNLINK: the head forwards deps-ready tasks/actor-creations here
  ("fwd_task" with dep bytes); the agent registers the deps into the local
  store and pushes the spec through the normal local submit path, then
  reports per-oid results upward — inline values by value, large values by
  location (bytes stay in this node's store until the head pulls them).
- UPLINK: local misses spill up. A worker get() of an object this node has
  never seen asks the head ("fetch_object"); a worker submit the node
  cannot or should not place (infeasible here, SPREAD/NodeAffinity, method
  on an actor living elsewhere) is re-submitted at the head ("up_submit") —
  the analog of raylet spillback scheduling.
- DATA PLANE: every node runs an ObjectDataServer — a token-gated TCP
  server that streams object blobs straight out of the local store. The
  head brokers LOCATION only: deps owned by a sibling node arrive as
  redirects and fetch_object misses on sibling-owned objects answer with a
  redirect, so bytes flow producer→consumer in ONE hop instead of staging
  through the head (ref: object_manager.cc Push/Pull between plasma
  stores; a head funnel would be an O(N) bandwidth funnel). The data wire is deliberately NOT pickle: a 2-line text header
  + raw bytes, so the data path never unpickles anything.
"""

import argparse
import asyncio
import os
import socket as _socket
import sys
import time
import zlib
from typing import Dict, Optional

from .. import exceptions as exc
from .._native import codec as _codec
from ..util import tracing
from . import chaos, ids, paths, protocol
from .cluster import HEARTBEAT_S, cluster_token
from .controller import (Controller, DEFAULT_CAPACITY, format_timeline,
                         prefetch_max_bytes)
from .task_spec import ObjectMeta, TaskSpec


class NodeController(Controller):
    """Local controller with uplink spillback for work and objects."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.agent: Optional["NodeAgent"] = None
        self._head_actors = set()   # actor_ids created on behalf of the head
        self._uplink_pulls = set()  # oids with an uplink fetch in flight

    def _fail_actor(self, actor, reason, allow_restart):
        was_dead = actor.state == "DEAD"
        super()._fail_actor(actor, reason, allow_restart)
        if (not was_dead and actor.state == "DEAD"
                and actor.actor_id in self._head_actors
                and self.agent is not None and self.agent.writer is not None):
            # permanent death of a head-placed actor: report up so the head
            # fails its record (restarts below max_restarts stay node-local)
            self._head_actors.discard(actor.actor_id)
            try:
                protocol.awrite_msg(self.agent.writer, "actor_dead",
                                    actor_id=actor.actor_id, reason=reason)
            except OSError:
                pass

    # -- object miss → ask the head ---------------------------------------
    async def _recover_object(self, oid: str) -> bool:
        """Local lineage first; else register a pending entry and pull from
        the head in the background, so the caller's own get() timeout (not
        the fetch RPC's) governs how long it waits."""
        if await super()._recover_object(oid):
            return True
        if self.agent is None:
            return False
        meta = self.objects.get(oid)
        if meta is None:
            meta = ObjectMeta(object_id=oid)
            self.objects[oid] = meta
            self.object_events[oid] = asyncio.Event()
        elif meta.location in ("shm", "spilled"):
            meta.location = "pending"  # local copy lost: refetch
            self.object_events[oid].clear()
        if oid not in self._uplink_pulls:
            self._uplink_pulls.add(oid)
            self.loop.create_task(self._pull_uplink(oid))
        return True

    async def _pull_uplink(self, oid: str):
        try:
            ok = await self.agent.fetch_object(oid)
        except Exception:  # noqa: BLE001 - uplink hiccup = not found
            ok = False
        finally:
            self._uplink_pulls.discard(oid)
        if not ok:
            meta = self.objects.get(oid)
            if meta is not None and meta.location == "pending":
                meta.error = exc.ObjectLostError(oid)
                meta.location = "error"
                ev = self.object_events.get(oid)
                if ev is not None:
                    ev.set()
                # wake queued tasks waiting on this dep; they dispatch and
                # fail at argument materialization (same contract as
                # _fail_task's error objects)
                self._resolve_dep(oid)

    # -- work this node shouldn't place → head ----------------------------
    def _spills_up(self, spec: TaskSpec) -> bool:
        if self.agent is None or spec.placement_group_id:
            return False
        if spec.actor_id and not spec.is_actor_creation:
            # method on an actor this node doesn't host
            return spec.actor_id not in self.actors
        from ..util.scheduling_strategies import NodeAffinitySchedulingStrategy
        strat = spec.scheduling_strategy
        if isinstance(strat, NodeAffinitySchedulingStrategy):
            return strat.node_id != self.node_id
        if strat == "SPREAD":
            return True
        return any(v > self.total.get(k, 0) + 1e-9
                   for k, v in spec.resources.items())

    async def submit(self, spec: TaskSpec, result_oids=None):
        if self._spills_up(spec):
            # pipelined clients already derived the result ids: the head must
            # name the same objects (mirrors forward_task's preallocation)
            return await self.agent.up_submit(spec, result_oids)
        oids = await super().submit(spec, result_oids=result_oids)
        rec = self.tasks.get(spec.task_id)
        if rec is not None and self.agent is not None:
            # deps this node has never seen (head- or sibling-produced
            # objects used as args): start uplink pulls so the queued task
            # can eventually dispatch
            for oid in list(rec.deps_remaining):
                if oid not in self.objects:
                    await self._recover_object(oid)
        return oids

    def cancel(self, task_id: str, force: bool = False):
        if self.agent is not None:
            tid = task_id
            if tid.startswith("obj-"):
                meta = self.objects.get(tid)
                tid = (meta.creating_task if meta and meta.creating_task
                       else tid)
            if tid not in self.tasks:
                self.loop.create_task(
                    self._up_fire("up_cancel", task_id=task_id, force=force))
                return
        super().cancel(task_id, force)

    def kill_actor(self, actor_id: str, no_restart: bool = True,
                   reason: str = "killed via kill()"):
        if self.agent is not None and actor_id not in self.actors:
            self.loop.create_task(self._up_fire(
                "up_kill_actor", actor_id=actor_id, no_restart=no_restart))
            return
        super().kill_actor(actor_id, no_restart, reason)

    async def _up_fire(self, kind: str, **payload):
        try:
            await self.agent._rpc(kind, **payload)
        except Exception:  # noqa: BLE001 - best-effort control message
            pass

    async def _handle_worker_msg(self, w, kind, p):
        if kind == "get_actor" and self.agent is not None:
            # named lookup misses resolve at the head (names are head-owned)
            try:
                aid = self.lookup_actor(p["name"], p.get("namespace"))
                w.actor_refs[aid] = w.actor_refs.get(aid, 0) + 1
                self._reply(w, p["req_id"], actor_id=aid)
            except ValueError:
                self.loop.create_task(self._uplink_get_actor(w, p))
            return
        await super()._handle_worker_msg(w, kind, p)

    async def _uplink_get_actor(self, w, p):
        try:
            resp = await self.agent._rpc("up_lookup_actor", name=p["name"],
                                         namespace=p.get("namespace"))
            if "error" in resp:
                raise resp["error"]
            self._reply(w, p["req_id"], actor_id=resp["actor_id"])
        except Exception as e:  # noqa: BLE001
            self._reply(w, p["req_id"], error=e)


_DATA_CHUNK = 1 << 20     # 1 MiB frames on the data plane
_PARALLEL_MIN = 4 << 20   # objects below this ride one stream (setup wins)
_RANGE_MIN = 1 << 20      # never split a transfer finer than this per stream


def transfer_streams() -> int:
    """Stream fan-out for parallel object fetches
    (RAY_TPU_TRANSFER_STREAMS, default 4)."""
    try:
        return max(1, int(os.environ.get("RAY_TPU_TRANSFER_STREAMS", "4")))
    except ValueError:
        return 4


def transfer_deadline_s() -> float:
    """Hard wall-clock budget for one object transfer, retries included
    (RAY_TPU_TRANSFER_DEADLINE_S, default 30). Past it the pull aborts and
    fails over — to another holder set, the head-staged path, or lineage
    reconstruction — rather than retrying forever against a dead peer."""
    try:
        return max(1.0,
                   float(os.environ.get("RAY_TPU_TRANSFER_DEADLINE_S", "30")))
    except ValueError:
        return 30.0


def retry_backoff_s(attempt: int, key: str = "",
                    base: float = 0.05, cap: float = 2.0) -> float:
    """Bounded exponential backoff with DETERMINISTIC jitter: the jitter
    factor (0.5..1.0) hashes (key, attempt) instead of sampling a PRNG, so
    a chaos replay reproduces the exact same retry schedule (ref: Ray's
    ExponentialBackOff in src/ray/util; AWS full-jitter, made replayable)."""
    delay = min(cap, base * (2 ** max(0, attempt)))
    j = zlib.crc32(f"{key}:{attempt}".encode()) % 1000 / 1000.0
    return delay * (0.5 + 0.5 * j)


def use_parallel_transfer() -> bool:
    """False pins the single-stream sync path (RAY_TPU_TRANSFER_SYNC=1,
    or RAY_TPU_TRANSFER_STREAMS=1) — the escape hatch when a peer can't
    speak ranged reads or the fan-out misbehaves."""
    if os.environ.get("RAY_TPU_TRANSFER_SYNC", "0") == "1":
        return False
    return transfer_streams() > 1


def _record_transfer(nbytes: int, nstreams: int, seconds: float,
                     retries: int = 0):
    """Per-transfer data-plane tallies; read via
    util.metrics.transfer_counters()."""
    from ..util import metrics
    metrics.get_or_create(metrics.Counter, "transfer_fetches").inc()
    metrics.get_or_create(metrics.Counter, "transfer_fetch_bytes").inc(nbytes)
    metrics.get_or_create(metrics.Counter,
                          "transfer_fetch_streams").inc(nstreams)
    if retries:
        metrics.get_or_create(metrics.Counter,
                              "transfer_stream_retries").inc(retries)
        metrics.get_or_create(metrics.Counter,
                              "transfer_retries_total").inc(retries)
    metrics.get_or_create(metrics.Histogram, "transfer_fetch_seconds",
                          boundaries=[0.001, 0.01, 0.1, 1, 10, 100]
                          ).observe(seconds)


class PullManager:
    """Eager dependency pulls: single-flight per object id with an in-flight
    byte cap (ref: ray src/ray/object_manager/pull_manager.cc admission +
    dedup). `request(oid, size, fetch)` launches `fetch` — a zero-arg
    callable returning an awaitable that is truthy on success — as a loop
    task and returns it; a second request for an in-flight oid returns the
    SAME task (requesters join one transfer). Requests that would push
    in-flight bytes over the cap park FIFO and launch as completions free
    room (request returns None for those — admission is backpressure, not
    rejection). pin/unpin hooks bracket every pull so the landing object
    can't be spilled or evicted mid-transfer, and `durations_ms` holds each
    completed pull's wall time until a dispatcher claims it for overlap
    accounting."""

    def __init__(self, loop, max_bytes: int = 256 << 20,
                 pin=None, unpin=None):
        self.loop = loop
        self.max_bytes = max(1, int(max_bytes))
        self.inflight_bytes = 0
        self.durations_ms: Dict[str, float] = {}
        # completed-pull wall windows (epoch t0, t1) per oid, claimed at
        # dispatch into the task's prefetch phase span (util.tracing)
        self.windows: Dict[str, tuple] = {}
        self._inflight: Dict[str, asyncio.Task] = {}
        self._waiting = []          # FIFO of (oid, size, fetch) over the cap
        self._queued: set = set()   # oids parked in _waiting
        self._pin = pin
        self._unpin = unpin

    def request(self, oid: str, size: int, fetch) -> Optional[asyncio.Task]:
        from ..util import metrics
        size = int(size or 0)
        t = self._inflight.get(oid)
        if t is not None:
            metrics.get_or_create(metrics.Counter,
                                  "prefetch_pull_dedup").inc()
            return t
        if oid in self._queued:
            metrics.get_or_create(metrics.Counter,
                                  "prefetch_pull_dedup").inc()
            return None
        if self.inflight_bytes and self.inflight_bytes + size > self.max_bytes:
            self._queued.add(oid)
            self._waiting.append((oid, size, fetch))
            return None
        return self._launch(oid, size, fetch)

    def _launch(self, oid: str, size: int, fetch) -> asyncio.Task:
        from ..util import metrics
        metrics.get_or_create(metrics.Counter, "prefetch_pulls").inc()
        if size:
            metrics.get_or_create(metrics.Counter,
                                  "prefetch_pull_bytes").inc(size)
        self.inflight_bytes += size
        if self._pin is not None:
            self._pin(oid)
        t0 = time.monotonic()
        # trace span: open the wall window NOW — a gated task can dispatch
        # in the very loop turn the pull's ingest resolves its deps, before
        # this coroutine's finally runs, and the claimer (the controller's
        # _arg_descriptors) closes an open window itself
        self.windows[oid] = (time.time(), None)
        while len(self.windows) > 4096:  # unclaimed windows: bound memory
            self.windows.pop(next(iter(self.windows)))

        async def run():
            ok = False
            try:
                ok = bool(await fetch())
            except Exception:  # noqa: BLE001 - a failed eager pull is a
                ok = False     # dispatch miss, never a task error
            finally:
                self.inflight_bytes -= size
                self._inflight.pop(oid, None)
                if self._unpin is not None:
                    self._unpin(oid)
                if ok:
                    self.durations_ms[oid] = (time.monotonic() - t0) * 1e3
                    while len(self.durations_ms) > 4096:  # unclaimed: bound
                        self.durations_ms.pop(next(iter(self.durations_ms)))
                    win = self.windows.get(oid)
                    if win is not None and win[1] is None:  # not yet claimed
                        self.windows[oid] = (win[0], time.time())
                else:
                    metrics.get_or_create(metrics.Counter,
                                          "prefetch_pull_failures").inc()
                    self.windows.pop(oid, None)  # no bytes: no trace span
                self._drain()
            return ok

        t = self.loop.create_task(run())
        self._inflight[oid] = t
        return t

    def protected(self) -> set:
        """Oids this manager is landing (in-flight) or has committed to land
        (parked over the byte cap). The spiller must never touch these: an
        in-flight pull's segment is pinned, but a spill racing the park→launch
        gap — or evicting the segment a just-completed pull's dispatch gate
        is about to attach — would turn one transfer into two."""
        return set(self._inflight) | set(self._queued)

    def _drain(self):
        while self._waiting:
            oid, size, fetch = self._waiting[0]
            if (self.inflight_bytes
                    and self.inflight_bytes + size > self.max_bytes):
                return
            self._waiting.pop(0)
            self._queued.discard(oid)
            if oid not in self._inflight:
                self._launch(oid, size, fetch)


class ObjectDataServer:
    """Per-node object data plane: streams blobs out of the local store to
    sibling nodes (and anyone else holding the cluster token).

    Wire (NOT pickle — the data path must never unpickle):
      client → `RTPT1 <token>\\n` then `GET <oid>\\n` (repeatable)
      server → `OK <size> <meta_len>\\n<contained oids space-joined>\\n<bytes>`
               | `MISS\\n`
    Ranged form (drives the parallel fetch — N streams each pull one
    disjoint slice):
      client → `GET <oid> <offset> <length>\\n`
      server → `OK <length>\\n<bytes>` | `MISS\\n`
    Ref: object_manager.cc Push/Pull chunked transfers between plasma
    stores; ObjectManagerService rpc definitions in object_manager.proto."""

    def __init__(self, controller):
        self.c = controller
        self.addr = ""
        self.serve_bytes = 0
        self._server = None

    async def start(self, host: str):
        self._server = await asyncio.start_server(self._on_client, host, 0)
        port = self._server.sockets[0].getsockname()[1]
        adv = _socket.gethostname() if host not in (
            "127.0.0.1", "localhost", "::1") else "127.0.0.1"
        self.addr = f"{adv}:{port}"

    def close(self):
        if self._server is not None:
            self._server.close()

    async def _on_client(self, reader, writer):
        import hmac
        try:
            hello = await asyncio.wait_for(reader.readline(), timeout=10)
            expect = f"RTPT1 {cluster_token()}\n".encode()
            if not hmac.compare_digest(hello, expect):
                writer.close()
                return
            while True:
                line = await reader.readline()
                if not line:
                    break
                parts = line.decode("ascii", "replace").split()
                if parts[:1] != ["GET"] or len(parts) not in (2, 4):
                    break
                if len(parts) == 2:
                    await self._serve_one(writer, parts[1])
                else:
                    await self._serve_range(writer, parts[1],
                                            int(parts[2]), int(parts[3]))
        except (OSError, asyncio.TimeoutError, UnicodeDecodeError, ValueError):
            pass
        finally:
            try:
                writer.close()
            except OSError:
                pass

    async def _await_ready(self, oid: str):
        """Resolve `oid`'s meta, waiting out a still-computing local task —
        the head may redirect a consumer here before the producer finishes
        (same contract as _on_pull_object)."""
        c = self.c
        meta = c.objects.get(oid)
        if meta is not None and meta.location == "pending":
            ev = c.object_events.get(oid)
            if ev is not None:
                try:
                    await asyncio.wait_for(ev.wait(), timeout=120)
                except asyncio.TimeoutError:
                    pass
            meta = c.objects.get(oid)
        if (meta is None or meta.location not in ("shm", "spilled")
                or not meta.size):
            return None
        return meta

    async def _serve_one(self, writer, oid: str):
        c = self.c
        meta = await self._await_ready(oid)
        if meta is None:
            writer.write(b"MISS\n")
            await writer.drain()
            return
        try:
            if meta.location == "spilled" and meta.spill_path:
                # ship from the spill tier without promoting: the reader
                # wants the bytes, not a hot shm copy on this node
                blob = await asyncio.get_running_loop().run_in_executor(
                    None, c.store.read_spilled, meta.spill_path)
            else:
                c._ensure_local(oid)
                blob = c.store.read_raw(oid)
        except Exception:  # noqa: BLE001 - segment vanished under us
            writer.write(b"MISS\n")
            await writer.drain()
            return
        sever_at = -1
        if chaos.enabled() and chaos.get_injector().should("sever_stream"):
            sever_at = len(blob) // 2
        head = (f"OK {len(blob)} {meta.meta_len}\n"
                f"{' '.join(meta.contained)}\n").encode("ascii")
        writer.write(head)
        for i in range(0, len(blob), _DATA_CHUNK):
            if 0 <= sever_at <= i:
                writer.close()
                return
            writer.write(blob[i:i + _DATA_CHUNK])
            await writer.drain()  # backpressure per chunk
        self.serve_bytes += len(blob)

    async def _serve_range(self, writer, oid: str, offset: int, length: int):
        """One slice of a parallel fetch: raw bytes, no meta lines (the
        puller learned size/meta_len/contained from its redirect)."""
        meta = await self._await_ready(oid)
        if (meta is None or offset < 0 or length <= 0
                or offset + length > meta.size):
            writer.write(b"MISS\n")
            await writer.drain()
            return
        try:
            if meta.location == "spilled" and meta.spill_path:
                # serve straight from the spill file: a ranged pull of a
                # cold object must not promote it back to shm (and evict
                # something hot) just to ship a slice
                blob = await asyncio.get_running_loop().run_in_executor(
                    None, self.c.store.read_spilled_range,
                    meta.spill_path, offset, length)
                from ..util import metrics
                metrics.get_or_create(
                    metrics.Counter, "spill_range_reads_total",
                    "ranged reads served directly from the spill tier").inc()
            else:
                self.c._ensure_local(oid)
                blob = self.c.store.read_range(oid, offset, length)
        except Exception:  # noqa: BLE001 - segment vanished under us
            writer.write(b"MISS\n")
            await writer.drain()
            return
        sever_at = -1
        if chaos.enabled() and chaos.get_injector().should("sever_stream"):
            sever_at = len(blob) // 2  # partial write, then hang up: the
            # puller sees a short range and redistributes/backs off
        writer.write(f"OK {len(blob)}\n".encode("ascii"))
        for i in range(0, len(blob), _DATA_CHUNK):
            if 0 <= sever_at <= i:
                writer.close()
                return
            writer.write(blob[i:i + _DATA_CHUNK])
            await writer.drain()  # backpressure per chunk
        self.serve_bytes += len(blob)


async def direct_fetch(addr: str, oid: str, timeout: float = 120):
    """Pull one blob from a sibling's ObjectDataServer over a single stream.
    Returns an _ingest_bytes payload dict, or None (owner gone / evicted /
    refused). The parallel path (parallel_fetch) supersedes this for large
    objects; this remains the sync fallback and the small-object fast path
    when no size is known up front."""
    t0 = time.monotonic()
    host, port = addr.rsplit(":", 1)
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), timeout=10)
    except (OSError, asyncio.TimeoutError, ValueError):
        return None
    try:
        writer.write(f"RTPT1 {cluster_token()}\nGET {oid}\n".encode())
        await writer.drain()
        status = await asyncio.wait_for(reader.readline(), timeout=timeout)
        if not status.startswith(b"OK "):
            return None
        _, size_s, meta_len_s = status.decode("ascii").split()
        contained_line = await asyncio.wait_for(reader.readline(),
                                                timeout=timeout)
        contained = contained_line.decode("ascii").split()
        size = int(size_s)
        buf = bytearray()
        while len(buf) < size:
            chunk = await asyncio.wait_for(
                reader.read(min(_DATA_CHUNK, size - len(buf))),
                timeout=timeout)
            if not chunk:
                return None  # owner hung up mid-stream
            buf.extend(chunk)
        _record_transfer(size, 1, time.monotonic() - t0)
        return {"oid": oid, "enc": "blob", "data": bytes(buf), "size": size,
                "meta_len": int(meta_len_s), "contained": contained}
    except (OSError, asyncio.TimeoutError, UnicodeDecodeError, ValueError):
        return None
    finally:
        try:
            writer.close()
        except OSError:
            pass


async def _range_stream(addr: str, oid: str, view, offset: int, length: int,
                        timeout: float) -> int:
    """One parallel-fetch stream: land blob[offset:offset+length] straight
    into `view` via recv_into (zero-copy: kernel → shm, no reassembly).
    Returns bytes landed — short on any failure; the caller redistributes
    the tail."""
    loop = asyncio.get_running_loop()
    host, port = addr.rsplit(":", 1)
    got = 0
    sock = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    sock.setblocking(False)
    try:
        await asyncio.wait_for(loop.sock_connect(sock, (host, int(port))),
                               timeout=10)
        req = f"RTPT1 {cluster_token()}\nGET {oid} {offset} {length}\n"
        await asyncio.wait_for(loop.sock_sendall(sock, req.encode()), timeout)
        hdr = bytearray()
        while not hdr.endswith(b"\n"):
            b = await asyncio.wait_for(loop.sock_recv(sock, 1), timeout)
            if not b or len(hdr) > 64:
                return got
            hdr += b
        if not hdr.startswith(b"OK "):
            return got
        while got < length:
            sub = view[offset + got:offset + length]
            try:
                n = await asyncio.wait_for(loop.sock_recv_into(sock, sub),
                                           timeout)
            finally:
                sub.release()  # the store seals only once all views die
            if n == 0:
                return got  # owner hung up mid-range
            got += n
        return got
    except (OSError, asyncio.TimeoutError, ValueError):
        return got
    finally:
        sock.close()


async def parallel_fetch(addrs, oid: str, size: int, meta_len: int,
                         contained, store, timeout: float = 120):
    """Chunked parallel fetch of one blob into a preallocated store segment:
    N concurrent streams (RAY_TPU_TRANSFER_STREAMS) each recv_into a
    disjoint slice, split round-robin across every known holder. A stream
    that dies mid-transfer has its tail redistributed to the surviving
    holders; total failure aborts the segment and returns None (caller
    falls back to the head-staged uplink). Success returns an
    _ingest_bytes payload with enc="direct" — the bytes are already in
    the store."""
    addrs = [a for a in addrs if a]
    if not addrs or not size or store is None:
        return None
    nstreams = int(min(transfer_streams(), max(1, size // _RANGE_MIN)))
    if size < _PARALLEL_MIN:
        nstreams = 1
    t0 = time.monotonic()
    try:
        handle = store.create_writable(oid, size)
    except Exception:  # noqa: BLE001 - no room / stale segment pinned
        return None
    view = handle.view
    base = size // nstreams
    ranges = []
    for i in range(nstreams):
        off = i * base
        ln = size - off if i == nstreams - 1 else base
        ranges.append((addrs[i % len(addrs)], off, ln))
    streams_opened = 0
    retries = 0
    ok = False
    deadline = t0 + min(timeout, transfer_deadline_s())
    try:
        _round = 0
        while True:
            streams_opened += len(ranges)
            if _round:
                retries += len(ranges)
            results = await asyncio.gather(
                *[_range_stream(a, oid, view, off, ln, timeout)
                  for a, off, ln in ranges])
            leftover = [(a, off + got, ln - got)
                        for (a, off, ln), got in zip(ranges, results)
                        if got < ln]
            if not leftover:
                ok = True
                break
            # bounded exponential backoff under a hard deadline (replaces
            # the old fixed 3-round cap): a flapping peer gets breathing
            # room, a dead one stops eating streams once the budget is spent
            _round += 1
            pause = retry_backoff_s(_round, key=oid)
            if time.monotonic() + pause >= deadline:
                from ..util import metrics
                metrics.get_or_create(
                    metrics.Counter, "transfer_deadline_exceeded_total").inc()
                break
            await asyncio.sleep(pause)
            # redistribute dead streams' tails to the OTHER holders; with a
            # single holder, retry it (covers transient mid-transfer resets)
            ranges = []
            for i, (a, off, ln) in enumerate(leftover):
                others = [x for x in addrs if x != a] or [a]
                ranges.append((others[i % len(others)], off, ln))
    finally:
        view = None
        if ok:
            handle.seal()
        else:
            handle.abort()
    if not ok:
        if retries:
            from ..util import metrics
            metrics.get_or_create(metrics.Counter,
                                  "transfer_retries_total").inc(retries)
        return None
    _record_transfer(size, streams_opened, time.monotonic() - t0,
                     retries=retries)
    return {"oid": oid, "enc": "direct", "size": size, "meta_len": meta_len,
            "contained": list(contained or [])}


class NodeAgent:
    def __init__(self, controller: NodeController, head_addr: str):
        self.c = controller
        controller.agent = self
        self.head_host, port = head_addr.rsplit(":", 1)
        self.head_port = int(port)
        self.reader = None
        self.writer = None
        self._reqs: Dict[int, asyncio.Future] = {}
        self._req_counter = 0
        self._watchers = 0
        self._head_pg_refs: Dict[str, str] = {}  # head ref -> local pg id
        self.data_server = ObjectDataServer(controller)
        self.last_fwd_seq = 0       # highest fwd_task seq processed (stats)
        self.direct_pull_bytes = 0  # data-plane counters (stats → head)
        # traced phase spans from the node controller collect in its
        # span_outbox; the heartbeat drains them to the head (fire-and-
        # forget, ordering not required — Chrome events carry their own ts)
        controller.span_ship = True
        self._pull_manager: Optional[PullManager] = None  # built on first use
                                                          # (needs the loop)

    @property
    def pull_manager(self) -> PullManager:
        if self._pull_manager is None:
            self._pull_manager = PullManager(
                self.c.loop, max_bytes=prefetch_max_bytes(),
                pin=self._pin_obj, unpin=self._unpin_obj)
        return self._pull_manager

    def _pin_obj(self, oid: str):
        meta = self.c.objects.get(oid)
        if meta is not None:
            meta.pinned += 1
            if meta.ts_pinned == 0.0:
                meta.ts_pinned = time.time()

    def _unpin_obj(self, oid: str):
        meta = self.c.objects.get(oid)
        if meta is not None and meta.pinned > 0:
            meta.pinned -= 1
            if meta.pinned == 0:
                meta.ts_pinned = 0.0

    # ------------------------------------------------------------ lifecycle
    async def run(self):
        # data server first so registration can advertise its address; bind
        # loopback when the head is loopback (test topology), else all
        # interfaces — same trust model as the head port, same token gate
        data_host = ("127.0.0.1" if self.head_host in
                     ("127.0.0.1", "localhost", "::1") else "0.0.0.0")
        await self.data_server.start(data_host)
        self.reader, self.writer = await asyncio.open_connection(
            self.head_host, self.head_port)
        # plaintext auth line first; pickle framing only after (see
        # ClusterServer._on_node)
        self.writer.write(f"RTPT1 {cluster_token()}\n".encode())
        protocol.awrite_msg(self.writer, "register_node",
                            node_id=self.c.node_id,
                            resources=dict(self.c.total),
                            host=_socket.gethostname(), pid=os.getpid(),
                            data_addr=self.data_server.addr,
                            codec_ver=_codec.wire_version())
        msg = await protocol.aread_msg(self.reader)
        if msg is None or msg[0] != "register_ok":
            raise ConnectionError("head rejected registration "
                                  "(bad RTPT_CLUSTER_TOKEN?)")
        # negotiated native-codec version for frames TO the head (the head
        # echoes min(ours, its own); receivers sniff, so 0 is always safe)
        self._codec_ver = min(_codec.wire_version(),
                              msg[1].get("codec_ver", 0))
        print(f"[node] {self.c.node_id} joined head at "
              f"{self.head_host}:{self.head_port}", file=sys.stderr)
        self.c.loop.create_task(self._heartbeat())
        while True:
            msg = await protocol.aread_msg(self.reader)
            if msg is None:
                print("[node] head connection lost; shutting down",
                      file=sys.stderr)
                return
            await self._handle(msg[0], msg[1])

    async def _heartbeat(self):
        while not self.c._shutdown:
            await asyncio.sleep(HEARTBEAT_S)
            if chaos.enabled():
                drop, delay = chaos.get_injector().heartbeat_fault()
                if drop:
                    continue  # black-holed beat: head's liveness sweep sees
                              # silence while the TCP link stays up
                if delay:
                    await asyncio.sleep(delay)
            try:
                # span shipping piggybacks on the heartbeat: drain this
                # node's traced phase spans (node-id-stamped pid groups
                # them per process in Perfetto) plus the agent process's
                # own tracing ring, capped per beat so a burst can't bloat
                # one frame — leftovers ride the next beat
                raw = self.c.span_outbox[:500]  # raw tuples, ~4 events each
                del self.c.span_outbox[:len(raw)]
                spans = format_timeline(raw)
                spans += tracing.to_chrome(tracing.drain(500))
                pid = os.getpid()
                for ev in spans:
                    ev["pid"] = pid
                # node-local health gauges ride the same frame (no extra
                # round trip); ts inside lets the head derive hb latency
                try:
                    health = self.c.health_snapshot()
                except Exception:  # noqa: BLE001
                    health = {}
                protocol.awrite_msg(
                    self.writer, "stats",
                    available=dict(self.c.available),
                    total=dict(self.c.total),
                    health=health,
                    # echo of the highest fwd_task seq processed: lets the
                    # head re-debit claims this snapshot can't reflect yet
                    fwd_seq=self.last_fwd_seq,
                    direct_pull_bytes=self.direct_pull_bytes,
                    direct_serve_bytes=self.data_server.serve_bytes,
                    spans=spans)
            except OSError:
                return

    # ------------------------------------------------------------- handlers
    async def _handle(self, kind: str, p: dict):
        c = self.c
        if kind == "fwd_task":
            await self._on_fwd_task(p)
        elif kind == "resp":
            fut = self._reqs.pop(p.pop("req_id"), None)
            if fut is not None and not fut.done():
                fut.set_result(p)
        elif kind == "pull_object":
            # async: a pull may target an object a local task is STILL
            # COMPUTING (the head learned the oid via locate_object) — wait
            # for it rather than replying not-found
            self.c.loop.create_task(self._on_pull_object(p))
        elif kind == "pull_objects":
            self.c.loop.create_task(self._on_pull_objects(p))
        elif kind == "locate_object":
            meta = c.objects.get(p["oid"])
            if meta is None:
                self._reply(p["req_id"], status="unknown")
            elif meta.location == "pending":
                self._reply(p["req_id"], status="pending")
            else:
                self._reply(p["req_id"], status="ready", size=meta.size,
                            meta_len=meta.meta_len)
        elif kind == "free_object":
            c.decref([p["oid"]])
        elif kind == "create_pg":
            # a cross-node placement group's bundle(s) hosted here: reserve
            # via a node-local group (ref: GCS 2-phase bundle reserve). The
            # head's correlation ref lets a timed-out head cancel this exact
            # reservation even though it never learned the pg id.
            try:
                pg_id = c.create_placement_group(p["bundles"], "PACK")
                if p.get("ref"):
                    self._head_pg_refs[p["ref"]] = pg_id
                self._reply(p["req_id"], pg_id=pg_id)
            except Exception as e:  # noqa: BLE001
                self._reply(p["req_id"], error=e)
        elif kind == "remove_pg":
            c.remove_placement_group(p["pg_id"])
            self._head_pg_refs = {r: pid for r, pid in
                                  self._head_pg_refs.items()
                                  if pid != p["pg_id"]}
        elif kind == "remove_pg_ref":
            pg_id = self._head_pg_refs.pop(p["ref"], None)
            if pg_id is not None:
                c.remove_placement_group(pg_id)
        elif kind == "cancel":
            c.cancel(p["task_id"], force=p.get("force", False))
        elif kind == "kill_actor":
            c.kill_actor(p["actor_id"], no_restart=p.get("no_restart", True))

    def _ingest_deps(self, deps) -> list:
        """Register shipped dep bytes; returns their oids. A re-shipped oid
        this node already holds gets +1 refcount so each forwarded task's
        completion can decref exactly once. REDIRECT deps (owned by a
        sibling node) register as pending and pull producer→consumer in the
        background — the forwarded task waits on them through the normal
        deps_remaining machinery."""
        oids = []
        for d in deps or []:
            oid = d["oid"]
            meta = self.c.objects.get(oid)
            if meta is not None and meta.location not in ("pending", "error"):
                meta.refcount += 1
            elif d.get("enc") == "redirect":
                if meta is None:
                    meta = ObjectMeta(object_id=oid)  # born holding 1 ref
                    self.c.objects[oid] = meta
                    self.c.object_events[oid] = asyncio.Event()
                else:
                    # a sibling task already registered this pending dep:
                    # add THIS task's hold so each _watch decref balances
                    meta.refcount += 1
                if meta.location != "pending":
                    meta.location = "pending"
                    self.c.object_events[oid].clear()
                # single-flight via the pull manager: N tasks sharing the
                # dep = ONE transfer, byte-capped alongside eager pulls
                self.pull_manager.request(
                    oid, d.get("size") or 0,
                    lambda d=d: self._direct_pull(d))
            else:
                self.c._ingest_bytes(oid, d)
            oids.append(oid)
        return oids

    def _holds(self, oid: str):
        """Fire-and-forget holder registration: the head records this node
        as an extra source for `oid`, so later pulls can fan streams out
        across peers (multi-peer parallel fetch)."""
        if self.writer is not None:
            try:
                protocol.awrite_msg(self.writer, "holds_object", oid=oid)
            except OSError:
                pass

    async def _fetch_direct(self, d: dict, timeout: float = 120):
        """Chunked-parallel pull of a redirected dep (every holder the head
        knows), falling back to the single stream when parallelism is
        off or the redirect carries no size."""
        oid = d["oid"]
        payload = None
        if use_parallel_transfer() and d.get("size"):
            payload = await parallel_fetch(
                d.get("addrs") or [d["addr"]], oid, d["size"],
                d.get("meta_len", 0), d.get("contained"), self.c.store,
                timeout=timeout)
        if payload is None:
            payload = await direct_fetch(d["addr"], oid, timeout=timeout)
        return payload

    async def _direct_pull(self, d: dict) -> bool:
        """Pull a redirected dep straight from its owner's data server;
        fall back to a head-staged fetch if the owner is gone/evicted, and
        surface ObjectLostError if both fail (same contract as
        _pull_uplink). Runs under the pull manager, which keeps the oid
        in-flight until this returns — a task arriving mid-pull can never
        spawn a duplicate transfer."""
        oid = d["oid"]
        try:
            payload = await self._fetch_direct(d)
        except Exception:  # noqa: BLE001 - dead peer: try the head instead
            payload = None
        if payload is not None:
            self.direct_pull_bytes += payload["size"]
            self.c._ingest_bytes(oid, payload)
            self._holds(oid)
            return True
        ok = False
        try:
            ok = await self.fetch_object(oid, no_redirect=True)
        except Exception:  # noqa: BLE001 - uplink hiccup = not found
            ok = False
        if not ok:
            meta = self.c.objects.get(oid)
            if meta is not None and meta.location == "pending":
                meta.error = exc.ObjectLostError(oid)
                meta.location = "error"
                ev = self.c.object_events.get(oid)
                if ev is not None:
                    ev.set()
                self.c._resolve_dep(oid)
        return bool(ok)

    async def _on_fwd_task(self, p: dict):
        spec: TaskSpec = p["spec"]
        self.last_fwd_seq = max(self.last_fwd_seq, p.get("seq", 0))
        dep_oids = self._ingest_deps(p.get("deps"))
        if spec.is_actor_creation and spec.actor_id not in self.c.actors:
            options = p.get("options")
            # the head owns naming; register anonymously here so a duplicate
            # name can't collide with a node-local actor
            import copy
            options = copy.copy(options)
            options.name = None
            self.c.register_actor(spec, options)
            self.c._head_actors.add(spec.actor_id)
        # placement already happened at the head; submit through the node
        # controller with the HEAD's result oids so both controllers name
        # the same objects (dispatch can fire synchronously inside submit,
        # so the ids must be right before it runs)
        spec.scheduling_strategy = None
        try:
            await self.c.submit(spec, result_oids=list(p["result_oids"]))
        except Exception as e:  # noqa: BLE001
            protocol.awrite_msg(self.writer, "task_result",
                                task_id=spec.task_id, error=e, results=[])
            return
        rec = self.c.tasks[spec.task_id]
        self.c.loop.create_task(self._watch(rec, dep_oids))

    async def _watch(self, rec, dep_oids=()):
        await rec.done.wait()
        results = []
        error = None
        for oid in rec.result_oids:
            meta = self.c.objects.get(oid)
            if meta is None:
                error = RuntimeError(f"result {oid} vanished")
                break
            if meta.location == "error":
                error = meta.error
                break
            if meta.location == "inline":
                results.append({"oid": oid, "enc": "inline",
                                "data": meta.inline_value, "size": meta.size,
                                "contained": list(meta.contained)})
            else:
                results.append({"oid": oid, "enc": "remote",
                                "size": meta.size, "meta_len": meta.meta_len,
                                "contained": list(meta.contained)})
        if error is not None:
            protocol.awrite_msg(self.writer, "task_result",
                                task_id=rec.spec.task_id, error=error,
                                results=[])
        else:
            # phases computed by the node controller at completion ride up
            # so the head's state API covers forwarded tasks too
            protocol.awrite_msg(self.writer, "task_result",
                                task_id=rec.spec.task_id, results=results,
                                phases=rec.phases)
        if dep_oids:
            # drop this task's hold on its shipped dep copies (pins taken by
            # submit are already released; _evict guards on pinned)
            self.c.decref(list(dep_oids))

    async def _pull_payload(self, oid: str, timeout: float) -> dict:
        """Build one pull reply: waits out a still-computing object, then
        ships inline value or packed blob (shared by the single pull RPC
        and the batched pull_objects frame)."""
        c = self.c
        meta = c.objects.get(oid)
        if meta is not None and meta.location == "pending":
            ev = c.object_events.get(oid)
            if ev is not None:
                try:
                    await asyncio.wait_for(ev.wait(), timeout)
                except asyncio.TimeoutError:
                    pass
            meta = c.objects.get(oid)
        if meta is None or meta.location in ("pending", "error"):
            return {"oid": oid, "found": False}
        if meta.location == "inline":
            return {"oid": oid, "found": True, "enc": "inline",
                    "data": meta.inline_value, "size": meta.size,
                    "contained": list(meta.contained)}
        try:
            c._ensure_local(oid)
            blob = c.store.read_raw(oid)
        except Exception:  # noqa: BLE001 - segment vanished
            return {"oid": oid, "found": False}
        return {"oid": oid, "found": True, "enc": "blob", "data": blob,
                "size": meta.size, "meta_len": meta.meta_len,
                "contained": list(meta.contained)}

    async def _on_pull_object(self, p: dict):
        r = await self._pull_payload(p["oid"], p.get("timeout", 120))
        r.pop("oid", None)
        self._reply(p["req_id"], **r)

    async def _on_pull_objects(self, p: dict):
        """Batched pull: one RPC ships a whole get()-list's worth of
        objects held here (O(nodes) round trips for a batched get, not
        O(refs))."""
        results = []
        for oid in p["oids"]:
            results.append(await self._pull_payload(oid, p.get("timeout", 90)))
        self._reply(p["req_id"], results=results)

    # ----------------------------------------------------------- uplink rpc
    def _reply(self, req_id, **payload):
        protocol.awrite_msg(self.writer, "resp", req_id=req_id, **payload)

    def _rpc(self, kind: str, **payload) -> asyncio.Future:
        self._req_counter += 1
        req_id = self._req_counter
        fut = self.c.loop.create_future()
        self._reqs[req_id] = fut
        protocol.awrite_msg(self.writer, kind, req_id=req_id, **payload)
        return fut

    async def fetch_object(self, oid: str, timeout: float = 120,
                           no_redirect: bool = False) -> bool:
        """Pull an object this node has never seen. The head answers with
        bytes (head-local objects) or a redirect to the owner node's data
        server (sibling objects — pulled direct, one hop). A failed direct
        pull retries once via the head-staged path (no_redirect=True)."""
        try:
            p = await asyncio.wait_for(
                self._rpc("fetch_object", oid=oid, timeout=timeout,
                          no_redirect=no_redirect),
                timeout=timeout + 10)
        except (asyncio.TimeoutError, OSError):
            return False
        if not p.get("found"):
            return False
        if p.get("enc") == "redirect":
            payload = await self._fetch_direct({**p, "oid": oid},
                                               timeout=timeout)
            if payload is not None:
                self.direct_pull_bytes += payload["size"]
                self.c._ingest_bytes(oid, payload)
                self._holds(oid)
                return True
            if no_redirect:
                return False
            return await self.fetch_object(oid, timeout=timeout,
                                           no_redirect=True)
        self.c._ingest_bytes(oid, p)
        return True

    async def up_submit(self, spec: TaskSpec, result_oids=None):
        """Submit at the head for cluster-wide placement. Ships bytes for
        any ref args this node holds locally (the head may not have them).
        `result_oids` carries client-derived return ids up, so a pipelined
        submit names the same objects at the head."""
        deps = []
        oids = [v for kind, v in
                list(spec.args) + list(spec.kwargs.values()) if kind == "ref"]
        for oid in dict.fromkeys(oids):
            meta = self.c.objects.get(oid)
            if meta is None or meta.location in ("pending", "error"):
                continue
            if meta.location == "inline":
                deps.append({"oid": oid, "enc": "inline",
                             "data": meta.inline_value, "size": meta.size,
                             "contained": list(meta.contained)})
            else:
                try:
                    self.c._ensure_local(oid)
                    blob = self.c.store.read_raw(oid)
                except Exception:  # noqa: BLE001
                    continue
                deps.append({"oid": oid, "enc": "blob", "data": blob,
                             "size": meta.size, "meta_len": meta.meta_len,
                             "contained": list(meta.contained)})
        p = await self._rpc("up_submit", spec=spec, deps=deps,
                            result_oids=result_oids)
        if "error" in p:
            raise p["error"]
        # the result objects live at the head (or wherever it places the
        # task); local get() of these oids goes through fetch_object
        return p["refs"]


async def _amain(args) -> int:
    # own shm arena + socket: a node must never collide with a head or
    # another node on the same host (the single-host test topology)
    os.environ["RTPT_ARENA"] = \
        f"rtpt-arena-{os.getpid()}-{ids.new_id('a')[-8:]}"
    store_bytes = int(args.object_store_memory or DEFAULT_CAPACITY)
    os.environ["RTPT_STORE_BYTES"] = str(store_bytes)
    sock = os.path.join(paths.user_tmp_root(),
                        f"rtpt-node-{os.getpid()}.sock")
    os.environ["RTPT_ADDRESS"] = sock
    resources = {"CPU": float(args.num_cpus), "memory": 32 << 30}
    if args.num_gpus:
        # the node's cards are the CUDA_VISIBLE_DEVICES it was started
        # with (node_provider.spawn_agent): an actor's card id indexes them
        seen = [x for x in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",") if x.strip()]
        if "CUDA_VISIBLE_DEVICES" in os.environ and len(seen) < args.num_gpus:
            raise SystemExit(f"--num-gpus {args.num_gpus:g} but CUDA_VISIBLE_DEVICES "
                             f"names {len(seen)} cards ({seen})")
        resources["GPU"] = float(args.num_gpus)
    import json
    for k, v in (json.loads(args.resources) if args.resources else {}).items():
        resources[k] = float(v)
    controller = NodeController(sock, resources, job_id=ids.job_id(),
                                store_capacity=store_bytes)
    if chaos.enabled():
        # constructing the injector arms RAY_TPU_CHAOS_KILL_AFTER_S (node
        # suicide-by-SIGKILL after N seconds — the chaos ladder's main rung)
        chaos.get_injector()
    await controller.start()
    agent = NodeAgent(controller, args.address)
    try:
        await agent.run()
    finally:
        agent.data_server.close()
        await controller.shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ray_tpu_torch worker node (joins a head started with "
                    "ray_tpu_torch.init(cluster_port=...))")
    ap.add_argument("--address", required=True, help="head HOST:PORT")
    ap.add_argument("--num-cpus", type=float, default=float(os.cpu_count() or 4))
    ap.add_argument("--num-gpus", type=float, default=0.0,
                    help="cards this node owns: the first N of CUDA_VISIBLE_DEVICES")
    ap.add_argument("--resources", default="", help='extra resources, JSON '
                    '(e.g. \'{"worker_node": 1}\')')
    ap.add_argument("--object-store-memory", type=int, default=0)
    args = ap.parse_args(argv)
    return asyncio.run(_amain(args))
