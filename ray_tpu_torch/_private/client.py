"""Runtime clients: driver-side (in-process controller) and worker-side (socket).

Reference split: python/ray/_private/worker.py (driver/worker modes) over the
cython core_worker. Both clients expose the same surface so `ray_tpu_torch.api`
works identically in driver code and inside tasks/actors.

Pipelined control plane (ref: Ray's async SubmitTask + batched
reference-count RPCs, core_worker.cc / reference_count.cc):

- `submit` derives the return-object ids locally (ids.object_id_for_return)
  and ships the spec fire-and-forget; submission errors surface through the
  refs' descriptors. `RAY_TPU_SYNC_SUBMIT=1` restores the blocking path.
- refcount/stream deltas and put registrations coalesce in a _DeltaFlusher
  and travel as single multi-entry "batch" frames. Ordering contract: every
  OTHER frame on the channel (blocking RPCs, fire-and-forget sends, the
  pipelined submit itself) forces a flush first, so a batch entry can never
  be applied after a frame that was issued later — and a decref can never
  overtake the put that created its ref.
- client-owned small objects (ref: Ray's ownership model): this client owns
  its own inline puts and the returns of tasks it submits. Descriptors live
  in a local _OwnedTable; the head (a write-behind cache for these) pushes
  result descriptors back unsolicited, so an owner-local chain
  `f.remote(g.remote(x))` + get() completes with ZERO blocking control
  round trips. RAY_TPU_OWNERSHIP=0 restores head-owned-everything.
"""

import collections
import concurrent.futures
import os
import socket
import sys
import threading
import time
import asyncio

from .. import exceptions as exc
from .._native import codec as _codec
from ..util import tracing
from . import ids, protocol, serialization
from .object_store import StoreClient
from .task_spec import TaskSpec

_INLINE_MAX = 64 * 1024

# first-return-oid -> trace id, ONLY for refs whose trace was inherited
# from the surrounding context (nested submits, driver spans) — a root
# task's trace id IS its task id, re-derivable from the oid, so the hot
# path stores nothing. Bounded FIFO so an un-got ref can't grow it
# without limit.
_REF_TRACE_CAP = 4096
_ref_traces = collections.OrderedDict()
_ref_traces_lock = threading.Lock()


# submit hot path: trace ids are DERIVED from the task id (no mint, no
# registry write) — any process holding the task id recomputes the same
# id and sampling verdict. Returns the trace id only when it was
# inherited from the thread-local context (nested submits), the one case
# the caller must _note_ref_trace.
_annotate_trace = tracing.stamp


def _note_ref_trace(oid: str, trace_id):
    if trace_id is None:
        return
    with _ref_traces_lock:
        _ref_traces[oid] = trace_id
        while len(_ref_traces) > _REF_TRACE_CAP:
            _ref_traces.popitem(last=False)


def _ref_trace(oid: str):
    with _ref_traces_lock:
        tid = _ref_traces.get(oid)
    if tid is not None:
        return tid
    # root-task refs: obj-{task_id}-ret{i} — re-derive instead of storing
    if oid.startswith("obj-"):
        cut = oid.rfind("-ret")
        if cut > 4:
            return tracing.trace_id_for(oid[4:cut])
    return None

# flush when a batch accumulates this many entries / inline-put bytes, or
# when the short timer fires — whichever comes first. The nap is sized so a
# realistic driver burst (a few hundred ~10 µs submits) completes before the
# controller loop starts crunching the batch: on a small host they share
# cores, and a nap that expires mid-burst preempts the submit loop. Blocking
# consumers force-flush, so only pure fire-and-forget sees the nap at all.
# 512 (was 128): the controller applies a whole batch in one loop step and
# its native schedule pass is batched too, so bigger drains cost the loop
# side little — while each extra flush preempts the submit thread mid-burst.
_FLUSH_MAX_ENTRIES = int(os.environ.get("RAY_TPU_FLUSH_MAX_ENTRIES", "512"))
_FLUSH_MAX_BYTES = int(os.environ.get("RAY_TPU_FLUSH_MAX_BYTES",
                                      str(256 * 1024)))
_FLUSH_INTERVAL_S = float(os.environ.get("RAY_TPU_FLUSH_INTERVAL_S", "0.008"))


def _sync_submit_requested() -> bool:
    return os.environ.get("RAY_TPU_SYNC_SUBMIT", "").lower() in (
        "1", "true", "yes")


def _prefetch_enabled() -> bool:
    # mirrors controller.prefetch_enabled() without importing the whole
    # controller module into every worker process
    return os.environ.get("RAY_TPU_PREFETCH", "1").lower() not in (
        "0", "false", "no")


def _ownership_enabled() -> bool:
    # client-owned small objects (mirrors controller.ownership); the
    # RAY_TPU_OWNERSHIP=0 escape hatch restores head-owned-everything
    return os.environ.get("RAY_TPU_OWNERSHIP", "1").lower() not in (
        "0", "false", "no")


class _OwnedTable:
    """Client-LOCAL descriptor table for objects this client owns (ref: Ray
    ownership — the submitting worker owns its returns,
    reference_count.cc). Entries are registered at put()/submit() time; the
    head pushes result descriptors back over the existing channel
    (controller._push_owned → "owned" frames / the driver's in-process
    sink), so an owner-local get() resolves HERE with zero round trips —
    the head's object directory is only a write-behind cache for these.

    entry: [desc, event, rc, inline_parts]
      desc          ("inline", bytes) | ("err", exc) | ("head", None) |
                    None while the producing task is in flight
      event         lazily-created waiter (created under the lock, so a
                    concurrent resolve can't slip between check and wait)
      rc            local ref mirror; the entry dies at zero
      inline_parts  (meta_len, size, bytes) for resolved inline values —
                    what submit() ships as TaskSpec.owned_inline
    """

    __slots__ = ("_lock", "_entries")

    def __init__(self):
        # Reentrant, like _DeltaFlusher's: allocations under the lock (the
        # lazily-created waiter Event, refcount bumps) can trigger GC, and a
        # collected ObjectRef's __del__ re-enters decref() on this same
        # thread — a plain Lock self-deadlocks there. Reentrant mutation is
        # safe: no method iterates _entries, and a nested decref can only
        # drop entries whose last reference just died (never one a caller
        # still holds a ref to).
        self._lock = threading.RLock()
        self._entries = {}

    def add_resolved(self, oid, payload, meta_len, size):
        with self._lock:
            self._entries[oid] = [("inline", payload), None, 1,
                                  (meta_len, size, payload)]

    def add_pending(self, oids):
        with self._lock:
            for oid in oids:
                self._entries[oid] = [None, None, 1, None]

    def resolve(self, entries):
        """Descriptor push from the head (controller loop thread for the
        driver sink, recv thread for workers): fill descriptors, wake
        waiters. Unknown oids (entry already dropped at rc 0) are ignored."""
        with self._lock:
            for oid, kind, payload, meta_len, size in entries:
                e = self._entries.get(oid)
                if e is None:
                    continue
                if kind == "inline":
                    e[0] = ("inline", payload)
                    e[3] = (meta_len, size, payload)
                elif kind == "err":
                    e[0] = ("err", payload)
                else:  # bytes live in shm/another node: head serves the get
                    e[0] = ("head", None)
                if e[1] is not None:
                    e[1].set()

    def resolve_results(self, results):
        """Self-execution: a worker that executes a task IT submitted seals
        its own owned results here (the head sees owner == sender there and
        skips the push)."""
        entries = []
        for r in results:
            if r[0] in self._entries:
                entries.append((r[0],
                                "inline" if r[3] is not None else "head",
                                r[3], r[1], r[2]))
        if entries:
            self.resolve(entries)

    def peek(self, oid):
        """Resolved descriptor or None (absent or still pending)."""
        e = self._entries.get(oid)
        return e[0] if e is not None else None

    def waiter(self, oid):
        """(desc, event): a resolved descriptor, or the event a pending
        entry's resolve will set, or (None, None) when the oid isn't owned
        here."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return None, None
            if e[0] is not None:
                return e[0], None
            if e[1] is None:
                e[1] = threading.Event()
            return None, e[1]

    def inline_parts(self, oid):
        e = self._entries.get(oid)
        return e[3] if e is not None else None

    def incref(self, oid):
        with self._lock:
            e = self._entries.get(oid)
            if e is not None:
                e[2] += 1

    def decref(self, oid):
        with self._lock:
            e = self._entries.get(oid)
            if e is not None:
                e[2] -= 1
                if e[2] <= 0:
                    del self._entries[oid]


class _SingleFlight:
    """In-flight fetch dedup (ref: raylet pull dedup / golang singleflight):
    the first getter of a key owns the wire fetch, concurrent getters join
    its future instead of issuing a duplicate RPC. Resolved/failed claims
    leave the table, so later gets re-fetch fresh state."""

    def __init__(self):
        self._lock = threading.Lock()
        self._futs = {}

    def claim(self, keys):
        """Partition `keys` into (owned, joined): `owned` keys are this
        caller's to fetch (and then resolve/fail — ALWAYS, or joiners hang);
        `joined` maps each in-flight key to its owner's future."""
        owned, joined = [], {}
        with self._lock:
            for k in keys:
                f = self._futs.get(k)
                if f is None:
                    self._futs[k] = concurrent.futures.Future()
                    owned.append(k)
                else:
                    joined[k] = f
        return owned, joined

    def resolve(self, key, result):
        with self._lock:
            f = self._futs.pop(key, None)
        if f is not None and not f.done():
            f.set_result(result)

    def fail(self, key, err):
        with self._lock:
            f = self._futs.pop(key, None)
        if f is not None and not f.done():
            f.set_exception(err)


class _DeltaFlusher:
    """Coalesces small control messages into ordered multi-entry batches.

    Entries are applied by the controller strictly in append order. The sink
    runs UNDER the flusher lock, so concurrent drains cannot reorder (an
    older batch always reaches the controller before a younger one). The
    lock is reentrant because appends can arrive from ObjectRef.__del__
    while this thread is already inside a flush (GC during pickling).
    """

    def __init__(self, sink, lock=None):
        self._sink = sink  # called with the drained entry list, lock held
        self.lock = lock if lock is not None else threading.RLock()
        self._entries = []
        self._bytes = 0
        self._urgent = False
        self._closed = False
        self._in_sink = False
        self._wake = threading.Event()
        self._thread = None

    def append(self, entry, nbytes=0, urgent=False):
        with self.lock:
            self._entries.append(entry)
            self._bytes += nbytes
            if urgent:
                # latency-sensitive entry (e.g. a task_done publication):
                # the timer flushes without the coalescing nap
                self._urgent = True
            if self._closed:
                # post-close stragglers (interpreter teardown): best effort,
                # but never from inside an active sink — a nested send would
                # interleave with the partially written frame
                if not self._in_sink:
                    self.flush_locked()
                return
            if (len(self._entries) >= _FLUSH_MAX_ENTRIES
                    or self._bytes >= _FLUSH_MAX_BYTES):
                self._urgent = True
            if self._thread is None:
                t = threading.Thread(
                    target=self._timer_loop, daemon=True,
                    name="ray-gpu-delta-flusher")
                try:
                    t.start()
                    self._thread = t
                except RuntimeError:
                    # interpreter teardown: no new threads — sink directly
                    if not self._in_sink:
                        self.flush_locked()
                    return
        # already-set is the steady state in a burst: is_set() is a plain
        # attribute read, set() takes the event's condition lock every call
        if not self._wake.is_set():
            self._wake.set()

    def append_entry(self, entry):
        """append() minus the byte/urgency accounting — the pipelined submit
        path, where every entry is small and non-urgent. Falls back to the
        general path for the rare states (closed, timer not yet running)."""
        lock = self.lock
        lock.acquire()
        if self._closed or self._thread is None:
            lock.release()
            return self.append(entry)
        entries = self._entries
        entries.append(entry)
        if len(entries) >= _FLUSH_MAX_ENTRIES:
            self._urgent = True
        lock.release()
        if not self._wake.is_set():
            self._wake.set()

    def drain_locked(self):
        """Take the pending entries without sinking them (the caller ships
        them itself, e.g. fused with a pipelined submit). Lock must be held."""
        entries, self._entries, self._bytes = self._entries, [], 0
        return entries

    def flush_locked(self):
        if self._entries:
            entries = self.drain_locked()
            self._in_sink = True
            try:
                self._sink(entries)
            finally:
                self._in_sink = False

    def flush(self):
        with self.lock:
            self.flush_locked()

    def close(self):
        with self.lock:
            self._closed = True
            self.flush_locked()
        self._wake.set()

    def _timer_loop(self):
        while True:
            self._wake.wait()
            if self._closed:
                return
            if not self._urgent:
                time.sleep(_FLUSH_INTERVAL_S)
            if self._closed:
                return
            with self.lock:
                self._wake.clear()
                self._urgent = False
                self.flush_locked()


class BaseClient:
    """Shared materialization: descriptor → value using the local store."""

    def __init__(self):
        self.store = StoreClient()
        self.job_id = None
        self._owned = None  # _OwnedTable when the ownership model is active
        # Precomputed pipelined-submit fast lane consumed by
        # RemoteFunction.remote() for single-return tasks:
        # (owner label or None, flusher append_entry, owned entries dict or
        # None). Mirrors the nr==1 arm of submit() — keep the two in sync.
        # None when submits must go through submit() (sync mode).
        self._lane = None

    def _resolve_owned(self, uniq, timeout):
        """Serve what the ownership table can from LOCAL state. Returns
        (descs, remaining): `descs` maps owned oids to materializable
        descriptors, `remaining` lists what the head must serve (not owned
        here, or owned bytes living in shm/another node). PENDING owned
        entries are waited on here — their descriptor arrives as an
        unsolicited push on the background channel, so the wait costs zero
        control round trips (metrics.control_local_gets_total counts the
        serves; the ownership bench section asserts the zero)."""
        owned = self._owned
        if owned is None:
            return {}, uniq
        descs, remaining, waits = {}, [], []
        for o in uniq:
            desc, ev = owned.waiter(o)
            if desc is not None:
                if desc[0] == "head":
                    remaining.append(o)
                else:
                    descs[o] = desc
            elif ev is not None:
                waits.append((o, ev))
            else:
                remaining.append(o)
        if waits:
            self.flush()  # the producing submit may still sit in the batch
            deadline = None if timeout is None else (
                time.monotonic() + timeout)
            for o, ev in waits:
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if (left is not None and left <= 0) or not ev.wait(left):
                    raise exc.GetTimeoutError(
                        f"get() timed out waiting for owned object {o}")
                desc = owned.peek(o)
                if desc is None or desc[0] == "head":
                    remaining.append(o)
                else:
                    descs[o] = desc
        if descs:
            protocol.note_local_get(len(descs))
        return descs, remaining

    def _attach_owned_args(self, spec):
        """Copy resolved inline descriptors for owned ref args INTO the spec
        (TaskSpec.owned_inline): the spec stays self-contained, so a head
        that forwards it to another node never round-trips back to the
        owner for small args."""
        owned = self._owned
        inline = None
        for kind, v in spec.args:
            if kind == "ref":
                parts = owned.inline_parts(v)
                if parts is not None:
                    inline = inline if inline is not None else {}
                    inline[v] = parts
        for kind, v in spec.kwargs.values():
            if kind == "ref":
                parts = owned.inline_parts(v)
                if parts is not None:
                    inline = inline if inline is not None else {}
                    inline[v] = parts
        if inline:
            spec.owned_inline = inline

    def _materialize(self, oids, descs):
        out = []
        for oid, (kind, payload) in zip(oids, descs):
            if kind == "err":
                raise payload
            if kind == "inline":
                out.append(serialization.unpack(payload))
            else:  # shm
                try:
                    out.append(self.store.get(oid, payload))
                except FileNotFoundError:
                    out.append(self._reread_demoted(oid))
        return out

    def _reread_demoted(self, oid, attempts=16):
        """The shm read raced the spill ladder: the segment was demoted back
        to disk between the descriptor reply and our copy-out (a batched get
        of a working set larger than the arena cannot keep every object
        resident at once). Re-request this ONE descriptor — the owner
        restores the segment — and read immediately; the single-object
        window is tiny, so this converges even under heavy churn."""
        for _ in range(attempts):
            kind, payload = self._descriptor_for(oid)
            if kind == "err":
                raise payload
            if kind == "inline":
                return serialization.unpack(payload)
            try:
                return self.store.get(oid, payload)
            except FileNotFoundError:
                continue
        raise FileNotFoundError(
            f"object {oid} kept being demoted between restore and read")

    def _descriptor_for(self, oid):
        raise NotImplementedError

    def _encode_to_store(self, oid, value):
        """Serialize once; returns (meta_len, size, inline_or_None, contained
        ref ids). Writes shm only when over the inline threshold."""
        meta, buffers, contained = serialization.dumps_oob(value)
        return self._store_parts(oid, meta, buffers, contained)

    def _store_parts(self, oid, meta, buffers, contained):
        size = serialization.total_size(meta, buffers)
        if size <= _INLINE_MAX:
            return 0, size, serialization.pack_parts(meta, buffers), contained
        try:
            self.store.put_parts(oid, meta, buffers)
        except MemoryError:
            # arena full (or too fragmented to fit `size` contiguously):
            # ask the owner to demote cold objects to disk and retry —
            # first down to the pressure target, then draining everything
            # unpinned before letting the put fail
            self._request_spill(size, hard=False)
            try:
                self.store.put_parts(oid, meta, buffers)
            except MemoryError:
                self._request_spill(size, hard=True)
                self.store.put_parts(oid, meta, buffers)
        return len(meta), size, None, contained

    def _request_spill(self, size, hard):
        """Ask the controller to make room in the shm tier (overridden per
        transport); the base client has no control plane to ask."""

    def put_serialized(self, meta, buffers, contained):
        """put() for an ALREADY-serialized value (encode_arg's implicit put
        of large args: the bytes were produced sizing the arg — don't
        serialize twice). Returns the new object id."""
        oid = ids.object_id()
        meta_len, size, inline, contained = self._store_parts(
            oid, meta, buffers, contained)
        self._register_put(oid, meta_len, size, inline, contained)
        return oid

    def close(self):
        self.store.close()


class DriverClient(BaseClient):
    """Runs in the driver process; controller lives on a background thread."""

    def __init__(self, controller, loop):
        super().__init__()
        self.controller = controller
        self.loop = loop
        self.store = controller.store
        self.job_id = controller.job_id
        self.is_driver = True
        self._pipelined = not _sync_submit_requested()
        self._flusher = _DeltaFlusher(self._post_batch)
        if self._pipelined and _ownership_enabled():
            self._owned = _OwnedTable()
            # in-process descriptor push: the controller's _push_owned calls
            # this on its loop thread (the table is thread-safe)
            controller.owner_sinks["driver"] = self._owned.resolve
        if self._pipelined:
            self._lane = (
                "driver" if self._owned is not None else None,
                self._flusher.append_entry,
                self._owned._entries if self._owned is not None else None)

    def _post_batch(self, entries):
        """Flusher sink: apply a drained batch on the controller loop. Loop
        callbacks run in post order, so posting under the flusher lock keeps
        batches ordered among themselves and ahead of any later bridge call.
        Consecutive incref/decref runs collapse into packed refdelta blobs
        first — the controller applies those through the sharded directory
        in ONE bulk call instead of a dict hit per id."""
        try:
            self.loop.call_soon_threadsafe(
                self.controller.apply_batch_local,
                _codec.fold_refdeltas(entries))
        except RuntimeError:
            pass  # loop already closed at shutdown

    def flush(self):
        """Post any pending deltas to the controller loop (api.shutdown calls
        this before stopping the controller so nothing is silently dropped)."""
        self._flusher.flush()

    def _call(self, coro, timeout=None):
        self._flusher.flush()  # pending deltas apply before `coro` runs
        protocol.note_roundtrip("driver_call")
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            raise exc.GetTimeoutError("operation timed out") from None

    def _call_soon(self, fn, *args):
        """Run fn on the controller loop and wait (thread-safe sync bridge)."""
        self._flusher.flush()
        protocol.note_roundtrip("driver_call")
        done = concurrent.futures.Future()

        def run():
            try:
                done.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001
                done.set_exception(e)

        self.loop.call_soon_threadsafe(run)
        return done.result()

    # -- api surface --------------------------------------------------------
    def submit(self, spec: TaskSpec):
        inherited = _annotate_trace(spec)
        if not self._pipelined:
            oids = self._call(self.controller.submit(spec))
            _note_ref_trace(oids[0], inherited)
            return oids
        nr = spec.num_returns
        owned = self._owned
        if nr == 1:  # dominant case: skip the listcomp + per-id call
            oid = "obj-" + spec.task_id + "-ret0"
            oids = [oid]
            if owned is not None:
                spec.owner_id = "driver"
                # add_pending inlined, lock-free: a dict store is GIL-atomic
                # and the entry is unreachable by any other thread until this
                # call returns the ObjectRef (resolve only fires after the
                # flusher ships the spec, strictly later). Owned-arg inline
                # descriptors are attached by the PRODUCER of the spec
                # (remote_function / actor) — not here — so scalar-only
                # submits skip the arg scan entirely.
                owned._entries[oid] = [None, None, 1, None]
        else:
            n = 1 if nr == "streaming" else max(nr, 1)
            oids = [ids.object_id_for_return(spec.task_id, i)
                    for i in range(n)]
            if owned is not None and nr != "streaming":
                # this driver owns the returns: pending table entries now,
                # the head pushes descriptors back when the task completes
                spec.owner_id = "driver"
                owned.add_pending(oids)
        if inherited is not None:
            _note_ref_trace(oids[0], inherited)
        # the submit itself is a batch entry: a tight submit loop posts ONE
        # loop callback per drained batch instead of one call_soon_threadsafe
        # (and one loop self-pipe write) per task. Append order keeps the
        # spec behind the put registrations of its own arguments. The append
        # is deliberately NOT urgent: waking the flusher per submit turned a
        # tight submit loop into a 3-thread GIL ping-pong. Every blocking
        # consumer (get/wait/_call) force-flushes first, so the only cost of
        # lazy dispatch is ≤ one coalescing nap on pure fire-and-forget.
        self._flusher.append_entry(("submit", spec, oids))
        return oids

    def get(self, oids, timeout=None):
        t0 = time.time() if tracing.enabled() else 0.0
        # dedup before the fetch: a get([r, r, ...]) waits/pulls each unique
        # object once, then fans the descriptors back out in caller order.
        # Owned objects resolve from the local table first — a fully-owned
        # get never posts to the controller loop at all.
        uniq = list(dict.fromkeys(oids))
        by_oid, remaining = self._resolve_owned(uniq, timeout)
        if remaining:
            descs = self._call(
                self.controller.get_descriptors(remaining, timeout),
                timeout=None if timeout is None else timeout + 5)
            by_oid.update(zip(remaining, descs))
        out = self._materialize(oids, [by_oid[o] for o in oids])
        if t0:
            tracing.record_span(
                "client.get", "client", _ref_trace(oids[0]) if oids else None,
                tracing.new_span_id(), None, t0, time.time() - t0,
                args={"n": len(oids)})
        return out

    def put(self, value):
        oid = ids.object_id()
        meta_len, size, inline, contained = self._encode_to_store(oid, value)
        self._register_put(oid, meta_len, size, inline, contained)
        return oid

    def _register_put(self, oid, meta_len, size, inline, contained):
        if not self._pipelined:
            self._call_soon(self.controller.register_put, oid, meta_len,
                            size, inline, contained)
            return
        if self._owned is not None and inline is not None:
            # this driver owns its own put: gets resolve locally from now on
            self._owned.add_resolved(oid, inline, meta_len, size)
        self._flusher.append(("put", oid, meta_len, size, inline, contained),
                             nbytes=len(inline) if inline is not None else 0)

    def wait(self, oids, num_returns, timeout):
        return self._call(self.controller.wait(oids, num_returns, timeout))

    def cancel(self, task_id, force=False):
        self._call_soon(self.controller.cancel, task_id, force)

    def kill_actor(self, actor_id, no_restart=True):
        self._call_soon(self.controller.kill_actor, actor_id, no_restart)

    def get_actor(self, name, namespace=None):
        return self._call_soon(self.controller.lookup_actor, name, namespace)

    def register_actor(self, spec, options):
        return self._call_soon(self.controller.register_actor, spec, options)

    def _request_spill(self, size, hard):
        self._call_soon(self.controller.spill_for_put, size, hard)

    def _descriptor_for(self, oid):
        return self._call(self.controller.get_descriptors([oid], None))[0]

    # deltas ride the flusher (the sink swallows loop-closed RuntimeError at
    # shutdown, like the old direct call_soon_threadsafe wrappers did); the
    # owned table mirrors the refcount so its entries die with the last ref
    def decref(self, oid):
        if self._owned is not None:
            self._owned.decref(oid)
        self._flusher.append(("decref", oid))

    def incref(self, oid):
        if self._owned is not None:
            self._owned.incref(oid)
        self._flusher.append(("incref", oid))

    def actor_incref(self, actor_id):
        self._flusher.append(("actor_incref", actor_id))

    def actor_decref(self, actor_id):
        self._flusher.append(("actor_decref", actor_id))

    def open_stream(self, task_id):
        self._flusher.append(("open_stream", task_id))

    def close_stream(self, task_id):
        self._flusher.append(("close_stream", task_id))

    def resources(self):
        return (self._call_soon(self.controller.res_total),
                self._call_soon(self.controller.res_available))

    def request_resources(self, num_cpus=None, bundles=None):
        return self._call_soon(self.controller.request_resources, num_cpus, bundles)

    def autoscaler_status(self):
        return self._call_soon(self.controller.autoscaler_status)

    def set_node_provider(self, provider, max_nodes=4):
        return self._call_soon(self.controller.set_node_provider, provider,
                               max_nodes)

    def object_sizes(self, oids):
        """Registered byte sizes (0 for unknown ids) — cheap metadata read used
        by the data streaming executor's memory accounting."""
        def read():
            return [self.controller.objects[o].size
                    if o in self.controller.objects else 0 for o in oids]
        return self._call_soon(read)

    def object_locations(self, oids):
        """Node id holding each object's bytes (the head's own id for
        head-local objects, None for pending/unknown) — the data streaming
        executor tags map tasks with their input block's owner."""
        def read():
            return [self.controller._object_location(o) for o in oids]
        return self._call_soon(read)

    def state(self, kind):
        return self._call_soon(self.controller.state_snapshot, kind)

    def chaos_op(self, op):
        return self._call_soon(self.controller.chaos_op, op)

    def next_stream_item(self, task_id, index, timeout=None):
        return self._call(self.controller.next_stream_item(task_id, index, timeout))

    def create_placement_group(self, bundles, strategy, name=""):
        return self._call(
            self.controller.create_pg_any(bundles, strategy, name))

    def remove_placement_group(self, pg_id):
        self._call_soon(self.controller.remove_placement_group, pg_id)

    def as_future(self, ref):
        self._flusher.flush()  # the ref's put may still be in the batch
        out = concurrent.futures.Future()

        def done(descs_fut):
            try:
                descs = descs_fut.result()
                out.set_result(self._materialize([ref.id], descs)[0])
            except BaseException as e:  # noqa: BLE001
                out.set_exception(e)

        fut = asyncio.run_coroutine_threadsafe(
            self.controller.get_descriptors([ref.id], None), self.loop)
        fut.add_done_callback(done)
        return out

    def timeline(self):
        from ray_tpu_torch.util import tracing
        from .controller import format_timeline
        evts = self._call_soon(
            lambda: format_timeline(self.controller.timeline_events))
        # merge the DRIVER process's own span ring: serve engines hosted
        # in the driver (PD demos, tests, bench) record serve.* spans here,
        # and no heartbeat ever ships this process's ring
        return evts + tracing.to_chrome(tracing.events())


class WorkerClient(BaseClient):
    """Runs inside worker processes; all ops are socket RPCs to the controller.

    A dedicated receiver thread demultiplexes: "exec" messages feed the task
    loop, "resp" messages resolve pending request futures.
    """

    def __init__(self, socket_path: str, worker_id: str, driver: bool = False):
        """driver=True attaches this process to an EXISTING session
        (ray.init(address=...) parity): same RPC surface, never receives
        task executions, and learns the session's shm arena via handshake."""
        import os as _os
        if driver:
            # BaseClient.__init__ would build the store before we know the
            # arena; defer it until after the hello handshake below
            self.store = None
            self.job_id = None
        else:
            super().__init__()
        self.worker_id = worker_id
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(socket_path)
        self.is_driver = driver
        # RLock: ObjectRef.__del__ can fire mid-send (GC during pickling) and
        # re-enter via the flusher, which shares this lock so every socket
        # write — batch frames included — stays serialized and ordered
        self._lock = threading.RLock()
        self._pipelined = not _sync_submit_requested()
        self._owned = (_OwnedTable()
                       if self._pipelined and _ownership_enabled() else None)
        self._flusher = _DeltaFlusher(self._send_batch, self._lock)
        if self._pipelined:
            self._lane = (
                worker_id if self._owned is not None else None,
                self._flusher.append_entry,
                self._owned._entries if self._owned is not None else None)
        self._getflight = _SingleFlight()  # cross-thread get dedup
        self._reqs = {}
        self._req_counter = 0
        self.task_queue = []  # consumed by worker_main
        self.task_available = threading.Condition()
        self._current = threading.local()  # per-exec-thread task id
        self.task_threads = {}  # task_id -> thread ident (for targeted cancel)
        # codec negotiation: announce what we can decode; send with
        # min(ours, controller's ceiling). Spawned workers read the ceiling
        # from the env the controller set; attached drivers learn it from
        # the hello reply (receivers sniff, so a stale 0 just means pickle).
        own_ver = _codec.wire_version()
        self._codec_ver = min(own_ver, int(
            _os.environ.get("RTPT_CODEC_VER", "0") or 0))
        # an attached driver's module directories (a job's working dir is
        # its cwd) reach the workers the session spawns after it
        sys_path = ([_os.path.abspath(p or _os.getcwd()) for p in sys.path
                     if _os.path.isdir(p or ".")] if driver else None)
        protocol.send_msg(self.sock, "register", worker_id=worker_id,
                          pid=_os.getpid(), driver=driver, codec_ver=own_ver,
                          sys_path=sys_path)
        self._recv_thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._recv_thread.start()
        if driver:
            hello = self._rpc("hello", timeout=10, codec_ver=own_ver)
            if hello.get("arena"):
                _os.environ["RTPT_ARENA"] = hello["arena"]
                _os.environ["RTPT_STORE_BYTES"] = str(hello["store_bytes"])
            self.store = StoreClient()
            self.job_id = hello["job_id"]
            self._codec_ver = min(own_ver, hello.get("codec_ver", 0))

    @property
    def current_task_id(self):
        return getattr(self._current, "task_id", None)

    @current_task_id.setter
    def current_task_id(self, value):
        self._current.task_id = value
        ident = threading.get_ident()
        if value is None:
            for tid, i in list(self.task_threads.items()):
                if i == ident:
                    del self.task_threads[tid]
        else:
            self.task_threads[value] = ident

    def _cancel_exec(self, task_id):
        """Raise KeyboardInterrupt in the thread executing task_id (ref: Ray
        interrupts workers with SIGINT; we target the exact thread)."""
        ident = self.task_threads.get(task_id)
        if ident is None:
            return
        import ctypes
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(ident), ctypes.py_object(KeyboardInterrupt))

    def _recv_loop(self):
        while True:
            try:
                msg = protocol.recv_msg(self.sock)
            except OSError:
                msg = None
            if msg is None:
                # controller gone: unblock everything, then die with the ship
                with self.task_available:
                    self.task_queue.append(None)
                    self.task_available.notify_all()
                for fut in list(self._reqs.values()):
                    if not fut.done():
                        fut.set_exception(ConnectionError("controller connection lost"))
                return
            kind, p = msg
            if kind == "exec":
                with self.task_available:
                    self.task_queue.append(p)
                    self.task_available.notify_all()
            elif kind == "cancel_exec":
                self._cancel_exec(p["task_id"])
            elif kind == "owned":
                # unsolicited descriptor push for objects this client owns
                if self._owned is not None:
                    self._owned.resolve(p["entries"])
            elif kind == "resp":
                fut = self._reqs.pop(p.pop("req_id"), None)
                if fut is not None and not fut.done():
                    if "error" in p:
                        fut.set_exception(p["error"])
                    else:
                        fut.set_result(p)
            elif kind == "exit":
                import os
                os._exit(0)

    def _send_batch(self, entries):
        """Flusher sink (lock held): one multi-entry frame for the batch.
        Consecutive incref/decref runs collapse into packed refdelta blobs
        (bulk-applied by the controller's directory), and the frame goes out
        natively coded when the handshake negotiated codec_ver > 0."""
        try:
            protocol.send_payload(
                self.sock, "batch", {"entries": _codec.fold_refdeltas(entries)},
                codec_on=self._codec_ver > 0)
        except OSError:
            pass  # controller gone: its crash reconciliation covers the rest

    def flush(self):
        self._flusher.flush()

    def close(self):
        self._flusher.close()
        super().close()

    def _rpc(self, kind, timeout=None, **payload):
        with self._lock:
            self._flusher.flush_locked()  # forced flush before any blocking RPC
            self._req_counter += 1
            req_id = self._req_counter
            fut = concurrent.futures.Future()
            self._reqs[req_id] = fut
            protocol.send_msg(self.sock, kind, req_id=req_id, **payload)
        protocol.note_roundtrip(kind)
        return fut.result(timeout)

    def _send(self, kind, **payload):
        with self._lock:
            self._flusher.flush_locked()  # frames apply in issue order
            protocol.send_msg(self.sock, kind, **payload)

    # -- api surface --------------------------------------------------------
    def submit(self, spec: TaskSpec):
        # nested tasks inherit the exec thread's trace
        inherited = _annotate_trace(spec)
        if not self._pipelined:
            oids = self._rpc("submit", spec=spec)["refs"]
            _note_ref_trace(oids[0], inherited)
            return oids
        nr = spec.num_returns
        owned = self._owned
        if nr == 1:  # dominant case: skip the listcomp + per-id call
            oid = "obj-" + spec.task_id + "-ret0"
            oids = [oid]
            if owned is not None:
                # this worker owns the returns of tasks IT submits (nested
                # tasks): the head pushes descriptors back as "owned" frames.
                # add_pending inlined lock-free (see DriverClient.submit).
                spec.owner_id = self.worker_id
                owned._entries[oid] = [None, None, 1, None]
        else:
            n = 1 if nr == "streaming" else max(nr, 1)
            oids = [ids.object_id_for_return(spec.task_id, i)
                    for i in range(n)]
            if owned is not None and nr != "streaming":
                spec.owner_id = self.worker_id
                owned.add_pending(oids)
        if inherited is not None:
            _note_ref_trace(oids[0], inherited)
        # fire-and-forget batch entry: append order keeps the spec behind
        # the put registrations of its own arguments, and a tight submit
        # loop shares one frame across many submits (non-urgent: blocking
        # RPCs flush, so only fire-and-forget pays the coalescing nap)
        self._flusher.append_entry(("submit", spec, oids))
        return oids

    def get(self, oids, timeout=None):
        # release our cpu while blocked so the pool can progress (ref: raylet
        # NotifyDirectCallTaskBlocked)
        tid = self.current_task_id
        if tid:
            self._send("blocked", task_id=tid)
        try:
            # dedup: each unique object crosses the wire (and pulls) once —
            # across exec THREADS too: concurrent getters of an oid join the
            # claimant's in-flight claim instead of issuing their own RPC.
            # Owned objects short-circuit first: their descriptors live (or
            # will arrive) in the local ownership table — no RPC at all.
            uniq = list(dict.fromkeys(oids))
            descs, remaining = self._resolve_owned(uniq, timeout)
            mine, joined = self._getflight.claim(remaining)
            if mine:
                try:
                    p = self._rpc("get", oids=mine, timeout=timeout)
                except BaseException as e:
                    for o in mine:
                        self._getflight.fail(o, e)
                    raise
                for o, d in zip(mine, p["results"]):
                    descs[o] = d
                    self._getflight.resolve(o, d)
            for o, f in joined.items():
                try:
                    descs[o] = f.result(timeout)
                except Exception:
                    # the owner's fetch failed (or ITS deadline expired):
                    # retry directly instead of inheriting the failure
                    descs[o] = self._rpc(
                        "get", oids=[o], timeout=timeout)["results"][0]
        finally:
            if tid:
                self._send("unblocked", task_id=tid)
        return self._materialize(oids, [descs[o] for o in oids])

    def put(self, value):
        oid = ids.object_id()
        meta_len, size, inline, contained = self._encode_to_store(oid, value)
        self._register_put(oid, meta_len, size, inline, contained)
        return oid

    def _register_put(self, oid, meta_len, size, inline, contained):
        if not self._pipelined:
            self._rpc("put", oid=oid, meta_len=meta_len, size=size,
                      inline=inline, contained=contained)
            return
        if self._owned is not None and inline is not None:
            # this worker owns its own put: gets resolve locally from now on
            self._owned.add_resolved(oid, inline, meta_len, size)
        self._flusher.append(("put", oid, meta_len, size, inline, contained),
                             nbytes=len(inline) if inline is not None else 0)

    def put_result(self, oid, value):
        """Store a task result; returns (oid, meta_len, size, inline, contained)."""
        meta_len, size, inline, contained = self._encode_to_store(oid, value)
        return (oid, meta_len, size, inline, contained)

    def send_task_done(self, task_id, results, error, span=None, spans=None):
        """Publish a task's completion. With prefetching dispatch on, the
        entry rides the ordered batch flusher (fire-and-forget: the exec
        thread is free for the next task without awaiting application, and
        since every blocking RPC force-flushes first, a later decref can
        never be applied before this publication — put-before-decref holds
        transitively). Legacy mode keeps the direct ordered frame.

        `span` is the worker-side timing tuple (resolve start, exec start,
        exec end — epoch seconds) the controller folds into the task's
        phase spans; None when tracing is off/unsampled. `spans` is the
        drained tracing ship-outbox (Chrome-format dicts): app windows
        recorded in THIS worker during exec, bound for the head timeline."""
        if self._owned is not None and results:
            # results of a task this worker itself submitted (dispatch looped
            # back here): the head skips the owner push when owner == sender,
            # so seal our own table directly
            self._owned.resolve_results(results)
        if self._pipelined and _prefetch_enabled():
            # urgent: the flusher timer skips its coalescing nap — callers
            # may already be blocked in ray.get() on these results
            self._flusher.append(
                ("task_done", task_id, results, error, span, spans),
                urgent=True)
        else:
            self._send("task_done", task_id=task_id, results=results,
                       error=error, span=span, spans=spans)

    def wait(self, oids, num_returns, timeout):
        tid = self.current_task_id
        if tid:
            self._send("blocked", task_id=tid)
        try:
            p = self._rpc("wait", oids=oids, num_returns=num_returns, timeout=timeout)
        finally:
            if tid:
                self._send("unblocked", task_id=tid)
        return p["ready"], p["not_ready"]

    def cancel(self, task_id, force=False):
        self._rpc("cancel", task_id=task_id, force=force)

    def kill_actor(self, actor_id, no_restart=True):
        self._rpc("kill_actor", actor_id=actor_id, no_restart=no_restart)

    def get_actor(self, name, namespace=None):
        return self._rpc("get_actor", name=name, namespace=namespace)["actor_id"]

    def register_actor(self, spec, options):
        # worker-side actor creation goes through submit path with options piggybacked
        return self._rpc("register_actor_rpc", spec=spec, options=options)["actor_id"]

    def _request_spill(self, size, hard):
        self._rpc("spill", timeout=60, bytes=size, hard=hard)

    def _descriptor_for(self, oid):
        return self._rpc("get", oids=[oid], timeout=None)["results"][0]

    # deltas ride the flusher (append cannot fail; the sink swallows OSError
    # at shutdown, like the old per-message try/except did); the owned table
    # mirrors the refcount so its entries die with the last local ref
    def decref(self, oid):
        if self._owned is not None:
            self._owned.decref(oid)
        self._flusher.append(("decref", oid))

    def incref(self, oid):
        if self._owned is not None:
            self._owned.incref(oid)
        self._flusher.append(("incref", oid))

    def actor_incref(self, actor_id):
        self._flusher.append(("actor_incref", actor_id))

    def actor_decref(self, actor_id):
        self._flusher.append(("actor_decref", actor_id))

    def open_stream(self, task_id):
        self._flusher.append(("open_stream", task_id))

    def close_stream(self, task_id):
        self._flusher.append(("close_stream", task_id))

    def resources(self):
        p = self._rpc("resources")
        return p["total"], p["available"]

    def request_resources(self, num_cpus=None, bundles=None):
        p = self._rpc("request_resources", num_cpus=num_cpus, bundles=bundles)
        p.pop("req_id", None)
        return p

    def autoscaler_status(self):
        p = self._rpc("autoscaler_status")
        p.pop("req_id", None)
        return p

    def object_sizes(self, oids):
        return self._rpc("obj_sizes", oids=oids)["sizes"]

    def object_locations(self, oids):
        return self._rpc("obj_locations", oids=oids)["locations"]

    def state(self, kind):
        return self._rpc("state", which=kind)["rows"]

    def chaos_op(self, op):
        p = self._rpc("chaos_op", chaos=op)
        if "error" in p:
            raise p["error"]
        p.pop("req_id", None)
        return p

    def timeline(self):
        return self._rpc("timeline")["events"]

    def next_stream_item(self, task_id, index, timeout=None):
        return self._rpc("next_stream", task_id=task_id, index=index, timeout=timeout)["item"]

    def create_placement_group(self, bundles, strategy, name=""):
        return self._rpc("create_pg", bundles=bundles, strategy=strategy,
                         name=name)["pg_id"]

    def remove_placement_group(self, pg_id):
        self._rpc("remove_pg", pg_id=pg_id)

    def as_future(self, ref):
        fut = concurrent.futures.Future()

        def run():
            try:
                fut.set_result(self.get([ref.id])[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    def notify_actor_exit(self, actor_id):
        self._send("actor_exit", actor_id=actor_id)
