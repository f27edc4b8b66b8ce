"""KV-page shipment plane for prefill/decode disaggregation, and the KV
stash that radix eviction demotes pages into.

Counterpart of `ray_tpu/serve/kv_transfer.py`, over the port's own pershm
store (`_private/object_store.py`):

  * the PREFILL side seals pages into per-object shm segments (create ->
    fill -> seal) and puts only segment metadata in the RPC frame (oid,
    byte count, page range);
  * the DECODE side pulls each segment the cheapest way available: it
    attaches the segment by name on the same host; else it pulls the bytes
    from the prefill replica's `KVDataServer` over several ranged TCP
    streams into a local segment (`parallel_fetch`, the port's copy of the
    JAX runtime's multi-stream pull); else it asks for the raw bytes over
    the RPC (`rpc_fetch`).
  * `KVPageStash` holds pages that the radix tree LRU-evicted: shm first,
    the oldest segments spilled to disk past a byte budget, restored byte
    for byte on the next matching request.

Layout of a segment: the k block, then the v block, each a C-contiguous
[L, Kh, n, ps, D] tensor of the pool's dtype; the dtype travels by name
("bfloat16", "float32"). The device copies go straight between the pool
and the segment: a page gathered on the device is copied into a
torch.frombuffer view of the mapped segment (one device-to-host copy), and
a pulled segment is read through tensors that alias it.

Naming: `seg_name` keeps a hash of the whole oid. Ship oids are 16 chars: an
8-hex per-process tag, a 4-hex ship counter, a 3-hex segment index and a
role suffix. The storage segment (`...s`) and the wire id served to remote
pullers (`...w`) differ in that suffix, so a same-host puller forced onto
the remote path lands its copy under the wire id and never over the
writer's live segment.

Switches, with the JAX package's defaults: RAY_TPU_KV_SHIP (1: stream; 0:
the whole KV in the RPC reply), RAY_TPU_SPILL_KV (1: demote evicted radix
pages), RAY_TPU_SPILL_STASH_BYTES (the stash's shm budget, 256 MiB),
RAY_TPU_KV_ATTACH (0 forbids the same-host attach), RAY_TPU_KV_DATA (0: no
KV data server), RAY_TPU_KV_HOST (the data server's bind address,
127.0.0.1), RAY_TPU_TRANSFER_STREAMS (ranged streams per pull, 4),
RAY_TPU_TRANSFER_DEADLINE_S (one pull's time budget, 30 s) and
RAY_TPU_CLUSTER_TOKEN (the data server's shared secret).
"""

import asyncio
import atexit
import collections
import gc
import hmac
import itertools
import os
import socket as _socket
import time
import weakref
import zlib
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch._private.object_store import StoreClient, seg_name
from ray_tpu_torch.util import metrics as _metrics

_proc_tag = os.urandom(4).hex()          # 8 chars, fresh per process
_ship_counter = itertools.count(1)


def kv_ship_enabled() -> bool:
    """Streaming is the default; RAY_TPU_KV_SHIP=0 restores the whole-KV
    RPC hand-off."""
    return os.environ.get("RAY_TPU_KV_SHIP", "1") != "0"


def kv_demote_enabled() -> bool:
    """Radix-evicted KV pages demote into the stash instead of being
    discarded; RAY_TPU_SPILL_KV=0 restores discard-on-evict."""
    return os.environ.get("RAY_TPU_SPILL_KV", "1") != "0"


def stash_budget_bytes() -> int:
    """The stash's shm budget before it spills its oldest segments to disk."""
    return int(os.environ.get("RAY_TPU_SPILL_STASH_BYTES", 256 << 20))


def local_attach_enabled() -> bool:
    """RAY_TPU_KV_ATTACH=0 forbids the same-host attach, forcing the data
    server or RPC pull on one host."""
    return os.environ.get("RAY_TPU_KV_ATTACH", "1") != "0"


def data_server_enabled() -> bool:
    return os.environ.get("RAY_TPU_KV_DATA", "1") != "0"


def cluster_token() -> str:
    return os.environ.get("RAY_TPU_CLUSTER_TOKEN", "")


def new_ship_id() -> str:
    return f"{_proc_tag}{next(_ship_counter) & 0xFFFF:04x}"


def _seg_base(ship_id: str, seg_index: int) -> str:
    return f"{ship_id}{seg_index & 0xFFF:03x}"


def storage_oid(ship_id: str, seg_index: int) -> str:
    return _seg_base(ship_id, seg_index) + "s"


def wire_oid(ship_id: str, seg_index: int) -> str:
    return _seg_base(ship_id, seg_index) + "w"


def dtype_name(dtype: torch.dtype) -> str:
    """"bfloat16" for torch.bfloat16: the name a segment's dtype travels by."""
    return str(dtype).rsplit(".", 1)[-1]


def torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown KV dtype {name!r}")
    return dtype


def _counter(name: str, desc: str) -> "_metrics.Counter":
    return _metrics.get_or_create(_metrics.Counter, name, desc)


def _seal_blocks(store: StoreClient, oid: str, k: torch.Tensor,
                 v: torch.Tensor) -> int:
    """Seal k then v (same shape and dtype, on any device) into one new
    segment; returns its byte count. Each block is made contiguous where
    it lives and copied into the mapped segment in one copy (device to
    host for a CUDA pool). Pageable memory makes that copy synchronous, so
    the bytes are complete before seal(), and the caller may reuse the
    pages right after."""
    kb = k.numel() * k.element_size()
    nbytes = 2 * kb
    handle = store.create_writable(oid, nbytes)
    try:
        seg = torch.frombuffer(handle.view, dtype=torch.uint8, count=nbytes)
        try:
            seg[:kb].copy_(k.contiguous().view(torch.uint8).reshape(-1))
            seg[kb:].copy_(v.contiguous().view(torch.uint8).reshape(-1))
        finally:
            del seg   # the last alias of the mapping: it can close now
    except BaseException:
        handle.abort()
        raise
    handle.seal()
    return nbytes


def _carve(buf, nbytes: int, shape, dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k and v blocks of one segment's bytes, as tensors that alias
    `buf` (no copy)."""
    half = nbytes // 2
    count = half // torch.empty((), dtype=dtype).element_size()
    k = torch.frombuffer(buf, dtype=dtype, count=count, offset=0)
    v = torch.frombuffer(buf, dtype=dtype, count=count, offset=half)
    return k.view(shape), v.view(shape)


def _delete_all(store: StoreClient, segments: dict, files: Optional[dict] = None):
    """Unlink every segment keyed in `segments` and remove every spill file
    of `files` ({oid: (path, nbytes)}), emptying both."""
    for oid in list(segments):
        store.delete_segment(oid)
    segments.clear()
    for path, _ in (files or {}).values():
        if os.path.exists(path):
            os.remove(path)
    if files:
        files.clear()


class ShipWriter:
    """Prefill-side segment publisher. Segments left at close (or at
    garbage collection, or at exit) are unlinked."""

    def __init__(self):
        self.store = StoreClient()
        self._sizes: Dict[str, int] = {}            # storage oid -> nbytes
        self._ship_oids: Dict[str, List[str]] = {}  # ship -> storage oids
        self._finalizer = weakref.finalize(self, _delete_all, self.store,
                                           self._sizes)

    def publish(self, ship_id: str, seg_index: int, k_pages: torch.Tensor,
                v_pages: torch.Tensor, page_start: int) -> Dict[str, Any]:
        """Seal one segment (k block then v block, each [L, Kh, n, ps, D])
        and return its wire metadata."""
        oid = storage_oid(ship_id, seg_index)
        nbytes = _seal_blocks(self.store, oid, k_pages, v_pages)
        self._sizes[oid] = nbytes
        self._ship_oids.setdefault(ship_id, []).append(oid)
        n_pages = int(k_pages.shape[2])
        _counter("kv_ship_bytes", "KV bytes sealed for PD shipment").inc(nbytes)
        _counter("kv_ship_pages", "KV pages sealed for PD shipment").inc(n_pages)
        _counter("kv_ship_segments", "KV shipment segments sealed").inc()
        return {"seg": seg_index, "oid": oid,
                "wire": wire_oid(ship_id, seg_index), "nbytes": nbytes,
                "page_start": int(page_start), "n_pages": n_pages}

    def read_segment(self, oid: str) -> bytearray:
        """Raw bytes for the RPC fetch fallback (the one path that puts KV
        bytes back in an RPC frame)."""
        if oid not in self._sizes:
            raise KeyError(f"unknown kv segment {oid}")
        _counter("kv_ship_rpc_fallback_bytes",
                 "KV bytes served via the RPC fetch fallback").inc(self._sizes[oid])
        return self.store.read_raw(oid)

    def size_of(self, oid: str) -> Optional[int]:
        return self._sizes.get(oid)

    def drop_ship(self, ship_id: str) -> None:
        """Free every segment of one shipment (decode installed it, or the
        request failed)."""
        for oid in self._ship_oids.pop(ship_id, []):
            self._sizes.pop(oid, None)
            self.store.delete_segment(oid)

    def close(self) -> None:
        self._ship_oids.clear()
        self._finalizer()


class KVPageStash:
    """Demotion tier for radix prefix pages: the device edge of the spill
    ladder (pool page -> shm segment -> disk file).

    put() seals one evicted page's k and v into a segment and returns its
    handle. Past the shm budget the oldest segments spill to disk
    (`StoreClient.spill`: a temp file, then a rename); get() of a
    disk-resident handle brings it back to shm (`StoreClient.restore`)
    before reading it. Occupancy goes to the `store_tier_*` gauges under
    `owner=kv_stash`. A handle's bytes never change (a prefix page's tokens
    fix its KV), so a handle stays valid over any number of round trips."""

    def __init__(self, budget_bytes: Optional[int] = None):
        self.store = StoreClient()
        self._seq = itertools.count(1)
        self._shm: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()                  # oid -> nbytes, oldest first
        self._disk: Dict[str, Tuple[str, int]] = {}    # oid -> (path, nbytes)
        self.budget = stash_budget_bytes() if budget_bytes is None else budget_bytes
        self.shm_bytes = 0
        self.disk_bytes = 0
        self._finalizer = weakref.finalize(self, _delete_all, self.store,
                                           self._shm, self._disk)

    def _gauge(self):
        tags = {"owner": "kv_stash"}
        for name, desc, value in (
                ("store_tier_shm_bytes", "bytes resident in the shm tier", self.shm_bytes),
                ("store_tier_disk_bytes", "bytes demoted to the disk tier", self.disk_bytes),
                ("store_tier_shm_objects", "objects resident in the shm tier",
                 len(self._shm)),
                ("store_tier_disk_objects", "objects demoted to the disk tier",
                 len(self._disk))):
            _metrics.get_or_create(_metrics.Gauge, name, desc,
                                   tag_keys=("owner",)).set(value, tags)

    def put(self, k_page: torch.Tensor, v_page: torch.Tensor) -> Dict[str, Any]:
        """Seal one page's k and v (on any device) and return its handle."""
        oid = f"kvd{_proc_tag}{next(self._seq):08x}"
        nbytes = _seal_blocks(self.store, oid, k_page, v_page)
        self._shm[oid] = nbytes
        self.shm_bytes += nbytes
        self._enforce_budget()
        self._gauge()
        return {"oid": oid, "nbytes": nbytes, "shape": list(k_page.shape),
                "dtype": dtype_name(k_page.dtype)}

    def _enforce_budget(self):
        """shm -> disk: spill the oldest segments past the budget."""
        while self.shm_bytes > self.budget and self._shm:
            oid, nbytes = self._shm.popitem(last=False)
            self.shm_bytes -= nbytes
            self._disk[oid] = (self.store.spill(oid), nbytes)
            self.disk_bytes += nbytes

    def get(self, handle: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        """One page's (k, v) as CPU tensors, byte for byte as put; a
        disk-resident segment comes back to shm first."""
        oid = handle["oid"]
        if oid in self._disk:
            path, nbytes = self._disk.pop(oid)
            self.disk_bytes -= nbytes
            self.store.restore(oid, path)
            self._shm[oid] = nbytes
            self.shm_bytes += nbytes
            self._enforce_budget()
        elif oid in self._shm:
            self._shm.move_to_end(oid)   # hot again
        blob = self.store.read_raw(oid)
        self._gauge()
        return _carve(blob, handle["nbytes"], tuple(handle["shape"]),
                      torch_dtype(handle["dtype"]))

    def drop(self, handle: Dict[str, Any]) -> None:
        """The handle will never be restored: free its tier residency."""
        oid = handle["oid"]
        if oid in self._shm:
            self.shm_bytes -= self._shm.pop(oid)
            self.store.delete_segment(oid)
        elif oid in self._disk:
            path, nbytes = self._disk.pop(oid)
            self.disk_bytes -= nbytes
            if os.path.exists(path):
                os.remove(path)
        self._gauge()

    def tier_stats(self) -> Dict[str, int]:
        return {"shm_objects": len(self._shm), "shm_bytes": self.shm_bytes,
                "disk_objects": len(self._disk), "disk_bytes": self.disk_bytes}

    def close(self) -> None:
        self._finalizer()
        self.shm_bytes = self.disk_bytes = 0
        self._gauge()


# -- ranged multi-stream pull (the port's copy of the JAX runtime's) ---------
_DATA_CHUNK = 1 << 20     # 1 MiB frames on the data plane
_PARALLEL_MIN = 4 << 20   # objects below this ride one stream (setup wins)
_RANGE_MIN = 1 << 20      # never split a transfer finer than this per stream


def transfer_streams() -> int:
    """Streams per pull (RAY_TPU_TRANSFER_STREAMS, default 4)."""
    return max(1, int(os.environ.get("RAY_TPU_TRANSFER_STREAMS", "4")))


def transfer_deadline_s() -> float:
    """Wall-clock budget of one pull, retries included
    (RAY_TPU_TRANSFER_DEADLINE_S, default 30)."""
    return max(1.0, float(os.environ.get("RAY_TPU_TRANSFER_DEADLINE_S", "30")))


def retry_backoff_s(attempt: int, key: str = "", base: float = 0.05,
                    cap: float = 2.0) -> float:
    """Bounded exponential backoff with a jitter factor (0.5..1.0) hashed
    from (key, attempt), so a replay gives the same schedule."""
    delay = min(cap, base * (2 ** max(0, attempt)))
    j = zlib.crc32(f"{key}:{attempt}".encode()) % 1000 / 1000.0
    return delay * (0.5 + 0.5 * j)


async def _range_stream(addr: str, oid: str, view, offset: int, length: int,
                        timeout: float) -> int:
    """One stream: land blob[offset:offset+length] straight into `view`
    with recv_into. Returns the bytes landed: short on any failure, and
    the caller hands the rest to another stream."""
    loop = asyncio.get_running_loop()
    host, port = addr.rsplit(":", 1)
    got = 0
    sock = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    sock.setblocking(False)
    try:
        await asyncio.wait_for(loop.sock_connect(sock, (host, int(port))), timeout=10)
        req = f"RTPU1 {cluster_token()}\nGET {oid} {offset} {length}\n"
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
                n = await asyncio.wait_for(loop.sock_recv_into(sock, sub), timeout)
            finally:
                sub.release()   # the segment seals only once every view is gone
            if n == 0:
                return got      # the server hung up mid-range
            got += n
        return got
    except (OSError, asyncio.TimeoutError, ValueError):
        return got
    finally:
        sock.close()


async def parallel_fetch(addrs, oid: str, size: int, store: StoreClient,
                         timeout: float = 120) -> bool:
    """Pull one blob into a new segment `oid` of `store` over up to
    transfer_streams() concurrent ranged streams, split round-robin over
    `addrs`. A stream that dies has its tail handed to the other servers
    (or retried) with backoff until the deadline; on failure the segment
    is freed. True when every byte landed."""
    addrs = [a for a in addrs if a]
    if not addrs or not size:
        return False
    nstreams = int(min(transfer_streams(), max(1, size // _RANGE_MIN)))
    if size < _PARALLEL_MIN:
        nstreams = 1
    handle = store.create_writable(oid, size)
    view = handle.view
    base = size // nstreams
    ranges = []
    for i in range(nstreams):
        off = i * base
        ranges.append((addrs[i % len(addrs)], off,
                       size - off if i == nstreams - 1 else base))
    ok = False
    deadline = time.monotonic() + min(timeout, transfer_deadline_s())
    try:
        attempt = 0
        while True:
            results = await asyncio.gather(*[
                _range_stream(a, oid, view, off, ln, timeout) for a, off, ln in ranges])
            leftover = [(a, off + got, ln - got)
                        for (a, off, ln), got in zip(ranges, results) if got < ln]
            if not leftover:
                ok = True
                break
            attempt += 1
            pause = retry_backoff_s(attempt, key=oid)
            if time.monotonic() + pause >= deadline:
                break
            await asyncio.sleep(pause)
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
    return ok


class KVDataServer:
    """Serves sealed KV segments over the data-plane wire protocol
    (`RTPU1 <token>` first, then ranged `GET <oid> <offset> <length>`) so
    that `parallel_fetch` pulls work against a serving replica. Requests
    name a segment's WIRE id; the server reads the storage segment."""

    def __init__(self, writer: ShipWriter):
        self._writer = writer
        self.addr = ""
        self.serve_bytes = 0
        self._server = None

    async def start(self, host: Optional[str] = None) -> str:
        host = host or os.environ.get("RAY_TPU_KV_HOST", "127.0.0.1")
        self._server = await asyncio.start_server(self._on_client, host, 0)
        port = self._server.sockets[0].getsockname()[1]
        adv = (_socket.gethostname()
               if host not in ("127.0.0.1", "localhost", "::1") else "127.0.0.1")
        self.addr = f"{adv}:{port}"
        return self.addr

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None

    def _resolve(self, oid: str) -> Optional[str]:
        if oid.endswith("w"):
            storage = oid[:-1] + "s"
            if self._writer.size_of(storage) is not None:
                return storage
        return None

    async def _on_client(self, reader, writer):
        try:
            hello = await asyncio.wait_for(reader.readline(), timeout=10)
            if not hmac.compare_digest(hello, f"RTPU1 {cluster_token()}\n".encode()):
                return
            while True:
                line = await reader.readline()
                if not line:
                    break
                parts = line.decode("ascii", "replace").split()
                if parts[:1] != ["GET"] or len(parts) != 4:
                    break
                await self._serve_range(writer, parts[1], int(parts[2]), int(parts[3]))
        except (OSError, asyncio.TimeoutError, ValueError):
            pass   # the puller hands an unserved range to another stream
        finally:
            writer.close()

    async def _serve_range(self, writer, oid: str, offset: int, length: int):
        storage = self._resolve(oid)
        size = self._writer.size_of(storage) if storage else None
        if size is None or offset < 0 or length <= 0 or offset + length > size:
            writer.write(b"MISS\n")
            await writer.drain()
            return
        try:
            blob = self._writer.store.read_range(storage, offset, length)
        except FileNotFoundError:   # the shipment was dropped under us
            writer.write(b"MISS\n")
            await writer.drain()
            return
        writer.write(f"OK {len(blob)}\n".encode("ascii"))
        for i in range(0, len(blob), _DATA_CHUNK):
            writer.write(blob[i:i + _DATA_CHUNK])
            await writer.drain()   # backpressure per chunk
        self.serve_bytes += len(blob)


# Mappings whose close() met a live export (a tensor over the segment not
# yet collected). Holding them here keeps SharedMemory.__del__ from raising
# at collection; every later close, and exit, retries the pool.
_pending_close: List[Any] = []


def _drain_pending_close() -> None:
    still = []
    for shm in _pending_close:
        try:
            shm.close()
        except BufferError:
            still.append(shm)
    _pending_close[:] = still


def _final_drain() -> None:
    gc.collect()
    _drain_pending_close()


atexit.register(_final_drain)


class AttachedSegment:
    """One pulled segment as [L, Kh, n, ps, D] k and v tensors that alias
    it. Close ONLY after the install has consumed them, and drop every
    other alias first; a pulled local copy (delete=True) is unlinked at
    close, a direct attach to the writer's segment only detached (the
    writer owns it)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, shm=None,
                 store: Optional[StoreClient] = None, oid: Optional[str] = None,
                 delete: bool = False):
        self.k = k
        self.v = v
        self._shm = shm
        self._store = store
        self._oid = oid
        self._delete = delete

    def close(self) -> None:
        self.k = None
        self.v = None
        if self._delete and self._store is not None and self._oid:
            # unlink the name now: the open mapping stays valid (POSIX)
            self._store.delete_segment(self._oid)
            self._delete = False
        if self._shm is not None:
            shm, self._shm = self._shm, None
            try:
                shm.close()
            except BufferError:
                _pending_close.append(shm)
        _drain_pending_close()


class ShipReader:
    """Decode-side segment puller, one per decode replica; its store is
    where ranged pulls land."""

    def __init__(self):
        self.store = StoreClient()

    async def fetch(self, seg: Dict[str, Any], layout, dtype: str,
                    data_addr: Optional[str] = None,
                    rpc_fetch=None) -> AttachedSegment:
        """Materialize one segment: shm attach, then the data server, then
        the RPC fetch."""
        tdtype = torch_dtype(dtype)
        if local_attach_enabled():
            att = self._attach(seg["oid"], seg, layout, tdtype, delete=False)
            if att is not None:
                _counter("kv_ship_attach_hits",
                         "KV segments attached zero-copy same-host").inc()
                return att
        if data_addr and await parallel_fetch([data_addr], seg["wire"],
                                              seg["nbytes"], self.store):
            att = self._attach(seg["wire"], seg, layout, tdtype, delete=True)
            if att is not None:
                _counter("kv_ship_stream_pulls",
                         "KV segments pulled via parallel_fetch").inc()
                return att
        if rpc_fetch is not None:
            blob = await rpc_fetch(seg["oid"])
            k, v = _carve(blob, seg["nbytes"], _shape(seg, layout), tdtype)
            _counter("kv_ship_rpc_pulls",
                     "KV segments fetched via the RPC fallback").inc()
            return AttachedSegment(k, v)
        raise RuntimeError(f"kv segment {seg['oid']} unreachable: no shm attach, "
                           "no data server, no RPC fetch")

    def _attach(self, oid: str, seg, layout, dtype,
                delete: bool) -> Optional[AttachedSegment]:
        try:
            shm = shared_memory.SharedMemory(name=seg_name(oid))
        except FileNotFoundError:
            return None
        if shm.buf.nbytes < seg["nbytes"]:
            shm.close()
            return None
        k, v = _carve(shm.buf, seg["nbytes"], _shape(seg, layout), dtype)
        return AttachedSegment(k, v, shm=shm, store=self.store, oid=oid, delete=delete)


def _shape(seg: Dict[str, Any], layout) -> Tuple[int, ...]:
    L, Kh, ps, D = layout
    return (L, Kh, seg["n_pages"], ps, D)
