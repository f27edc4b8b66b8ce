"""Per-object POSIX shared-memory segments with a disk rung.

The port's own copy of the `pershm` half of `ray_tpu/_private/object_store.py`
(plasma's Create -> fill -> Seal protocol, one POSIX segment per object, so
any process attaches by name with no daemon round trip), as far as the KV
plane of `serve/kv_transfer.py` needs it: `create_writable`, `put_raw`,
`read_raw`, `read_range`, `exists`, `delete_segment`, and `spill` /
`restore` to and from the disk tier. There is no slab arena and no object
serialization here: the KV plane moves raw page bytes.

Segments are named `rtpt-<hash of the object id>`, a namespace of their
own, so this store and the JAX package's (`rtpu-`) can live in one process
without touching each other's segments. Spill files go to a temporary
directory this process creates on first use and removes at exit.
"""

import atexit
import hashlib
import os
import shutil
import tempfile
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Optional

from ray_tpu_torch.util import metrics as _metrics

SEG_PREFIX = "rtpt-"

# The stdlib resource_tracker assumes the creator of a segment owns its
# cleanup; these segments outlive their creator's handle (a writer seals
# and detaches, a reader in another process attaches by name and the
# owner unlinks), so tracking them makes the tracker unlink live segments
# and warn at exit. Only this store's namespace is left out: every other
# name goes on to the function that was installed before this module.
_orig_register = resource_tracker.register
_orig_unregister = resource_tracker.unregister


def _filtered_register(name, rtype):
    if rtype == "shared_memory" and f"/{SEG_PREFIX}" in name:
        return
    _orig_register(name, rtype)


def _filtered_unregister(name, rtype):
    if rtype == "shared_memory" and f"/{SEG_PREFIX}" in name:
        return
    _orig_unregister(name, rtype)


resource_tracker.register = _filtered_register
resource_tracker.unregister = _filtered_unregister


def seg_name(object_id: str) -> str:
    """The segment name of an object id: shm names are short (~31 chars
    portable), so the whole id is hashed."""
    return SEG_PREFIX + hashlib.blake2b(object_id.encode(),
                                        digest_size=8).hexdigest()


_spill_root: Optional[str] = None


def _spill_dir() -> str:
    """This process's spill directory, made on first use, removed at exit."""
    global _spill_root
    if _spill_root is None:
        _spill_root = tempfile.mkdtemp(prefix=f"{SEG_PREFIX}spill-")
        atexit.register(shutil.rmtree, _spill_root, True)
    return _spill_root


def _note_spill_io(kind: str, nbytes: int, ms: float):
    """Tally spill-ladder traffic (`kind` is "spill" or "restore"): the
    `<kind>_bytes_total` counter and the `spill_restore_ms` histogram."""
    _metrics.get_or_create(
        _metrics.Counter, f"{kind}_bytes_total",
        f"bytes moved across the {kind} tier boundary").inc(nbytes)
    _metrics.get_or_create(
        _metrics.Histogram, "spill_restore_ms", "spill/restore I/O latency (ms)",
        boundaries=(1, 5, 10, 50, 100, 500, 1000, 5000),
        tag_keys=("op",)).observe(ms, tags={"op": kind})


class WritableBuffer:
    """A preallocated segment exposed as a writable memoryview (`.view`).

    Writers fill disjoint slices of `.view`, then seal(). Every alias of
    `.view` (sub-views, tensors made with torch.frombuffer) must be gone
    before seal() or abort(): a mapping with live exports cannot close."""

    __slots__ = ("_store", "object_id", "view", "_shm", "_done")

    def __init__(self, store, object_id, view, shm):
        self._store = store
        self.object_id = object_id
        self.view = view
        self._shm = shm
        self._done = False

    def seal(self):
        """The bytes are complete; detach this handle (the segment stays)."""
        if self._done:
            return
        self._done = True
        self.view = None
        self._shm.close()

    def abort(self):
        """The fill failed; free the segment."""
        if self._done:
            return
        self._done = True
        self.view = None
        self._shm.close()
        self._store.delete_segment(self.object_id)


class StoreClient:
    """Per-process client of per-object POSIX segments."""

    def _new_segment(self, object_id: str, size: int):
        """Create the object's segment, replacing a stale one left at the
        same id by a failed earlier attempt."""
        try:
            return shared_memory.SharedMemory(name=seg_name(object_id),
                                              create=True, size=size)
        except FileExistsError:
            self.delete_segment(object_id)
            return shared_memory.SharedMemory(name=seg_name(object_id),
                                              create=True, size=size)

    def create_writable(self, object_id: str, size: int) -> WritableBuffer:
        """Allocate the object's segment and hand back a writable view of
        it (plasma Create: allocate, fill, Seal)."""
        shm = self._new_segment(object_id, max(size, 1))
        return WritableBuffer(self, object_id, shm.buf, shm)

    def put_raw(self, object_id: str, blob) -> int:
        """Store packed bytes as one sealed segment (the restore path)."""
        shm = self._new_segment(object_id, max(len(blob), 1))
        shm.buf[:len(blob)] = blob
        shm.close()
        return len(blob)

    def read_raw(self, object_id: str) -> bytearray:
        """A copy of the whole segment. A bytearray, so that tensors made
        over it with torch.frombuffer are writable."""
        shm = shared_memory.SharedMemory(name=seg_name(object_id))
        data = bytearray(shm.buf)
        shm.close()
        return data

    def read_range(self, object_id: str, offset: int, length: int) -> bytes:
        """A copy of one slice of the segment (the data server's ranged
        GET: copies `length` bytes, not the whole object)."""
        shm = shared_memory.SharedMemory(name=seg_name(object_id))
        data = bytes(shm.buf[offset:offset + length])
        shm.close()
        return data

    def exists(self, object_id: str) -> bool:
        try:
            shared_memory.SharedMemory(name=seg_name(object_id)).close()
            return True
        except FileNotFoundError:
            return False

    def delete_segment(self, object_id: str):
        """Unlink the object's segment. Open mappings (this process's or a
        reader's) stay valid until they close (POSIX)."""
        try:
            shm = shared_memory.SharedMemory(name=seg_name(object_id))
        except FileNotFoundError:
            return
        shm.close()
        shm.unlink()

    def spill(self, object_id: str) -> str:
        """Move the object to the disk tier and free its segment; returns
        the spill path. The bytes land in a `.tmp` sidecar first and only
        os.replace publishes them, so a file at the returned path is always
        complete; the segment is freed only after the rename."""
        t0 = time.monotonic()
        path = os.path.join(_spill_dir(), seg_name(object_id))
        data = self.read_raw(object_id)
        tmp = path + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        self.delete_segment(object_id)
        _note_spill_io("spill", len(data), (time.monotonic() - t0) * 1e3)
        return path

    def restore(self, object_id: str, path: str) -> int:
        """Bring a spilled object back into a segment and remove the spill
        file. If the segment already exists the object is resident: its
        bytes are left as they are."""
        t0 = time.monotonic()
        if self.exists(object_id):
            size = len(self.read_raw(object_id))
            if os.path.exists(path):
                os.remove(path)
            return size
        with open(path, "rb") as f:
            blob = f.read()
        size = self.put_raw(object_id, blob)
        os.remove(path)
        _note_spill_io("restore", size, (time.monotonic() - t0) * 1e3)
        return size
