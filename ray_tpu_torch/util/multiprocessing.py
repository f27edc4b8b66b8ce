"""multiprocessing.Pool-compatible Pool over tasks (reference:
python/ray/util/multiprocessing/pool.py), on the port's tasks.
"""

from typing import Iterable, Optional


class AsyncResult:
    def __init__(self, refs, single: bool = False):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch as rt
        out = rt.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None):
        import ray_tpu_torch as rt
        rt.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        import ray_tpu_torch as rt
        ready, _ = rt.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:  # noqa: BLE001
            return False


class Pool:
    """Process pool on the task scheduler; `processes` caps concurrency by
    fractional-CPU tagging rather than pre-spawning dedicated workers."""

    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=(), **_compat):
        import ray_tpu_torch as rt
        if not rt.is_initialized():
            rt.init()
        self._processes = processes
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False

    def _remote(self, fn):
        import ray_tpu_torch as rt
        init, initargs = self._initializer, self._initargs

        def call(*a, **k):
            if init is not None and not getattr(call, "_inited", False):
                init(*initargs)
                call._inited = True
            return fn(*a, **k)

        return rt.remote(call)

    def apply(self, fn, args=(), kwds=None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args=(), kwds=None) -> AsyncResult:
        self._check_open()
        ref = self._remote(fn).remote(*args, **(kwds or {}))
        return AsyncResult([ref], single=True)

    def map(self, fn, iterable: Iterable, chunksize: Optional[int] = None):
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        self._check_open()
        rfn = self._remote(fn)
        return AsyncResult([rfn.remote(x) for x in iterable])

    def starmap(self, fn, iterable: Iterable):
        self._check_open()
        rfn = self._remote(fn)
        return AsyncResult([rfn.remote(*args) for args in iterable]).get()

    def imap(self, fn, iterable, chunksize: Optional[int] = None):
        import ray_tpu_torch as rt
        self._check_open()
        rfn = self._remote(fn)
        refs = [rfn.remote(x) for x in iterable]
        for r in refs:
            yield rt.get(r)

    def imap_unordered(self, fn, iterable, chunksize: Optional[int] = None):
        import ray_tpu_torch as rt
        self._check_open()
        rfn = self._remote(fn)
        refs = [rfn.remote(x) for x in iterable]
        while refs:
            ready, refs = rt.wait(refs, num_returns=1)
            yield rt.get(ready[0])

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        pass

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool is closed")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.terminate()
