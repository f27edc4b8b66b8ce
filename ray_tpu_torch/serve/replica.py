"""Replica actor wrapper (reference: serve/_private/replica.py).

Each replica is an async actor of the port's runtime hosting one instance
of the user's deployment class. Requests arrive as `handle_request` method
calls; the actor's asyncio loop gives intra-replica concurrency up to
max_ongoing_requests, and `@serve.batch` methods coalesce on that loop.

The class and its init arguments arrive as cloudpickle blobs (`serve.run`
pickles both in the driver) and are loaded here only: the controller that
spawns replicas never unpickles them, so it loads no torch however heavy a
deployment's arguments are (an `LLMConfig`, a state_dict).
"""

import dataclasses
import inspect
from typing import Optional


@dataclasses.dataclass
class ReplicaContext:
    """What serve.get_replica_context() returns inside a replica
    (ref: python/ray/serve/context.py ReplicaContext)."""
    app_name: str
    deployment: str
    replica_tag: str


_replica_context: Optional[ReplicaContext] = None


def get_replica_context() -> ReplicaContext:
    if _replica_context is None:
        raise RuntimeError(
            "get_replica_context() may only be called from within a "
            "deployment replica (ref: serve.get_replica_context)")
    return _replica_context


class Replica:
    def __init__(self, cls_blob_or_cls, init_args, init_kwargs,
                 user_config=None, context=None):
        import cloudpickle
        if context is not None:
            # set BEFORE the user's __init__ runs so the constructor can
            # already ask who it is
            global _replica_context
            _replica_context = ReplicaContext(*context)
        cls = (cloudpickle.loads(cls_blob_or_cls)
               if isinstance(cls_blob_or_cls, bytes) else cls_blob_or_cls)
        if isinstance(init_args, bytes):
            init_args = cloudpickle.loads(init_args)
        if isinstance(init_kwargs, bytes):
            init_kwargs = cloudpickle.loads(init_kwargs)
        if inspect.isclass(cls):
            self.instance = cls(*init_args, **init_kwargs)
        else:
            # function deployment: calls go to __call__
            self.instance = _FnWrapper(cls)
        self._ongoing = 0
        self._total = 0
        if user_config is not None:
            self.reconfigure(user_config)

    def reconfigure(self, user_config):
        fn = getattr(self.instance, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    @staticmethod
    def _set_request_context(kwargs):
        model_id = kwargs.pop("_rtpu_multiplexed_model_id", None)
        if model_id is not None:
            from .multiplex import _set_current_model_id
            _set_current_model_id(model_id)
        return kwargs

    async def handle_request(self, method_name, *args, **kwargs):
        self._ongoing += 1
        self._total += 1
        try:
            kwargs = self._set_request_context(kwargs)
            fn = getattr(self.instance, method_name)
            out = fn(*args, **kwargs)
            if inspect.iscoroutine(out):
                out = await out
            return out
        finally:
            self._ongoing -= 1

    async def handle_request_streaming(self, method_name, *args, **kwargs):
        """Generator methods: yield items (streams via ObjectRefGenerator)."""
        self._ongoing += 1
        self._total += 1
        try:
            kwargs = self._set_request_context(kwargs)
            fn = getattr(self.instance, method_name)
            out = fn(*args, **kwargs)
            if inspect.isasyncgen(out):
                async for item in out:
                    yield item
            else:
                for item in out:
                    yield item
        finally:
            self._ongoing -= 1

    def stats(self):
        """Replica-state frame the controller polls each autoscale interval
        and the handle refresh rides on: ongoing/total plus —
        when the hosted deployment exposes them — the hot-prefix digest for
        affinity routing and the windowed SLO snapshot for scale decisions.
        Both piggyback on this existing frame; no new request-path round
        trips. `pid` lets chaos tooling hard-kill one replica's process."""
        import os
        s = {"ongoing": self._ongoing, "total": self._total,
             "pid": os.getpid()}
        digest_fn = getattr(self.instance, "prefix_digest", None)
        if callable(digest_fn):
            try:
                d = digest_fn()
                if d:
                    s["prefix_digest"] = d
            except Exception:  # noqa: BLE001 - routing hints are best-effort
                pass
        slo_fn = getattr(self.instance, "slo_snapshot", None)
        if callable(slo_fn):
            try:
                s["slo"] = slo_fn()
            except Exception:  # noqa: BLE001
                pass
        return s

    def health_check(self):
        fn = getattr(self.instance, "check_health", None)
        if fn is not None:
            fn()
        return True


class _FnWrapper:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, *a, **k):
        return self._fn(*a, **k)
