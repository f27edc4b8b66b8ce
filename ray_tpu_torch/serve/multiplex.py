"""Model multiplexing (reference: python/ray/serve/multiplex.py:22
_ModelMultiplexWrapper + serve/api.py:926 @serve.multiplexed).

One replica serves MANY models: the decorated loader is called per
`model_id` and its results are LRU-cached (`max_num_models_per_replica`).
Requests carry their model id via
`handle.options(multiplexed_model_id=...)` (or the
`serve_multiplexed_model_id` HTTP header through the proxy), and the
deployment reads it with `serve.get_multiplexed_model_id()`.

Routing contrast with the reference: the reference's router tracks which
replicas hold which models cluster-wide; here each handle keeps model→
replica affinity locally (sticky after first use), which converges to the
same behavior without controller chatter on the request path.
"""

import asyncio
import collections
import contextvars
import functools
from typing import Any, Callable, Optional

_current_model_id: contextvars.ContextVar = contextvars.ContextVar(
    "rtpu_serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """The model id of the request being handled (ref:
    serve.get_multiplexed_model_id); "" outside a multiplexed request."""
    return _current_model_id.get()


def _set_current_model_id(model_id: str):
    _current_model_id.set(model_id)


class _ModelCache:
    """Per-replica LRU of loaded models; eviction calls the model's
    `unload()`/`__del__` like the reference's wrapper.

    In-use protection: every get_model takes a LEASE bound to
    the calling asyncio task (the replica runs one task per request), and
    eviction skips models with live leases — a long request on model A no
    longer has A's device memory unloaded underneath it when other models
    load concurrently (the reference wrapper keeps per-model in-use counts
    the same way). If every cached model is leased, the cache temporarily
    overflows and re-enforces the cap as leases drain."""

    def __init__(self, loader: Callable, max_models: int):
        self.loader = loader
        self.max_models = max_models
        self.models: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._loading: dict = {}  # model_id -> asyncio.Future
        self.in_use: collections.Counter = collections.Counter()

    def _lease(self, model_id: str):
        """Pin `model_id` until the calling request task finishes."""
        task = asyncio.current_task()
        if task is None:
            return
        self.in_use[model_id] += 1

        def _release(_t, mid=model_id):
            self.in_use[mid] -= 1
            if self.in_use[mid] <= 0:
                del self.in_use[mid]
                if len(self.models) > self.max_models:
                    # cap was overflowed while every model was leased; trim
                    # back to EXACTLY max_models (limit=max+1: _evict_to
                    # stops at len < limit — passing max here would land at
                    # max-1 and near-simultaneous releases could empty the
                    # cache entirely)
                    asyncio.get_running_loop().create_task(
                        self._evict_to(self.max_models + 1))

        task.add_done_callback(_release)

    async def _evict_to(self, limit: int):
        # LRU order, but never unload a model a live request still uses
        while len(self.models) >= limit:
            victim = next((mid for mid in self.models
                           if not self.in_use.get(mid)), None)
            if victim is None:
                return  # all leased: allow temporary overflow
            old = self.models.pop(victim)
            unload = getattr(old, "unload", None)
            if callable(unload):
                maybe = unload()
                if asyncio.iscoroutine(maybe):
                    await maybe
            del old

    async def get_model(self, owner, model_id: str):
        model = await self._get_or_load(owner, model_id)
        self._lease(model_id)
        return model

    async def _get_or_load(self, owner, model_id: str):
        if model_id in self.models:
            self.models.move_to_end(model_id)
            return self.models[model_id]
        fut = self._loading.get(model_id)
        if fut is not None:  # concurrent request for the same model: share
            return await fut
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._loading[model_id] = fut
        try:
            # evict BEFORE loading: if max_models models fill the device,
            # holding N+1 during the load would OOM exactly when the cap is
            # sized to the hardware
            await self._evict_to(self.max_models)
            out = self.loader(owner, model_id)
            if asyncio.iscoroutine(out):
                out = await out
            # concurrent loads of DISTINCT models can each pass the first
            # eviction check; re-enforce the cap before inserting
            await self._evict_to(self.max_models)
            self.models[model_id] = out
            fut.set_result(out)
            return out
        except BaseException as e:  # noqa: BLE001 - propagate to all waiters
            fut.set_exception(e)
            raise
        finally:
            self._loading.pop(model_id, None)


def should_rebalance_pin(inflight_by_idx, pinned_idx: int,
                         factor: float = 2.0, min_inflight: int = 2) -> bool:
    """Evict a model->replica pin when the pinned replica's handle-local
    inflight exceeds `factor`x the fleet median (a sticky pin that never
    rebalances lets one hot LoRA pin its replica into the ground while the
    rest of the fleet idles).

    median_low, not the interpolated median: with two replicas the
    interpolated median of [hot, idle] is (hot+idle)/2, and hot > 2*that
    is algebraically impossible — the smallest fleet could never rebalance.
    `min_inflight` keeps single-digit blips from flapping pins."""
    import statistics
    n = len(inflight_by_idx)
    if n < 2 or pinned_idx >= n:
        return False
    q = inflight_by_idx[pinned_idx]
    if q < min_inflight:
        return False
    return q > factor * statistics.median_low(inflight_by_idx)


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for the model-loading method of a deployment:

        @serve.deployment
        class Translator:
            @serve.multiplexed(max_num_models_per_replica=4)
            async def get_model(self, model_id: str):
                return load_weights(model_id)

            async def __call__(self, request):
                model = await self.get_model(serve.get_multiplexed_model_id())
                return model(request.body)
    """
    def wrap(loader: Callable):
        cache = _ModelCache(loader, max_num_models_per_replica)

        @functools.wraps(loader)
        async def inner(self, model_id: str):
            return await cache.get_model(self, model_id)

        inner.__rtpu_multiplexed__ = cache
        return inner

    if func is not None:
        return wrap(func)
    return wrap
