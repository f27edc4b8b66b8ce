"""DeploymentHandle + router (reference: serve/handle.py and
serve/_private/router.py "power of two choices" replica scheduler).

A handle is cheap, pickleable (rebinds to replicas by name via the serve
controller actor), and routes each `.remote()` with p2c: sample two replicas,
send to the one with fewer requests this handle has in flight.

Fleet routing: when replicas publish prefix-affinity digests
(hot radix-cache chains, cached controller-side off the existing stats
refresh), requests that carry token ids are scored by deepest matched
prefix and routed to the replica already holding those KV pages — falling
back to p2c on a miss or when the affinity target's queue is too deep
(spill guard: a hot prefix must not hotspot one replica).
`RAY_TPU_PREFIX_AFFINITY=0` turns the whole thing off. A request whose
replica died mid-flight force-refreshes the replica set and retries once
on a survivor instead of erroring.
"""

import random
import threading
from typing import Any, Dict, List, Optional

from . import prefix_digest as _pd


def _count(name: str):
    try:
        from ray_tpu_torch.util import metrics
        metrics.get_or_create(metrics.Counter, name,
                              "serve fleet routing tally").inc()
    except Exception:  # noqa: BLE001 - routing never breaks on accounting
        pass


def _token_seq(x):
    """Token ids if `x` looks like a prompt (1-D int sequence/array), else
    None — how the router finds a prefix key in positional args without an
    explicit `_rtpu_prefix_tokens=` hint."""
    try:
        if hasattr(x, "dtype"):
            if getattr(x.dtype, "kind", "") in "iu" and \
                    getattr(x, "ndim", 0) == 1 and len(x) > 0:
                return x
            return None
        if isinstance(x, (list, tuple)) and x:
            x0 = x[0]
            if isinstance(x0, bool) or not hasattr(x0, "__index__"):
                return None
            return x
    except Exception:  # noqa: BLE001
        return None
    return None


class DeploymentResponse:
    """Future for one request (reference: serve.handle.DeploymentResponse).

    `cancel()` propagates to the replica: a running async method gets
    asyncio-cancelled, freeing its in-flight slot (ref: serve request
    cancellation). A handle-level `timeout_s` auto-cancels on expiry.
    `retry` (set by the handle for unary requests) re-submits once to a
    surviving replica when the original one died mid-flight; with none
    left, the error names the death (a replica that failed its
    construction, such as an engine on a card it does not hold, fails the
    request with that error)."""

    def __init__(self, ref, timeout_s: Optional[float] = None, retry=None):
        self._ref = ref
        self._timeout_s = timeout_s
        self._retry = retry

    def _retry_once(self, died):
        """Consume the one retry: returns True if the ref was replaced."""
        retry, self._retry = self._retry, None
        if retry is None:
            return False
        self._ref = retry(died)
        return True

    def result(self, timeout_s: Optional[float] = None):
        import ray_tpu_torch as rt
        timeout = timeout_s if timeout_s is not None else self._timeout_s
        while True:
            try:
                return rt.get(self._ref, timeout=timeout)
            except rt.exceptions.GetTimeoutError:
                if timeout_s is None and self._timeout_s is not None:
                    # handle-configured deadline: the request is abandoned,
                    # so stop the replica-side work too
                    self.cancel()
                    raise TimeoutError(
                        f"request timed out after {self._timeout_s}s "
                        f"(cancelled)") from None
                raise
            except rt.exceptions.ActorDiedError as died:
                if not self._retry_once(died):
                    raise

    def cancel(self):
        import ray_tpu_torch as rt
        rt.cancel(self._ref)

    async def _await_with_deadline(self):
        import asyncio
        try:
            return await asyncio.wait_for(self._await_ref(), self._timeout_s)
        except asyncio.TimeoutError:
            self.cancel()
            raise TimeoutError(f"request timed out after {self._timeout_s}s "
                               f"(cancelled)") from None

    async def _await_ref(self):
        import ray_tpu_torch as rt
        while True:
            try:
                return await self._ref
            except rt.exceptions.ActorDiedError as died:
                if not self._retry_once(died):
                    raise

    def __await__(self):
        if self._timeout_s is not None:
            return self._await_with_deadline().__await__()
        return self._await_ref().__await__()

    @property
    def object_ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Streaming response: iterate results as the replica yields them.
    `on_finish` runs exactly once when the stream ends (exhausted, errored,
    or GC'd) — the handle uses it to decrement its in-flight counter."""

    def __init__(self, gen, on_finish=None):
        self._gen = gen
        self._on_finish = on_finish

    def _finish(self):
        cb, self._on_finish = self._on_finish, None
        if cb is not None:
            cb()

    def __iter__(self):
        import ray_tpu_torch as rt
        try:
            for ref in self._gen:
                yield rt.get(ref)
        finally:
            self._finish()

    async def __aiter__(self):
        import ray_tpu_torch as rt
        try:
            async for ref in self._gen:
                yield await ref
        finally:
            self._finish()

    def __del__(self):
        self._finish()


class _RouterState:
    """The routing state every handle derived from one (`options()`, the
    `handle.method` sugar) shares: the replica set with its version and
    refresh time, the in-flight counts, the digests and the multiplex pins.
    JAX's handles copy these fields at `options()` and rebind them at a
    refresh, so a derived handle's refresh never reached its parent: every
    `handle.method.remote()` refreshed again and routed p2c on zeroed
    counts, a uniform draw."""

    def __init__(self):
        self.replicas: List = []
        self.inflight: Dict[int, int] = {}
        # replica idx -> prefix-affinity digest, piggybacked on _refresh
        self.digests: Dict[int, dict] = {}
        # model id -> replica idx sticky affinity (multiplex routing: keep a
        # model's requests on the replica that already loaded it)
        self.model_affinity: Dict[str, int] = {}
        # reentrant: stream-generator __del__ fires the decrement callback,
        # and cyclic GC can run while this thread already holds the lock
        self.lock = threading.RLock()
        self.version = -1
        self.last_refresh = 0.0


def _shared(field: str):
    return property(lambda self: getattr(self._router, field),
                    lambda self, value: setattr(self._router, field, value))


class DeploymentHandle:
    _replicas = _shared("replicas")
    _inflight = _shared("inflight")
    _digests = _shared("digests")
    _model_affinity = _shared("model_affinity")
    _lock = _shared("lock")
    _version = _shared("version")
    _last_refresh = _shared("last_refresh")

    def __init__(self, deployment_name: str, app_name: str = "default",
                 method_name: str = "__call__", stream: bool = False,
                 multiplexed_model_id: str = "",
                 timeout_s: Optional[float] = None):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._method_name = method_name
        self._stream = stream
        self._multiplexed_model_id = multiplexed_model_id
        self._timeout_s = timeout_s
        self._router = _RouterState()

    # -- construction / refresh ---------------------------------------------
    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None,
                timeout_s: Optional[float] = None,
                **_compat) -> "DeploymentHandle":
        h = DeploymentHandle(
            self.deployment_name, self.app_name,
            method_name or self._method_name,
            self._stream if stream is None else stream,
            (self._multiplexed_model_id if multiplexed_model_id is None
             else multiplexed_model_id),
            self._timeout_s if timeout_s is None else timeout_s)
        h._router = self._router
        return h

    # bound per-request controller chatter; scale-ups are picked up within
    # this window
    _REFRESH_TTL_S = 0.5

    def _refresh(self, force: bool = False):
        import time
        if (self._replicas and not force
                and time.monotonic() - self._last_refresh < self._REFRESH_TTL_S):
            return
        from .controller import get_controller
        ctrl = get_controller()
        import ray_tpu_torch as rt
        # ONE round trip carries version + replicas + affinity digests (the
        # digests piggyback on this existing refresh — never per-request)
        state = rt.get(ctrl.get_replica_state.remote(
            self.app_name, self.deployment_name))
        if state["version"] != self._version or force:
            self._replicas = state["replicas"]
            self._version = state["version"]
            with self._lock:
                self._inflight = {i: 0 for i in range(len(self._replicas))}
        self._digests = state.get("digests") or {}
        self._last_refresh = time.monotonic()

    # -- routing -------------------------------------------------------------
    def _pick_replica(self, prefix_tokens=None) -> int:
        """Prefix-affinity scoring when the request carries token ids and
        replicas have published digests; power of two choices on this
        handle's in-flight counts otherwise."""
        n = len(self._replicas)
        if n == 1:
            return 0
        if (prefix_tokens is not None and self._digests
                and _pd.affinity_enabled()):
            idx = self._pick_by_prefix(prefix_tokens)
            if idx is not None:
                return idx
        with self._lock:
            a, b = random.sample(range(n), 2)
            return a if self._inflight.get(a, 0) <= self._inflight.get(b, 0) else b

    def _pick_by_prefix(self, prefix_tokens) -> Optional[int]:
        """Deepest-matched-prefix replica — deterministic given a fixed
        digest set (ties: fewer in-flight, then lower index). None (fall
        back to p2c) on no match, or when the winner's queue is more than
        the spill threshold deeper than the least-loaded replica's: a hot
        prefix spreads out instead of hotspotting its home replica."""
        scores = _pd.score_replicas(self._digests, prefix_tokens)
        n = len(self._replicas)
        with self._lock:
            best, best_key = None, (0,)
            for depth, idx in scores:
                if depth <= 0 or idx >= n:
                    continue
                key = (depth, -self._inflight.get(idx, 0), -idx)
                if key > best_key:
                    best, best_key = idx, key
            if best is None:
                _count("serve_affinity_misses_total")
                return None
            q = self._inflight.get(best, 0)
            q_min = min(self._inflight.get(i, 0) for i in range(n))
        if q - q_min > _pd.spill_threshold():
            _count("serve_affinity_spills_total")
            return None
        _count("serve_affinity_hits_total")
        return best

    def remote(self, *args, **kwargs):
        self._refresh()
        if not self._replicas:
            raise RuntimeError(
                f"deployment '{self.deployment_name}' has no replicas")
        prefix_tokens = kwargs.pop("_rtpu_prefix_tokens", None)
        if prefix_tokens is None and args:
            prefix_tokens = _token_seq(args[0])
        model_id = self._multiplexed_model_id
        if model_id:
            # sticky multiplex routing: the replica that loaded this model
            # keeps serving it (cache hit) until the replica set changes
            # or the pin overloads its replica (2x the fleet median —
            # evicting lets a second replica warm the model, and the
            # re-pick composes with prefix affinity instead of fighting it)
            with self._lock:
                idx = self._model_affinity.get(model_id)
                inflight_vec = [self._inflight.get(i, 0)
                                for i in range(len(self._replicas))]
            if idx is not None and idx < len(self._replicas):
                from .multiplex import should_rebalance_pin
                if should_rebalance_pin(inflight_vec, idx):
                    with self._lock:
                        self._model_affinity.pop(model_id, None)
                    _count("serve_mux_rebalances_total")
                    idx = None
            if idx is None or idx >= len(self._replicas):
                idx = self._pick_replica(prefix_tokens)
                with self._lock:
                    self._model_affinity[model_id] = idx
            kwargs = {**kwargs, "_rtpu_multiplexed_model_id": model_id}
        else:
            idx = self._pick_replica(prefix_tokens)
        return self._submit(idx, args, kwargs)

    def _submit(self, idx: int, args, kwargs):
        replica = self._replicas[idx]
        with self._lock:
            self._inflight[idx] = self._inflight.get(idx, 0) + 1

        def _done(_f, i=idx):
            with self._lock:
                self._inflight[i] = max(self._inflight.get(i, 1) - 1, 0)

        if self._stream:
            gen = replica.handle_request_streaming.options(
                num_returns="streaming").remote(self._method_name, *args, **kwargs)
            return DeploymentResponseGenerator(gen, on_finish=lambda: _done(None))
        ref = replica.handle_request.remote(self._method_name, *args, **kwargs)
        try:
            ref.future().add_done_callback(_done)
        except Exception:  # noqa: BLE001 - counter decay is best-effort
            pass
        return DeploymentResponse(
            ref, timeout_s=self._timeout_s,
            retry=lambda died, dead=replica: self._resubmit_after_death(
                dead, args, kwargs, died))

    def _resubmit_after_death(self, dead, args, kwargs, died=None):
        """ActorDiedError recovery: force-refresh the
        replica set — not just on empty-set — and re-submit to the least-
        loaded SURVIVOR. The controller may not have noticed the death yet,
        so the corpse is excluded explicitly by actor id, and multiplex
        pins pointing at it are evicted (they would re-route every request
        into the same dead actor)."""
        _count("serve_died_retries_total")
        dead_id = getattr(dead, "_actor_id", None)
        with self._lock:
            # evict corpse-pointing multiplex pins against the CURRENT list
            # — the refresh below renumbers indices (the controller prunes
            # the corpse), after which a stale pin index looks valid
            for mid, i in list(self._model_affinity.items()):
                if (i >= len(self._replicas) or getattr(
                        self._replicas[i], "_actor_id", None) == dead_id):
                    self._model_affinity.pop(mid, None)
        try:
            # tell the controller so the WHOLE fleet stops routing here
            # within one refresh interval (we exclude it locally below
            # either way — the report may race the refresh)
            import ray_tpu_torch as rt
            from .controller import get_controller
            rt.get(get_controller().report_replica_death.remote(
                self.app_name, self.deployment_name, dead_id), timeout=5)
        except Exception:  # noqa: BLE001 - pruning is best-effort
            pass
        self._refresh(force=True)
        alive = [i for i, r in enumerate(self._replicas)
                 if getattr(r, "_actor_id", None) != dead_id]
        if not alive:
            raise RuntimeError(
                f"deployment '{self.deployment_name}' has no surviving "
                f"replicas; the last one died: {died}") from died
        with self._lock:
            for mid, i in list(self._model_affinity.items()):
                if (i >= len(self._replicas) or getattr(
                        self._replicas[i], "_actor_id", None) == dead_id):
                    self._model_affinity.pop(mid, None)
            idx = min(alive, key=lambda i: self._inflight.get(i, 0))
            self._inflight[idx] = self._inflight.get(idx, 0) + 1

        def _done(_f, i=idx):
            with self._lock:
                self._inflight[i] = max(self._inflight.get(i, 1) - 1, 0)

        ref = self._replicas[idx].handle_request.remote(
            self._method_name, *args, **kwargs)
        try:
            ref.future().add_done_callback(_done)
        except Exception:  # noqa: BLE001
            pass
        return ref

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return self.options(method_name=item)

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name, self.app_name,
                                   self._method_name, self._stream,
                                   self._multiplexed_model_id,
                                   self._timeout_s))
