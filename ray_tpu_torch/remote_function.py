"""RemoteFunction — the `@ray_tpu_torch.remote` task wrapper.

Reference: python/ray/remote_function.py. `.remote()` builds a TaskSpec and
submits; `.options()` returns a shallow override wrapper, same semantics.
"""

import dataclasses
import pickle

import cloudpickle

from ._private import client as _client_mod
from ._private import ids, serialization, state
from ._private.object_ref import ObjectRef, ObjectRefGenerator
from ._private.task_spec import TaskSpec
from .util import tracing

_DEFAULT_TASK_CPUS = 1.0

# Field-name -> default for every TaskSpec field, derived from the dataclass
# so new fields can't drift out of sync. `.remote()` builds specs via
# TaskSpec.__new__ + a dict copied from this template instead of the
# generated __init__ (24 keyword args + default_factory calls per task) —
# ~0.5 µs/submit on the pipelined hot path. Fields with a default_factory
# get None here; every current one (args/kwargs/resources/nested_refs) is
# overwritten per call below — a future factory field must be too.
_SPEC_DEFAULTS = {
    f.name: (f.default if f.default is not dataclasses.MISSING else None)
    for f in dataclasses.fields(TaskSpec)
}


def _normalize_resources(opts) -> dict:
    res = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    res["CPU"] = _DEFAULT_TASK_CPUS if num_cpus is None else float(num_cpus)
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    return {k: v for k, v in res.items() if v}


# Args whose serialized form exceeds this are implicitly put() and passed
# by ref (reference parity: ray puts args >100KB into the object store,
# _private/worker.py). The payload then crosses process boundaries through
# the shm arena once, zero-copy on the consumer, instead of riding the
# controller socket twice per hop — the fix for HostGroup collectives'
# mailbox copies and every other large-arg path.
_IMPLICIT_PUT_BYTES = 100 * 1024

# set-membership beats tuple scan on the per-arg fast path below
_SCALAR_SET = frozenset(serialization._SCALAR_TYPES)

# shared by every fast-path spec (read-only by contract — see remote())
_EMPTY_KWARGS: dict = {}
_EMPTY_REFS: list = []

# serialization.pack_scalar with its two calls pre-bound: the fast arg loop
# inlines the body (pickle + one fused header pack) to shed a call frame
_dumps = pickle.dumps
_hdr_pack = serialization._SCALAR_HDR.pack

# single-return pipelined submits skip client.submit() and use the client's
# precomputed fast lane directly (see BaseClient._lane); inherited-trace
# bookkeeping is the one piece of submit() the lane branch still needs
_note_ref_trace = _client_mod._note_ref_trace

# ids.task_id() inlined on the hot path: the counter object is stable across
# forks (only the token/format refresh — _refresh_token clears, never
# rebinds, the cache dict), so both bindings stay valid in children
_next_id = ids._counter.__next__
_id_fmts = ids._fmt_cache

# ObjectRef construction without the __init__ frame (slots: id, _owned)
_ref_new = object.__new__


def encode_arg(value, nested, holds=None):
    if isinstance(value, ObjectRef):
        return ("ref", value.id)
    meta, buffers, contained = serialization.dumps_oob(value)
    # inlined total_size: scalars (the common case) have no oob buffers
    size = len(meta) + (sum(b.nbytes for b in buffers) if buffers else 0)
    if holds is not None and size > _IMPLICIT_PUT_BYTES:
        client = state.global_client_or_none()
        if client is not None:
            # reuse the serialization that sized the arg — no second encode
            oid = client.put_serialized(meta, buffers, contained)
            # `holds` keeps the creation ref alive until submit() has pinned
            # the arg; its GC decref then hands lifetime to the task's pin
            holds.append(ObjectRef(oid, owned=True))
            return ("ref", oid)
    nested.extend(contained)
    return ("v", serialization.pack_parts(meta, buffers))


def encode_call(args, kwargs):
    """Returns (args, kwargs, nested_ref_ids, holds) — nested ids are refs
    buried inside inline values (e.g. f.remote([ref])); the controller pins
    them for the task's lifetime so caller-side GC can't evict them
    pre-deserialize. `holds` carries implicitly-put large args: the caller
    must keep it alive until after client.submit()."""
    nested = []
    holds = []
    eargs = [encode_arg(a, nested, holds) for a in args]
    ekwargs = {k: encode_arg(v, nested, holds)
               for k, v in (kwargs or {}).items()}
    return eargs, ekwargs, nested, holds


class RemoteFunction:
    def __init__(self, fn, **options):
        self._fn = fn
        self._options = options
        self._blob = None
        self._captured = []  # ref ids in the fn blob; held for our lifetime
        self.__name__ = getattr(fn, "__name__", "remote_fn")
        self.__doc__ = getattr(fn, "__doc__", None)
        # Options are immutable per wrapper (.options() builds a new one), so
        # everything derivable from them is computed once here instead of per
        # .remote() — resource normalization alone was ~35µs of an ~70µs
        # submit hot path. `resources` is copied per spec below because the
        # scheduler memoizes into it.
        self._resources = _normalize_resources(options)
        self._num_returns = options.get("num_returns", 1)
        self._max_retries = options.get("max_retries", 3)
        self._retry_exceptions = bool(options.get("retry_exceptions", False))
        self._name = options.get("name") or self.__name__
        self._strategy = options.get("scheduling_strategy")
        self._runtime_env = options.get("runtime_env") or None
        # per-wrapper spec template: all static fields resolved once; remote()
        # copies it and fills the per-call slots (see _SPEC_DEFAULTS). The
        # blob and job_id are backfilled into the template lazily (first
        # call) so the fast path carries them via the copy, store-free; the
        # shared empty kwargs/nested_refs are read-only by contract.
        self._client = None  # owner of the cached job_id below
        self._spec_base = dict(
            _SPEC_DEFAULTS,
            num_returns=self._num_returns,
            max_retries=self._max_retries,
            retry_exceptions=self._retry_exceptions,
            name=self._name,
            scheduling_strategy=self._strategy,
            kwargs=_EMPTY_KWARGS,
            nested_refs=_EMPTY_REFS,
            # shared across this wrapper's specs: every consumer of
            # spec.resources is read-only (feasibility checks, sig
            # registration snapshots items(), codec/pickle copy on the way
            # to other processes) — same contract as the empty sentinels
            resources=self._resources,
        )

    def _get_blob(self):
        if self._blob is None:
            # Refs captured in the closure/globals live only as ids inside the
            # blob once the driver drops its handles — hold a refcount for the
            # lifetime of this RemoteFunction (released in __del__).
            self._blob, captured = serialization.dumps_with_refs(self._fn)
            self._hold_captured(captured)
        self._spec_base["fn_blob"] = self._blob
        return self._blob

    def _hold_captured(self, ids_):
        client = state.global_client_or_none()
        if client is not None:
            for oid in ids_:
                client.incref(oid)
            self._captured = list(ids_)

    def __del__(self):
        try:
            client = state.global_client_or_none()
            if client is not None:
                for oid in self._captured:
                    client.decref(oid)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self.__name__}' cannot be called directly; use "
            f"'{self.__name__}.remote()'.")

    def bind(self, *args, **kwargs):
        """DAG-build spelling (reference: task .bind in ray.dag — the node
        type `ray_tpu_torch.workflow` runs durably)."""
        from .dag import FunctionNode
        return FunctionNode(self, args, kwargs)

    def options(self, **overrides):
        merged = {**self._options, **overrides}
        rf = RemoteFunction(self._fn, **merged)
        rf._blob = self._blob
        if self._blob is not None:
            rf._spec_base["fn_blob"] = self._blob
        rf._hold_captured(self._captured)  # its own holds, for its own __del__
        return rf

    def remote(self, *args, **kwargs):
        client = state._client
        if client is None:
            client = state.global_client()  # raises the not-initialized error
        base = self._spec_base
        if client is not self._client:
            # first call (or re-init): backfill the template's client-derived
            # and lazily-built fields so steady-state calls skip the stores
            base["job_id"] = client.job_id
            if self._blob is None:
                self._get_blob()  # fills base["fn_blob"]
            self._client = client
        num_returns = self._num_returns
        # Fast arg loop: exact-type scalars and top-level refs (the dominant
        # shapes) encode inline with no cloudpickle machinery, no nested-ref
        # collection, and one allocation per value; owned ref args pick up
        # their inline descriptors here (spec.owned_inline) so the spec
        # stays self-contained across forwarding. Anything else — kwargs,
        # containers, oversized scalars that should be implicitly put —
        # falls through to the generic encode_call.
        eargs = [] if not kwargs else None
        owned_inline = None
        holds = None
        if eargs is not None:
            owned_tbl = client._owned
            for a in args:
                ta = type(a)
                if ta in _SCALAR_SET:
                    p = _dumps(a, 5)
                    np_ = len(p)
                    if np_ > _IMPLICIT_PUT_BYTES:
                        eargs = None  # big str/bytes: generic path puts it
                        break
                    eargs.append(("v", _hdr_pack(np_ + 4, np_) + p))
                elif ta is ObjectRef:
                    v = a.id
                    eargs.append(("ref", v))
                    if owned_tbl is not None:
                        parts = owned_tbl.inline_parts(v)
                        if parts is not None:
                            if owned_inline is None:
                                owned_inline = {}
                            owned_inline[v] = parts
                else:
                    eargs = None
                    break
        # spec built from the per-wrapper template (see _SPEC_DEFAULTS):
        # __new__ + one dict copy replaces the 24-arg generated __init__
        d = base.copy()
        # ids.task_id() inlined (see _next_id/_id_fmts above)
        n = _next_id()
        fmt = _id_fmts.get("task")
        if fmt is None:
            fmt = _id_fmts["task"] = "task-%06d-" + ids._token + "%08x"
        d["task_id"] = tid = fmt % (n, n & 0xFFFFFFFF)
        d["args"] = eargs
        if owned_inline is not None:
            d["owned_inline"] = owned_inline
        if eargs is None:
            eargs, ekwargs, nested, holds = encode_call(args, kwargs)
            d["args"] = eargs
            d["kwargs"] = ekwargs
            d["nested_refs"] = nested
        if self._runtime_env:
            d["runtime_env"] = dict(self._runtime_env)
        lane = client._lane if num_returns == 1 else None
        if lane is not None:
            # Pipelined single-return fast lane: the nr==1 arm of
            # client.submit() AND tracing.stamp unrolled into template-dict
            # writes before the spec exists — no call chain, no post-hoc
            # attribute stores. Must mirror both (tracing.py notes this copy).
            owner, append_entry, owned_entries = lane
            inherited = None
            if tracing._enabled:
                t = tracing._ctx.trace
                tt = t[0]
                if tt is None:
                    s = tracing._sample
                    if s >= 1.0:
                        d["trace_id"] = tid
                    elif s > 0.0:
                        d["trace_id"] = tracing.trace_id_for(tid)
                else:
                    d["trace_id"] = tt
                    d["parent_span_id"] = t[1]
                    inherited = tt
            oid = "obj-" + tid + "-ret0"
            if owner is not None:
                d["owner_id"] = owner
                owned_entries[oid] = [None, None, 1, None]
        spec = TaskSpec.__new__(TaskSpec)
        spec.__dict__ = d
        if holds is not None and client._owned is not None and (
                spec.args or spec.kwargs):
            # generic path: attach inline descriptors for owned ref args
            # found by encode_call (the fast loop attaches its own above)
            client._attach_owned_args(spec)
        if self._strategy is not None:
            _apply_scheduling_strategy(spec, self._strategy)
        if lane is not None:
            # `holds` (large implicitly-put args) stays alive until this
            # frame returns, i.e. past the append
            append_entry(("submit", spec, [oid]))
            if inherited is not None:
                _note_ref_trace(oid, inherited)
            ref = _ref_new(ObjectRef)
            ref.id = oid
            ref._owned = True
            return ref
        oids = client.submit(spec)
        del holds  # large implicitly-put args stay alive through submit()
        if num_returns == "streaming":
            return ObjectRefGenerator(spec.task_id)
        if num_returns == 1:
            return ObjectRef(oids[0], True)
        return [ObjectRef(oid, True) for oid in oids]


_PGStrategy = None  # resolved lazily: util.scheduling_strategies imports us


def _apply_scheduling_strategy(spec: TaskSpec, strategy):
    # PlacementGroupSchedulingStrategy → bundle reservation accounting
    global _PGStrategy
    if _PGStrategy is None:
        from .util.scheduling_strategies import PlacementGroupSchedulingStrategy
        _PGStrategy = PlacementGroupSchedulingStrategy
    if isinstance(strategy, _PGStrategy) and strategy.placement_group:
        spec.placement_group_id = strategy.placement_group.id
        spec.placement_group_bundle_index = strategy.placement_group_bundle_index or 0
