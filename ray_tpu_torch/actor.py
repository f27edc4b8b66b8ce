"""Actor API (reference: python/ray/actor.py — ActorClass / ActorHandle /
ActorMethod).

An actor is a dedicated worker process holding instance state; method calls
are ordered per-actor (FIFO) up to `max_concurrency`. Handles are pickleable
and can be passed into tasks/other actors.
"""

import cloudpickle

from ._private import ids, serialization, state
from ._private.object_ref import ObjectRef, ObjectRefGenerator
from ._private.task_spec import ActorCreationOptions, TaskSpec
from .remote_function import encode_call, _normalize_resources


def method(**options):
    """Decorator for actor methods: @method(num_returns=2) (ref:
    python/ray/actor.py:method)."""

    def decorate(fn):
        fn.__rtpu_method_options__ = options
        return fn

    return decorate


def exit_actor():
    """Terminate the current actor gracefully (ref: ray.actor.exit_actor)."""
    from .exceptions import _ActorExit
    raise _ActorExit()


class ActorMethod:
    def __init__(self, handle, name, num_returns=1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, **overrides):
        return ActorMethod(self._handle, self._name,
                           overrides.get("num_returns", self._num_returns))

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs, self._num_returns)

    def bind(self, *args, **kwargs):
        """DAG-build spelling (reference: actor.method.bind in ray.dag):
        returns a ClassMethodNode for `ray_tpu_torch.dag` graphs."""
        from .dag import ClassMethodNode
        return ClassMethodNode(self._handle, self._name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"Actor method '{self._name}' must be called with .remote().")


def _reconstruct_handle(actor_id, method_meta, name):
    """Deserialization path: the new handle owns a fresh controller-side ref
    (ref: Ray's handle refcounting — each deserialized copy registers as a
    borrower, reference_count.cc). The serialized bytes' own hold rides the
    contained-id lists (see __reduce__), so the actor can't die in transit."""
    client = state.global_client_or_none()
    if client is not None:
        client.actor_incref(actor_id)
    return ActorHandle(actor_id, method_meta, name=name)


class ActorHandle:
    """A reference to a live actor. Every constructed handle owns one
    controller-side `handle_refs` count, released in __del__; when the count
    hits zero an anonymous (unnamed, non-detached) actor is garbage-collected
    and its worker process reclaimed (ref: python/ray/actor.py ActorHandle +
    gcs_actor_manager.cc OnActorOutOfScope)."""

    def __init__(self, actor_id, method_meta, name=""):
        self._actor_id = actor_id
        self._method_meta = method_meta  # {name: {"num_returns": n}}
        self._name = name

    def __getattr__(self, item):
        meta = self._method_meta.get(item)
        if meta is None:
            raise AttributeError(f"Actor has no method '{item}'")
        return ActorMethod(self, item, meta.get("num_returns", 1))

    def _invoke(self, method_name, args, kwargs, num_returns):
        client = state.global_client()
        eargs, ekwargs, nested, holds = encode_call(args, kwargs)
        spec = TaskSpec(
            task_id=ids.task_id(),
            fn_blob=None,
            args=eargs,
            kwargs=ekwargs,
            nested_refs=nested,
            num_returns=num_returns,
            resources={},
            max_retries=0,
            name=f"{self._name or self._actor_id}.{method_name}",
            actor_id=self._actor_id,
            method_name=method_name,
            job_id=client.job_id,
        )
        if client._owned is not None and (eargs or ekwargs):
            # owned ref args carry their inline descriptors inside the spec
            # (the spec producer attaches them — client.submit no longer does)
            client._attach_owned_args(spec)
        oids = client.submit(spec)
        if num_returns == "streaming":
            return ObjectRefGenerator(spec.task_id)
        refs = [ObjectRef(oid, owned=True) for oid in oids]
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        # record the handle in the active serialization's contained-id list
        # (prefix-dispatched next to nested ObjectRefs): the containing
        # object/task pins the actor until the bytes are consumed
        serialization.note_contained_ref(self._actor_id)
        return (_reconstruct_handle, (self._actor_id, self._method_meta, self._name))

    def __del__(self):
        try:
            client = state.global_client_or_none()
            if client is not None:
                client.actor_decref(self._actor_id)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __repr__(self):
        return f"ActorHandle({self._actor_id})"


class ActorClass:
    def __init__(self, cls, **options):
        self._cls = cls
        self._options = options
        self._blob = None
        self._captured = []  # ref ids in the class blob; held for our lifetime
        self.__name__ = getattr(cls, "__name__", "Actor")

    def options(self, **overrides):
        merged = {**self._options, **overrides}
        ac = ActorClass(self._cls, **merged)
        ac._blob = self._blob
        ac._hold_captured(self._captured)  # its own holds, for its own __del__
        return ac

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

    def __call__(self, *a, **k):
        raise TypeError(f"Actor class '{self.__name__}' cannot be instantiated "
                        f"directly; use '{self.__name__}.remote()'.")

    def _method_meta(self):
        meta = {}
        for attr in dir(self._cls):
            if attr.startswith("__"):
                continue
            fn = getattr(self._cls, attr, None)
            if callable(fn):
                opts = getattr(fn, "__rtpu_method_options__", {})
                meta[attr] = {"num_returns": opts.get("num_returns", 1)}
        return meta

    def remote(self, *args, **kwargs):
        client = state.global_client()
        opts = self._options
        if self._blob is None:
            # class blobs can capture ObjectRefs in globals/defaults — hold a
            # refcount for this ActorClass's lifetime (released in __del__)
            self._blob, captured = serialization.dumps_with_refs(self._cls)
            self._hold_captured(captured)
        # actors default to holding 0 CPUs while alive (ref: ray defaults —
        # 1 CPU for placement, 0 for running); explicit num_cpus is held.
        res = _normalize_resources({**opts, "num_cpus": opts.get("num_cpus", 0)})
        actor_id = ids.actor_id()
        creation = TaskSpec(
            task_id=ids.task_id(),
            fn_blob=self._blob,
            num_returns=1,
            resources=res,
            max_retries=0,
            name=f"{self.__name__}.__init__",
            actor_id=actor_id,
            is_actor_creation=True,
            # per-submission copy (see remote_function.py: env-key memo)
            runtime_env=dict(opts["runtime_env"]) if opts.get("runtime_env") else None,
            job_id=client.job_id,
        )
        eargs, ekwargs, nested, holds = encode_call(args, kwargs)
        creation.args, creation.kwargs = eargs, ekwargs
        creation.nested_refs = nested
        # placement: NodeAffinity/SPREAD ride the spec; PG strategies set the
        # bundle fields (same plumbing as remote_function.py)
        creation.scheduling_strategy = opts.get("scheduling_strategy")
        from .remote_function import _apply_scheduling_strategy
        _apply_scheduling_strategy(creation, opts.get("scheduling_strategy"))
        acopts = ActorCreationOptions(
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            name=opts.get("name"),
            namespace=opts.get("namespace") or getattr(client, "namespace", None),
            lifetime=opts.get("lifetime"),
            resources=res,
        )
        client.register_actor(creation, acopts)
        if client._owned is not None and (eargs or ekwargs):
            client._attach_owned_args(creation)
        client.submit(creation)
        return ActorHandle(actor_id, self._method_meta(), name=opts.get("name") or "")
