"""Serialization debugging (reference: python/ray/util/check_serialize.py
`inspect_serializability`); the port's own copy of the JAX package's.

Walks a function's closure/globals or an object's attributes to pinpoint
WHICH member fails cloudpickle — the error a user otherwise gets is an
opaque "cannot pickle X" raised from deep inside a remote call. Same
recursive-frame design as the reference, minus colorama (plain text)."""

import inspect
from typing import Any, Optional, Set, Tuple

import cloudpickle

__all__ = ["inspect_serializability", "FailureTuple"]


class FailureTuple:
    """One serialization failure frame: `name` (variable name), `obj`
    (the failing object), `parent` (the container that references it)."""

    def __init__(self, obj: Any, name: str, parent: Any):
        self.obj = obj
        self.name = name
        self.parent = parent

    def __repr__(self):
        return f"FailTuple({self.name} [obj={self.obj!r}, parent={self.parent!r}])"


def _try_pickle(obj) -> bool:
    try:
        cloudpickle.dumps(obj)
        return True
    except Exception:  # noqa: BLE001 - any failure means "not serializable"
        return False


def _inspect_func(fn, depth, parent, failures, prints):
    closure = inspect.getclosurevars(fn)
    found = False
    for kind, mapping in (("global", closure.globals),
                          ("nonlocal", closure.nonlocals)):
        for name, val in mapping.items():
            if _try_pickle(val):
                continue
            found = True
            prints.append(f"  {kind} variable {name!r} of "
                          f"{fn.__qualname__} fails")
            _inspect(val, name=name, depth=depth - 1, parent=fn,
                     failures=failures, prints=prints)
    if not found:
        failures.add_frame(fn, getattr(fn, "__qualname__", str(fn)), parent)
    return found


def _inspect_obj(obj, depth, parent, failures, prints):
    found = False
    for name, val in vars(obj).items():
        if _try_pickle(val):
            continue
        found = True
        prints.append(f"  attribute {name!r} of {type(obj).__name__} fails")
        _inspect(val, name=name, depth=depth - 1, parent=obj,
                 failures=failures, prints=prints)
    if not found:
        failures.add_frame(obj, type(obj).__name__, parent)
    return found


class _Failures:
    def __init__(self):
        self.found: Set[Tuple[int, str]] = set()
        self.frames = []

    def add_frame(self, obj, name, parent):
        key = (id(obj), name)
        if key not in self.found:
            self.found.add(key)
            self.frames.append(FailureTuple(obj, name, parent))


def _inspect(obj, *, name, depth, parent, failures, prints):
    ok = _try_pickle(obj)   # pickle once per frame, not twice
    if depth <= 0 or ok:
        if not ok:
            failures.add_frame(obj, name, parent)
        return
    if inspect.isfunction(obj):
        _inspect_func(obj, depth, parent, failures, prints)
    elif hasattr(obj, "__dict__") and vars(obj):
        _inspect_obj(obj, depth, parent, failures, prints)
    else:
        failures.add_frame(obj, name, parent)


def inspect_serializability(obj: Any, name: Optional[str] = None,
                            depth: int = 3, print_file=None):
    """Returns (is_serializable, set_of_FailureTuple); prints a trace of
    which closure variables / attributes break pickling (ref signature:
    python/ray/util/check_serialize.py inspect_serializability)."""
    name = name or getattr(obj, "__qualname__", type(obj).__name__)
    failures = _Failures()
    prints = [f"Checking serializability of {name!r}"]
    ok = _try_pickle(obj)
    if not ok:
        _inspect(obj, name=name, depth=depth, parent=None,
                 failures=failures, prints=prints)
    for line in prints if not ok else ():
        print(line, file=print_file)
    return ok, set(failures.frames)
