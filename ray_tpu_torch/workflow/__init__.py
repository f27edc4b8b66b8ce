"""Durable task graphs: the port's copy of `ray_tpu.workflow` (reference:
python/ray/workflow/ — workflow.run(dag, workflow_id=...), storage-backed
step results, resume), over the port's runtime. The journal lives under
the port's own per-user root (`_private/paths.py`,
`ray_tpu_torch_<uid>/workflows`), apart from JAX's.

    @ray_tpu_torch.remote
    def fetch(url): ...
    @ray_tpu_torch.remote
    def train(data, lr): ...

    dag = train.bind(fetch.bind("s3://..."), lr=1e-3)
    out = workflow.run(dag, workflow_id="exp1")
    # crash anywhere → workflow.resume("exp1") re-runs ONLY unfinished steps

Design (vs the reference's workflow controller actors): a workflow here is
a static FunctionNode DAG executed step-by-step, each step's result
pickled into the per-user scratch root before its dependents run. Resume
replays the journal: completed steps load from storage, everything else
re-executes. Exactly-once is per-step at-least-once with idempotent
journaling — the reference's model. Dynamic continuations are supported:
a step that returns `workflow.continuation(sub_dag)` tail-calls the
sub-DAG — the engine journals the continuation itself (so resume never
re-runs the step that produced it) and recursively executes the sub-DAG's
steps under namespaced journal keys, enabling recursion/loops whose shape
is decided at runtime. Virtual actors are subsumed by detached actors +
GCS journaling (_private/gcs.py).

NOTE on reference parity: the reference REMOVED ray.workflow in 2.44 (its
`workflow/__init__.py` is a deprecation stub raising RuntimeError). This
module keeps the pre-removal surface (run/run_async/resume/get_status/
list_all/delete + continuation), as JAX's does.

Step identity: the DAG's deterministic topological index + function name —
stable across runs of the same code, no user-supplied step ids needed
(matching reference behavior for unnamed steps).
"""

import os
import pickle
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import paths
from ray_tpu_torch.dag import FunctionNode


def _store_root() -> str:
    return paths.subdir("workflows")


def _wf_dir(workflow_id: str) -> str:
    if (not workflow_id or os.sep in workflow_id
            or workflow_id in (".", "..")):
        # "" would alias the whole store root (delete("") → rm -rf all)
        raise ValueError(f"workflow_id must be a plain name: {workflow_id!r}")
    return os.path.join(_store_root(), workflow_id)


def _toposort(root: FunctionNode) -> List[FunctionNode]:
    order: List[FunctionNode] = []
    seen = set()

    def visit(node):
        if not isinstance(node, FunctionNode) or id(node) in seen:
            return
        seen.add(id(node))
        for a in list(node.args) + list(node.kwargs.values()):
            visit(a)
        order.append(node)

    visit(root)
    if not order:
        raise TypeError("workflow.run takes a task DAG built with "
                        "fn.bind(...)")
    return order


def _step_key(idx: int, node: FunctionNode) -> str:
    return f"step_{idx:04d}_{node.name}"


def _fs_key(logical_key: str) -> str:
    """Map a logical step key to a filename-safe journal key. Deep
    continuation chains grow the prefix linearly (each tail-call appends
    '<step>.c.'), which would blow the 255-byte filename limit around
    depth ~10 — long keys collapse to a stable digest of the full logical
    key, so identity (and therefore resume) is preserved at any depth."""
    if len(logical_key) <= 150:
        return logical_key
    import hashlib
    digest = hashlib.sha256(logical_key.encode()).hexdigest()[:32]
    return f"{logical_key[:80]}...h{digest}"


class _Status:
    RUNNING = "RUNNING"
    SUCCESSFUL = "SUCCESSFUL"
    FAILED = "FAILED"


class Continuation:
    """Wrapper a step returns to tail-call another DAG (see `continuation`)."""

    __slots__ = ("dag",)

    def __init__(self, dag: FunctionNode):
        self.dag = dag


def continuation(dag: FunctionNode) -> Continuation:
    """Tail-call `dag` as the rest of this step's computation.

    Return `workflow.continuation(fn.bind(...))` from inside a workflow
    step and the engine executes the bound sub-DAG as this step's
    replacement: the step's journaled value becomes the sub-DAG's value,
    the sub-DAG's own steps are durably journaled (namespaced under the
    producing step's key), and a crash anywhere resumes without re-running
    the step that produced the continuation. Continuations may nest
    (a sub-step may itself return one), which is how runtime-shaped
    loops/recursion are expressed:

        @ray_tpu_torch.remote
        def fac(n, acc=1):
            if n <= 1:
                return acc
            return workflow.continuation(fac.bind(n - 1, acc * n))

        workflow.run(fac.bind(5))   # -> 120
    """
    if not isinstance(dag, FunctionNode):
        raise TypeError("continuation takes a task DAG built with "
                        "fn.bind(...)")
    return Continuation(dag)


class _TailCall:
    """Internal: a DAG level's TERMINAL step produced a Continuation. The
    trampoline in `_exec_dag` follows it iteratively — a 10k-deep
    tail-recursive workflow must not consume 10k Python stack frames."""

    __slots__ = ("key", "dag")

    def __init__(self, key: str, dag: FunctionNode):
        self.key = key
        self.dag = dag


def _journal(path: str, obj: Any, *, code: bool = False) -> None:
    """Atomic write; `code=True` uses cloudpickle (continuation DAGs carry
    functions)."""
    import cloudpickle
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        (cloudpickle if code else pickle).dump(obj, f)
    os.replace(tmp, path)


def _exec_dag(dag: FunctionNode, wdir: str, prefix: str = "") -> Any:
    """Execute a DAG durably, resolving continuations.

    Tail-calls (the level's LAST step returns a Continuation) are followed
    by an iterative trampoline: the continuation DAG is journaled
    (<key>.cont.pkl) and becomes the next loop iteration, so chain depth
    costs zero stack. Mid-DAG continuations (a non-terminal step returns
    one) recurse — that depth is the user's DAG nesting, not the chain
    length. When the chain bottoms out, the final value is journaled into
    every pending tail-call key's <key>.pkl (unwound in reverse) so
    dependents, re-runs, and `resume(wid)`'s terminal-value lookup all
    observe fully-resolved values."""
    pending: List[str] = []  # tail-call keys awaiting the chain's value
    while True:
        res = _exec_steps(dag, wdir, prefix)
        if isinstance(res, _TailCall):
            pending.append(res.key)
            dag, prefix = res.dag, res.key + ".c."
            continue
        break
    for key in reversed(pending):
        _journal(os.path.join(wdir, key + ".pkl"), res)
    return res


def _exec_steps(dag: FunctionNode, wdir: str, prefix: str):
    """Run one DAG level; returns the terminal value, or a _TailCall if the
    terminal step produced a Continuation (journaled before returning)."""
    import cloudpickle

    import ray_tpu_torch as rt

    order = _toposort(dag)
    values: Dict[int, Any] = {}
    for idx, node in enumerate(order):
        terminal = idx == len(order) - 1
        key = _fs_key(prefix + _step_key(idx, node))
        path = os.path.join(wdir, key + ".pkl")
        cont_path = os.path.join(wdir, key + ".cont.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                values[id(node)] = pickle.load(f)
            continue
        if os.path.exists(cont_path):
            # crashed mid-continuation: resume the journaled sub-DAG
            # WITHOUT re-running the step that produced it
            with open(cont_path, "rb") as f:
                sub = cloudpickle.load(f)
            if terminal:
                return _TailCall(key, sub)
            value = _exec_dag(sub, wdir, prefix=key + ".c.")
        else:
            args = tuple(values[id(a)] if isinstance(a, FunctionNode) else a
                         for a in node.args)
            kwargs = {k: values[id(v)] if isinstance(v, FunctionNode) else v
                      for k, v in node.kwargs.items()}
            value = rt.get(node.remote_fn.remote(*args, **kwargs))
            if isinstance(value, Continuation):
                _journal(cont_path, value.dag, code=True)
                if terminal:
                    return _TailCall(key, value.dag)
                value = _exec_dag(value.dag, wdir, prefix=key + ".c.")
        _journal(path, value)  # journal BEFORE dependents observe it
        values[id(node)] = value
    return values[id(order[-1])]


def run(dag: FunctionNode, *, workflow_id: Optional[str] = None) -> Any:
    """Execute the DAG durably; returns the root node's value. A re-run (or
    `resume`) with the same workflow_id skips journaled steps."""
    import uuid

    import ray_tpu_torch as rt
    if not rt.is_initialized():
        rt.init()
    workflow_id = workflow_id or f"wf-{uuid.uuid4().hex[:10]}"
    wdir = _wf_dir(workflow_id)
    os.makedirs(wdir, exist_ok=True)
    _write_meta(wdir, {"status": _Status.RUNNING, "started_at": time.time()})

    try:
        out = _exec_dag(dag, wdir)
    except BaseException as e:
        _write_meta(wdir, {"status": _Status.FAILED, "error": repr(e)})
        raise
    _write_meta(wdir, {"status": _Status.SUCCESSFUL,
                       "finished_at": time.time()})
    return out


def run_async(dag: FunctionNode, *, workflow_id: Optional[str] = None):
    """Reference parity: returns an ObjectRef-like future (a plain task
    wrapping run — durability semantics identical)."""
    import ray_tpu_torch as rt

    @rt.remote
    def _driver(blob):
        import cloudpickle
        return run(cloudpickle.loads(blob), workflow_id=workflow_id)

    import cloudpickle
    return _driver.remote(cloudpickle.dumps(dag))


def resume(workflow_id: str, dag: Optional[FunctionNode] = None) -> Any:
    """Resume a crashed/failed workflow. The reference re-loads the DAG
    from storage; we journal step RESULTS (not code), so the caller passes
    the same DAG (plain code re-import) — completed steps are skipped.
    Without a DAG, returns the stored terminal value if the workflow
    already finished."""
    wdir = _wf_dir(workflow_id)
    if not os.path.isdir(wdir):
        raise ValueError(f"no workflow {workflow_id!r}")
    if dag is not None:
        return run(dag, workflow_id=workflow_id)
    meta = _read_meta(wdir)
    if meta.get("status") != _Status.SUCCESSFUL:
        raise ValueError(
            f"workflow {workflow_id!r} is {meta.get('status')}; pass the DAG "
            f"to re-execute its unfinished steps")
    steps = sorted(p for p in os.listdir(wdir) if p.endswith(".pkl"))
    with open(os.path.join(wdir, steps[-1]), "rb") as f:
        return pickle.load(f)


def get_status(workflow_id: str) -> str:
    return _read_meta(_wf_dir(workflow_id)).get("status", "UNKNOWN")


def list_all() -> List[Dict[str, Any]]:
    root = _store_root()
    out = []
    for wid in sorted(os.listdir(root)):
        wdir = os.path.join(root, wid)
        if os.path.isdir(wdir):
            meta = _read_meta(wdir)
            out.append({"workflow_id": wid,
                        "status": meta.get("status", "UNKNOWN")})
    return out


def delete(workflow_id: str) -> None:
    import shutil
    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)


def _write_meta(wdir: str, updates: Dict) -> None:
    meta = _read_meta(wdir)
    meta.update(updates)
    tmp = os.path.join(wdir, "meta.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(meta, f)
    os.replace(tmp, os.path.join(wdir, "meta.pkl"))


def _read_meta(wdir: str) -> Dict:
    try:
        with open(os.path.join(wdir, "meta.pkl"), "rb") as f:
            return pickle.load(f)
    except (FileNotFoundError, EOFError):
        return {}


__all__ = ["run", "run_async", "resume", "get_status", "list_all", "delete",
           "continuation", "Continuation"]
