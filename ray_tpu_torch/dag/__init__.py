"""Compiled actor pipelines: the port's copy of `ray_tpu.dag` (reference:
python/ray/dag/ — InputNode/dag_node.py bind graphs, compiled_dag_node.py
experimental_compile), over the port's runtime. `actor.method.bind(...)`
builds a `ClassMethodNode` and `fn.bind(...)` a `FunctionNode` (the node
`workflow` runs). The card does no work here beyond what the actors do.

    with dag.InputNode() as inp:
        x = preproc.tokenize.bind(inp)
        y = model.infer.bind(x)
        out = postproc.detok.bind(y)
    compiled = out.experimental_compile()
    ref = compiled.execute(prompt)          # one driver round-trip
    results = [compiled.execute(p) for p in prompts]  # stages overlap

What "compiled" buys here:

- ONE submission round per execute(): the whole chain is registered with
  the controller as dependency-linked tasks; intermediate values flow
  worker→worker through the shared-memory arena (zero-copy attach on the
  consumer) without the driver touching them. The reference compiles to
  pre-allocated channels for the same reason — here plasma-style shm IS
  the channel.
- PIPELINING across consecutive execute() calls for free: each actor
  serializes its own calls, so stage A works on item i+1 while stage B
  works on item i — exactly the prefill→decode / multi-stage-serve overlap
  pattern the reference gets from its compiled DAG scheduler.
- MultiOutputNode returns several leaves per execution.

Contrast: no static channel pre-allocation or per-execution buffer reuse
(the arena allocator is a lock+freelist op, measured cheap), and actor
method CANCELLATION of a whole in-flight execution is per-ref.
"""

from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """Base: something whose value materializes per execution."""

    def experimental_compile(self, **_compat) -> "CompiledDag":
        return CompiledDag([self])

    def execute(self, *args, **kwargs):
        """Uncompiled convenience execution (reference dag_node.execute)."""
        return self.experimental_compile().execute(*args, **kwargs)


class InputNode(DAGNode):
    """The per-execution input placeholder (reference input_node.py).

    Supports attribute/index access (`inp[0]`, `inp.field`) so one input
    can fan out structured pieces to different stages. The `with` block is
    reference-API sugar — binds work the same outside it."""

    def __init__(self):
        self._accessor: Tuple = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return None

    def __getitem__(self, key):
        out = InputNode()
        out._accessor = self._accessor + (("item", key),)
        return out

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        out = InputNode()
        out._accessor = self._accessor + (("attr", name),)
        return out

    def _resolve(self, value):
        for kind, key in self._accessor:
            value = value[key] if kind == "item" else getattr(value, key)
        return value


class ClassMethodNode(DAGNode):
    """One actor-method invocation in the graph (reference class_node.py)."""

    def __init__(self, actor_handle, method_name: str, args: Tuple,
                 kwargs: Dict):
        self.actor = actor_handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs


class MultiOutputNode(DAGNode):
    """Bundle several leaves into one execution returning a list
    (reference dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        self.outputs = list(outputs)

    def experimental_compile(self, **_compat) -> "CompiledDag":
        return CompiledDag(self.outputs)


class FunctionNode(DAGNode):
    """One task invocation in a graph (reference dag function nodes — the
    substrate ray.workflow builds on). Created via RemoteFunction.bind."""

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict):
        self.remote_fn = remote_fn
        self.args = args
        self.kwargs = kwargs

    @property
    def name(self) -> str:
        fn = getattr(self.remote_fn, "_fn", None)
        return getattr(fn, "__name__", "task")


class _BoundMethod:
    def __init__(self, actor_handle, method_name):
        self._actor = actor_handle
        self._name = method_name

    def bind(self, *args, **kwargs) -> ClassMethodNode:
        return ClassMethodNode(self._actor, self._name, args, kwargs)


def bind_method(actor_handle, method_name: str) -> _BoundMethod:
    """`actor.method.bind(...)` sugar lives on ActorHandle (actor.py); this
    is the functional spelling for handles from older pickles."""
    return _BoundMethod(actor_handle, method_name)


class CompiledDag:
    """A frozen pipeline: execute() submits every node's task in one pass,
    wiring outputs to inputs as ObjectRefs (deps resolve in the controller;
    values move through shm, never the driver)."""

    def __init__(self, outputs: List[DAGNode]):
        self.outputs = outputs
        self._order = self._toposort(outputs)
        self._single = len(outputs) == 1

    @staticmethod
    def _toposort(outputs: List[DAGNode]) -> List[ClassMethodNode]:
        order: List[ClassMethodNode] = []
        seen = set()

        def visit(node):
            if isinstance(node, MultiOutputNode):
                for o in node.outputs:
                    visit(o)
                return
            if isinstance(node, FunctionNode):
                raise TypeError(
                    "task .bind nodes run via ray_tpu_torch.workflow, not compiled "
                    "actor DAGs; wrap the function in an actor (or call it "
                    "with .remote and pass the ObjectRef)")
            if not isinstance(node, ClassMethodNode) or id(node) in seen:
                return
            seen.add(id(node))
            for a in list(node.args) + list(node.kwargs.values()):
                visit(a)
            order.append(node)

        for out in outputs:
            visit(out)
        if not order:
            raise ValueError("DAG has no actor-method nodes; bind at least "
                             "one actor.method.bind(...)")
        return order

    def execute(self, *args, **kwargs):
        """Submit the whole pipeline; returns the leaf ObjectRef (or a list
        for MultiOutputNode). Call repeatedly without waiting to PIPELINE:
        each actor processes its calls in order, so consecutive executions
        overlap across stages."""
        if len(args) == 1 and not kwargs:
            dag_input = args[0]
        elif not args and kwargs:
            dag_input = kwargs
        else:
            dag_input = args
        produced: Dict[int, Any] = {}

        def encode(v):
            if isinstance(v, ClassMethodNode):
                return produced[id(v)]
            if isinstance(v, InputNode):
                return v._resolve(dag_input)
            if isinstance(v, DAGNode):  # a node kind execute can't compute
                raise TypeError(f"unsupported DAG node as argument: {v!r}")
            return v

        for node in self._order:
            call_args = tuple(encode(a) for a in node.args)
            call_kwargs = {k: encode(v) for k, v in node.kwargs.items()}
            method = getattr(node.actor, node.method_name)
            produced[id(node)] = method.remote(*call_args, **call_kwargs)
        def leaf(o):
            if isinstance(o, ClassMethodNode):
                return produced[id(o)]
            if isinstance(o, MultiOutputNode):
                return [leaf(x) for x in o.outputs]
            if isinstance(o, InputNode):
                return o._resolve(dag_input)
            raise TypeError(f"unsupported DAG output node: {o!r}")

        refs = [leaf(o) for o in self.outputs]
        return refs[0] if self._single else refs

    async def execute_async(self, *args, **kwargs):
        """Reference execute_async parity: awaitable leaf value(s)."""
        out = self.execute(*args, **kwargs)
        if self._single:
            return await out
        import asyncio
        return await asyncio.gather(*out)

    def teardown(self):
        """Reference parity no-op: nothing persistent to tear down — the
        pipeline holds only actor handles."""


__all__ = ["InputNode", "ClassMethodNode", "MultiOutputNode", "CompiledDag",
           "DAGNode", "bind_method"]
