"""Deployment + application DAG (reference: python/ray/serve/deployment.py,
serve/_private/deployment_graph_build.py).

`@serve.deployment` wraps a class; `.bind(*args)` builds a DAG node whose
arguments may themselves be bound deployments, also inside lists, tuples
and dict values (`OpenAIIngress.bind({"model": llm.bind(cfg)})`) — `serve.run`
instantiates the graph bottom-up, replacing bound children with
DeploymentHandles. The port's copy of the JAX package's module, name for
name (JAX's walk sees top-level arguments only, and passes a nested bound
deployment through unresolved); a replica that holds a card asks for it
with `ray_actor_options={"num_gpus": 1}`.
"""

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 0.0
    # SLO-driven scaling: when set, the controller compares each
    # interval's windowed replica SLO snapshot (serve_ttft_s/serve_tpot_ms
    # p99, batch occupancy) against these targets — a breach forces a
    # one-step scale-up even if ongoing-count math is satisfied, and a
    # scale-down is held unless the fleet sits comfortably inside target
    # (p99 <= downscale_slo_margin * target).
    target_ttft_p99_s: Optional[float] = None
    target_tpot_p99_ms: Optional[float] = None
    occupancy_high: float = 0.85
    downscale_slo_margin: float = 0.5


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    user_config: Any = None
    ray_actor_options: Dict = dataclasses.field(default_factory=dict)
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 10.0


class Deployment:
    def __init__(self, cls_or_fn, name: Optional[str] = None,
                 config: Optional[DeploymentConfig] = None):
        self._callable = cls_or_fn
        self.name = name or getattr(cls_or_fn, "__name__", "deployment")
        self.config = config or DeploymentConfig()

    def options(self, *, num_replicas=None, max_ongoing_requests=None,
                user_config=None, ray_actor_options=None, name=None,
                autoscaling_config=None, **_compat):
        cfg = dataclasses.replace(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if user_config is not None:
            cfg.user_config = user_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
            cfg.num_replicas = max(cfg.num_replicas,
                                   autoscaling_config.min_replicas)
        return Deployment(self._callable, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> "BoundDeployment":
        return BoundDeployment(self, args, kwargs)

    def __call__(self, *a, **k):
        raise TypeError(
            f"Deployment '{self.name}' can't be called directly; deploy it "
            f"with serve.run(dep.bind(...)) and use the handle.")


class BoundDeployment:
    """A DAG node: deployment + init args (which may contain other nodes)."""

    def __init__(self, deployment: Deployment, args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def walk(self):
        """Yield nodes bottom-up (children before parents), deduplicated."""
        seen = set()

        def _walk(node):
            for a in list(node.args) + list(node.kwargs.values()):
                for child in _bound_in(a):
                    yield from _walk(child)
            if id(node) not in seen:
                seen.add(id(node))
                yield node

        yield from _walk(self)


def _bound_in(value):
    """The bound deployments in an init argument: itself, or inside a
    list, tuple or dict value."""
    if isinstance(value, BoundDeployment):
        yield value
    elif type(value) in (list, tuple):
        for v in value:
            yield from _bound_in(v)
    elif type(value) is dict:
        for v in value.values():
            yield from _bound_in(v)


def map_bound(value, fn):
    """`value` with every bound deployment in it (as `_bound_in` finds
    them) replaced by `fn(node)`."""
    if isinstance(value, BoundDeployment):
        return fn(value)
    if type(value) in (list, tuple):
        return type(value)(map_bound(v, fn) for v in value)
    if type(value) is dict:
        return {k: map_bound(v, fn) for k, v in value.items()}
    return value


def deployment(cls_or_fn=None, *, name=None, num_replicas=None,
               max_ongoing_requests=None, user_config=None,
               ray_actor_options=None, autoscaling_config=None, **_compat):
    """@serve.deployment decorator (bare or with options)."""

    def wrap(target) -> Deployment:
        dep = Deployment(target, name)
        return dep.options(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config,
            ray_actor_options=ray_actor_options,
            autoscaling_config=autoscaling_config,
        )

    if cls_or_fn is not None:
        return wrap(cls_or_fn)
    return wrap


# What `.bind(...)` returns; the reference exports the same concept as
# `serve.Application` (python/ray/serve/api.py) for type annotations in
# app-builder functions.
Application = BoundDeployment
