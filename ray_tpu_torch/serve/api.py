"""serve.run / serve.delete / handles (reference: python/ray/serve/api.py).

`run()` walks the bound DAG bottom-up, registers each deployment with the
controller actor (which spawns replica actors), and returns a handle to the
root; `start()` adds the HTTP proxy actor in front of the handles. A
deployment's class and its init arguments travel to the controller as
cloudpickle bytes, unpickled only in its replicas.
"""

import dataclasses
from typing import Dict, List, Optional

import cloudpickle

from .controller import get_controller
from .deployment import BoundDeployment, Deployment, map_bound
from .handle import DeploymentHandle


def run(target: BoundDeployment, *, name: str = "default",
        route_prefix: Optional[str] = None, blocking: bool = False,
        _autoscale_interval_s: Optional[float] = 2.0) -> DeploymentHandle:
    import ray_tpu_torch as rt
    if not rt.is_initialized():
        rt.init()
    if not isinstance(target, BoundDeployment):
        raise TypeError("serve.run takes a bound deployment: dep.bind(...)")
    ctrl = get_controller()

    handles: Dict[int, DeploymentHandle] = {}
    any_autoscaling = False
    for node in target.walk():
        dep: Deployment = node.deployment

        def resolve(v):
            return map_bound(v, lambda child: handles[id(child)])

        args = tuple(resolve(a) for a in node.args)
        kwargs = {k: resolve(v) for k, v in node.kwargs.items()}
        blob = cloudpickle.dumps(dep._callable)
        rt.get(ctrl.register_deployment.remote(
            name, dep.name, blob, cloudpickle.dumps(args),
            cloudpickle.dumps(kwargs), dep.config))
        handles[id(node)] = DeploymentHandle(dep.name, name)
        any_autoscaling = any_autoscaling or dep.config.autoscaling_config

    # HTTP route: prefix → the root (ingress) deployment of this app
    from .proxy import ingress_is_streaming
    ingress = target.deployment
    prefix = route_prefix if route_prefix is not None else (
        "/" if name == "default" else f"/{name}")
    rt.get(ctrl.set_route.remote(
        prefix, name, ingress.name, ingress_is_streaming(ingress._callable)))

    if any_autoscaling and _autoscale_interval_s:
        rt.get(ctrl.start_autoscaler.remote(_autoscale_interval_s))
    return handles[id(target)]


@dataclasses.dataclass
class HTTPOptions:
    """Proxy bind options (ref: ray.serve.config.HTTPOptions) — accepted
    by start() interchangeably with a plain dict."""
    host: str = "127.0.0.1"
    port: int = 8000


def run_many(targets, **kwargs) -> List[DeploymentHandle]:
    """Deploy several (app_name, bound_deployment) pairs (ref:
    serve.run_many); returns their handles in order."""
    return [run(t, name=n, **kwargs) for n, t in targets]


async def shutdown_async() -> None:
    """Async-context shutdown (ref: serve.shutdown_async): same teardown,
    but safe to call from a running event loop where the sync version's
    blocking gets would deadlock."""
    import asyncio
    await asyncio.get_running_loop().run_in_executor(None, shutdown)


def start(detached: bool = True, http_options: Optional[Dict] = None,
          grpc_options: Optional[Dict] = None, **_compat):
    """Start the HTTP proxy (reference: serve.start). Returns the bound port
    — pass port=0 in http_options to grab an ephemeral one (test-friendly).

    `grpc_options={"port": N}` additionally starts the gRPC ingress
    (serve/grpc_ingress.py); its bound port is returned by
    `serve.grpc_port()`."""
    from .proxy import start_proxy
    import ray_tpu_torch as rt
    if not rt.is_initialized():
        rt.init()
    if isinstance(http_options, HTTPOptions):
        http_options = dataclasses.asdict(http_options)
    opts = dict(http_options or {})
    _proxy, port = start_proxy(opts.get("host", "127.0.0.1"),
                               opts.get("port", 8000))
    if grpc_options is not None:
        _start_grpc(grpc_options.get("port", 9000))
    return port


_GRPC_ACTOR_NAME = "_rtpu_serve_grpc"


def _start_grpc(port: int) -> int:
    import ray_tpu_torch as rt
    from .grpc_ingress import GrpcIngressActor
    try:
        actor = rt.get_actor(_GRPC_ACTOR_NAME, namespace="_system")
    except ValueError:
        Actor = rt.remote(num_cpus=0, max_concurrency=32)(
            GrpcIngressActor)
        actor = Actor.options(name=_GRPC_ACTOR_NAME, namespace="_system",
                              lifetime="detached").remote(port)
        try:
            return rt.get(actor.start.remote(), timeout=60)
        except Exception:
            rt.kill(actor)  # never leave a dead named ingress behind
            raise
    return rt.get(actor.port.remote(), timeout=60)


def grpc_port() -> Optional[int]:
    """The gRPC ingress's bound port, or None when not started."""
    import ray_tpu_torch as rt
    try:
        actor = rt.get_actor(_GRPC_ACTOR_NAME, namespace="_system")
    except ValueError:
        return None
    return rt.get(actor.port.remote(), timeout=30)


def delete(name: str = "default") -> None:
    import ray_tpu_torch as rt
    if not rt.is_initialized():
        return
    try:
        ctrl = get_controller()
        rt.get(ctrl.delete_app.remote(name))
    except Exception:  # noqa: BLE001 - nothing deployed
        pass


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    """Handle to a running app's INGRESS deployment (ref:
    python/ray/serve/api.py get_app_handle) — resolved through the
    controller's route table, so the caller needn't know which deployment
    is the root."""
    import ray_tpu_torch as rt
    ctrl = get_controller()
    for _prefix, (app, ingress, _streaming) in rt.get(
            ctrl.get_routes.remote()).items():
        if app == name:
            return DeploymentHandle(ingress, app)
    raise ValueError(f"no running serve application named {name!r}")


def get_replica_context():
    """Inside a replica: who am I (app, deployment, replica tag)."""
    from .replica import get_replica_context as _grc
    return _grc()


def shutdown() -> None:
    import ray_tpu_torch as rt
    if not rt.is_initialized():
        return
    try:
        from .proxy import PROXY_NAME
        proxy = rt.get_actor(PROXY_NAME)
        rt.get(proxy.drain.remote(), timeout=15)
        rt.kill(proxy)
    except Exception:  # noqa: BLE001 - no proxy running
        pass
    try:
        ctrl = get_controller()
        for app in rt.get(ctrl.list_apps.remote()):
            rt.get(ctrl.delete_app.remote(app))
        rt.kill(ctrl)
    except Exception:  # noqa: BLE001
        pass


def status() -> Dict:
    import ray_tpu_torch as rt
    ctrl = get_controller()
    out = {}
    for app in rt.get(ctrl.list_apps.remote()):
        for dep in rt.get(ctrl.list_deployments.remote(app)):
            out[f"{app}:{dep}"] = {
                "replicas": rt.get(ctrl.num_replicas.remote(app, dep))}
    return out
