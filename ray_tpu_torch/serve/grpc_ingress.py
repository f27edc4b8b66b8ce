"""gRPC ingress (reference: python/ray/serve/grpc_util.py + the serve gRPC
proxy, serve/_private/proxy.py gRPCProxy).

The reference registers user-compiled protobuf servicers. Re-cut without
codegen: ONE generic service, `ray_tpu_torch.serve.Ingress`, whose methods take
and return raw bytes (grpc's generic handler API — no .proto compilation
anywhere):

    /ray_tpu_torch.serve.Ingress/Predict  request:  pickled
        {"app": str, "method"?: str, "args": tuple, "kwargs": dict,
         "multiplexed_model_id"?: str}
        response: pickled return value (or raises grpc error with the
        replica traceback in details)
    /ray_tpu_torch.serve.Ingress/PredictStream  same request; server-streaming
        pickled items (generator deployments)
    /ray_tpu_torch.serve.Ingress/ListApplications  request b"" → pickled [names]
    /ray_tpu_torch.serve.Ingress/Healthz  request b"" → b"ok"

Client side, any grpc channel works:

    ch = grpc.insecure_channel(addr)
    call = ch.unary_unary("/ray_tpu_torch.serve.Ingress/Predict")
    out = pickle.loads(call(pickle.dumps({"app": "calc", "args": (2,)})))

Python-only wire format by design: this plane serves intra-cluster callers
(the reference's gRPC ingress primarily targets the same); cross-language
callers use the HTTP ingress.

SECURITY / TRUST BOUNDARY: the wire
format is unversioned pickle, and unpickling executes arbitrary code — so
this server binds LOOPBACK ONLY (grpc_ingress.py `add_insecure_port
127.0.0.1`) and must stay behind the same trust line as the cluster's
pickle control plane (see _private/cluster.py's token discussion). Do not
re-bind it on a routable interface: anyone who can reach the port can run
code as the serve user. Cross-trust-domain callers get the HTTP ingress
(JSON, no code execution) or a user-compiled proto servicer layered on
grpc's generic handlers.
"""

import asyncio
import pickle
import traceback
from typing import Optional

SERVICE = "ray_tpu_torch.serve.Ingress"


def _handle_for(app: str, method: Optional[str], model_id: str, stream: bool):
    from . import api as serve_api
    from .controller import get_controller
    import ray_tpu_torch as rt
    ctrl = get_controller()
    deployments = rt.get(ctrl.list_deployments.remote(app))
    if not deployments:
        raise KeyError(f"no application {app!r}")
    ingress = deployments[-1]  # serve.run registers the ingress last
    h = serve_api.get_deployment_handle(ingress, app)
    opts = {}
    if method:
        opts["method_name"] = method
    if model_id:
        opts["multiplexed_model_id"] = model_id
    if stream:
        opts["stream"] = True
    return h.options(**opts) if opts else h


class _GenericServicer:
    """grpc.aio generic handler: bytes→bytes, no generated stubs."""

    def __init__(self, pool):
        self._pool = pool  # shared thread pool: handle.remote blocks on IO

    async def predict(self, request: bytes, context) -> bytes:
        import grpc
        try:
            req = pickle.loads(request)
            handle = _handle_for(req["app"], req.get("method"),
                                 req.get("multiplexed_model_id", ""), False)
            loop = asyncio.get_running_loop()
            resp = await loop.run_in_executor(
                self._pool, lambda: handle.remote(
                    *req.get("args", ()), **req.get("kwargs", {})))
            # honor the caller's gRPC deadline (or an explicit timeout_s in
            # the request); default generous for long generations
            remaining = context.time_remaining()
            timeout = req.get("timeout_s") or remaining or 600
            out = await loop.run_in_executor(self._pool, resp.result, timeout)
            return pickle.dumps(out)
        except Exception:  # noqa: BLE001 - ship the traceback to the caller
            await context.abort(grpc.StatusCode.INTERNAL,
                                traceback.format_exc()[-2000:])

    async def predict_stream(self, request: bytes, context):
        import grpc
        try:
            req = pickle.loads(request)
            handle = _handle_for(req["app"], req.get("method"),
                                 req.get("multiplexed_model_id", ""), True)
            loop = asyncio.get_running_loop()
            gen = await loop.run_in_executor(
                self._pool, lambda: handle.remote(
                    *req.get("args", ()), **req.get("kwargs", {})))
            it = iter(gen)
            _END = object()
            while True:
                item = await loop.run_in_executor(
                    self._pool, lambda: next(it, _END))
                if item is _END:
                    return
                yield pickle.dumps(item)
        except Exception:  # noqa: BLE001
            await context.abort(grpc.StatusCode.INTERNAL,
                                traceback.format_exc()[-2000:])

    async def list_applications(self, request: bytes, context) -> bytes:
        from .controller import get_controller
        import ray_tpu_torch as rt
        ctrl = get_controller()
        return pickle.dumps(sorted(rt.get(ctrl.list_apps.remote())))

    async def healthz(self, request: bytes, context) -> bytes:
        return b"ok"


def build_server(port: int = 0):
    """Create (but don't start) the grpc.aio server; returns (server, port
    placeholder resolved at start)."""
    import concurrent.futures

    import grpc
    from grpc import aio

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=16)
    servicer = _GenericServicer(pool)
    ident = bytes
    rpcs = {
        "Predict": grpc.unary_unary_rpc_method_handler(
            servicer.predict, request_deserializer=ident,
            response_serializer=ident),
        "PredictStream": grpc.unary_stream_rpc_method_handler(
            servicer.predict_stream, request_deserializer=ident,
            response_serializer=ident),
        "ListApplications": grpc.unary_unary_rpc_method_handler(
            servicer.list_applications, request_deserializer=ident,
            response_serializer=ident),
        "Healthz": grpc.unary_unary_rpc_method_handler(
            servicer.healthz, request_deserializer=ident,
            response_serializer=ident),
    }
    server = aio.server()
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE, rpcs),))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    return server, bound


class GrpcIngressActor:
    """Deployment-host actor: runs the grpc.aio server on its asyncio loop
    (spawned by serve.start(grpc_options={"port": N}))."""

    def __init__(self, port: int = 0):
        self._port = port
        self._server = None
        self._bound = None

    async def start(self) -> int:
        self._server, self._bound = build_server(self._port)
        if not self._bound:
            # grpc returns 0 instead of raising when the port is taken; a
            # detached actor persisting in that state would wedge every
            # later serve.start
            raise RuntimeError(
                f"could not bind gRPC ingress port {self._port}")
        await self._server.start()
        return self._bound

    async def stop(self):
        if self._server is not None:
            await self._server.stop(grace=1.0)

    async def port(self) -> int:
        return self._bound
