"""ASGI ingress adapter (reference: python/ray/serve/api.py:309
`@serve.ingress(app)` + _private/http_util.py ASGIAppReplicaWrapper).

Mounts an arbitrary ASGI application (FastAPI, Starlette, or any
`async def app(scope, receive, send)`) on a deployment: the proxy's
Request is translated into an ASGI `http` scope, the app runs to
completion, and its send() events are collected into a Response. The
deployment class's own methods remain available over handles.

Differences from the reference, by design:
- unary only — the full response is buffered before the proxy writes it
  (the proxy's streaming path is for generator ingresses; an ASGI
  StreamingResponse still works, its chunks are just concatenated);
- no lifespan events — replica __init__/__del__ are the lifecycle hooks
  here (the reference runs the ASGI lifespan protocol on replica start).
"""

import asyncio
import inspect
from typing import Callable, Union

from .proxy import Request, Response


async def call_asgi(app, request: Request) -> Response:
    """Run one request through an ASGI app and collect the response."""
    # the proxy already rewrote request.path relative to the matched route
    # prefix (proxy.py _serve_one); the prefix travels as route_prefix and
    # becomes the ASGI root_path — do NOT strip again here, a path that
    # legitimately begins with the prefix (e.g. /api/api/users) would lose
    # a segment
    prefix = getattr(request, "route_prefix", "") or ""
    path = request.path
    scope = {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": request.method,
        "scheme": "http",
        "path": path,
        "raw_path": path.encode(),
        "root_path": prefix,
        "query_string": (request.query_string or "").encode(),
        "headers": [(k.lower().encode(), v.encode())
                    for k, v in (request.headers or {}).items()],
        "client": ("127.0.0.1", 0),
        "server": ("127.0.0.1", 0),
    }

    body_sent = False

    async def receive():
        nonlocal body_sent
        if not body_sent:
            body_sent = True
            return {"type": "http.request", "body": request.body or b"",
                    "more_body": False}
        # a second receive() means the app awaits disconnect
        await asyncio.sleep(3600)
        return {"type": "http.disconnect"}

    status = 200
    headers = {}
    chunks = []

    async def send(event):
        nonlocal status
        if event["type"] == "http.response.start":
            status = event["status"]
            for bk, bv in event.get("headers", []):
                k = bk.decode("latin-1").lower()
                v = bv.decode("latin-1")
                # repeated headers are comma-joined (Response's dict model
                # can't carry duplicates; note multiple Set-Cookie values
                # comma-join too, which some clients mishandle)
                headers[k] = f"{headers[k]}, {v}" if k in headers else v
        elif event["type"] == "http.response.body":
            chunks.append(event.get("body", b""))

    await app(scope, receive, send)
    headers.pop("content-length", None)        # proxy recomputes it
    media_type = headers.pop("content-type", None)  # rides media_type only
    return Response(b"".join(chunks), status_code=status, headers=headers,
                    media_type=media_type)


def ingress(app: Union[Callable, object]):
    """Class decorator: route this deployment's HTTP traffic through an
    ASGI app. `app` is the app object or a zero-arg factory (called once
    per replica, so unpicklable apps can be built replica-side):

        @serve.deployment
        @serve.ingress(my_asgi_app)
        class D:
            ...                      # methods still callable via handles

    Ref: python/ray/serve/api.py:309 (FastAPI/Starlette mounting)."""
    is_factory = (inspect.isfunction(app) and
                  len(inspect.signature(app).parameters) == 0)

    def decorator(cls):
        if not inspect.isclass(cls):
            raise TypeError("@serve.ingress decorates a class; got "
                            f"{cls!r} (wrap a bare ASGI app in a class or "
                            "deploy it via a trivial wrapper)")

        class ASGIIngress(cls):
            async def __call__(self, request: Request) -> Response:
                asgi_app = getattr(self, "_serve_asgi_app", None)
                if asgi_app is None:
                    asgi_app = app() if is_factory else app
                    self._serve_asgi_app = asgi_app
                return await call_asgi(asgi_app, request)

        ASGIIngress.__name__ = cls.__name__
        ASGIIngress.__qualname__ = getattr(cls, "__qualname__", cls.__name__)
        ASGIIngress.__module__ = cls.__module__
        ASGIIngress.__doc__ = cls.__doc__
        return ASGIIngress

    return decorator
