"""HTTP ingress proxy (reference: python/ray/serve/_private/proxy.py).

The reference proxy is a uvicorn/starlette ASGI app in a dedicated actor per
node, routing by path prefix to the app's ingress deployment. The proxy
actor here speaks HTTP/1.1 directly over `asyncio.start_server` (no
starlette or uvicorn needed) — which is all Serve needs: request line +
headers + Content-Length or chunked body in; JSON / text / SSE-streaming
responses out. It imports neither torch nor a model module: requests and
answers cross it as plain data.

Routing: longest-prefix match on the path → app's ingress deployment handle →
`__call__(Request)` on a replica (picked p2c by the handle). Streaming: if the
ingress is a (async) generator function — recorded at `serve.run` time — or
the client sends `Accept: text/event-stream`, the response is streamed as SSE
`data:` events over a close-delimited connection.
"""

import asyncio
import inspect
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

PROXY_NAME = "SERVE_PROXY"


class Request:
    """What an ingress deployment receives (starlette-Request-shaped: method,
    path, query_params, headers, body; `.json()`). Pickled driver→replica, so
    it holds plain data only."""

    def __init__(self, method: str, path: str, query_string: str = "",
                 headers: Optional[Dict[str, str]] = None, body: bytes = b""):
        self.method = method
        self.path = path
        self.query_string = query_string
        self.headers = headers or {}
        self.body = body

    @property
    def query_params(self) -> Dict[str, str]:
        return {k: v[-1] for k, v in parse_qs(self.query_string).items()}

    def json(self):
        return json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode("utf-8", "replace")

    def __repr__(self):
        return f"Request({self.method} {self.path!r})"


class Response:
    """Optional rich return type for ingress deployments; plain returns are
    coerced (dict/list/num → JSON, str → text/plain, bytes → octet-stream)."""

    def __init__(self, content=b"", status_code: int = 200,
                 headers: Optional[Dict[str, str]] = None,
                 media_type: Optional[str] = None):
        self.content = content
        self.status_code = status_code
        self.headers = headers or {}
        self.media_type = media_type


_STATUS_TEXT = {200: "OK", 204: "No Content", 400: "Bad Request",
                404: "Not Found", 405: "Method Not Allowed",
                411: "Length Required", 413: "Payload Too Large",
                500: "Internal Server Error", 503: "Service Unavailable"}

# Bodies buffer in proxy/dashboard memory before dispatch; without a cap a
# client can stream unbounded chunks into the process. Same ballpark as
# common ingress defaults; override per-process via env.
MAX_BODY_BYTES = int(os.environ.get("RAY_TPU_MAX_HTTP_BODY", 100 << 20))


class _BadRequest(Exception):
    status = 400


class _PayloadTooLarge(_BadRequest):
    status = 413


async def _read_chunked_body(reader, max_bytes: int) -> bytes:
    """Decode a Transfer-Encoding: chunked body (size-hex CRLF data CRLF ...
     0 CRLF trailers CRLF). Ref contrast: the reference proxy gets this for
    free from uvicorn's h11; here the decoder is explicit."""
    chunks = []
    total = 0
    while True:
        size_line = await reader.readline()
        if not size_line:
            raise _BadRequest("truncated chunked body")
        try:
            size = int(size_line.split(b";", 1)[0].strip(), 16)
        except ValueError:
            raise _BadRequest("invalid chunk size") from None
        if size == 0:
            break
        total += size
        if total > max_bytes:
            raise _PayloadTooLarge(f"chunked body exceeds {max_bytes} bytes")
        chunks.append(await reader.readexactly(size))
        if await reader.readexactly(2) != b"\r\n":
            raise _BadRequest("malformed chunk terminator")
    while True:  # trailers, if any, end with a blank line
        tline = await reader.readline()
        if tline in (b"\r\n", b"\n", b""):
            break
    return b"".join(chunks)


async def read_http_request(reader) -> Optional[Request]:
    """Parse one HTTP/1.1 request (request line, headers, Content-Length or
    chunked body). Shared by the serve proxy and the dashboard server."""
    line = await reader.readline()
    if not line or line in (b"\r\n", b"\n"):
        return None
    try:
        method, target, _version = line.decode("latin1").split(" ", 2)
    except ValueError:
        return None
    headers = {}
    while True:
        hline = await reader.readline()
        if hline in (b"\r\n", b"\n", b""):
            break
        if b":" in hline:
            k, v = hline.decode("latin1").split(":", 1)
            headers[k.strip().lower()] = v.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = await _read_chunked_body(reader, MAX_BODY_BYTES)
        parts = urlsplit(target)
        return Request(method.upper(), unquote(parts.path), parts.query,
                       headers, body)
    try:
        length = int(headers.get("content-length", 0) or 0)
        if length < 0:
            raise ValueError(length)
    except ValueError:
        raise _BadRequest("invalid Content-Length") from None
    if length > MAX_BODY_BYTES:
        raise _PayloadTooLarge(f"body of {length} bytes exceeds "
                               f"{MAX_BODY_BYTES}")
    body = await reader.readexactly(length) if length else b""
    parts = urlsplit(target)
    return Request(method.upper(), unquote(parts.path), parts.query,
                   headers, body)


def http_head(status: int, headers: Dict[str, str]) -> bytes:
    text = _STATUS_TEXT.get(status, "Unknown")
    lines = [f"HTTP/1.1 {status} {text}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin1")


async def write_http_response(writer, resp: Response) -> None:
    body = resp.content if isinstance(resp.content, bytes) else \
        str(resp.content).encode()
    headers = {"Content-Length": str(len(body)),
               "Content-Type": resp.media_type or "application/json",
               **resp.headers}
    writer.write(http_head(resp.status_code, headers) + body)
    await writer.drain()


def _coerce_response(out) -> Response:
    if isinstance(out, Response):
        return out
    if out is None:
        return Response(b"", 204)
    if isinstance(out, bytes):
        return Response(out, media_type="application/octet-stream")
    if isinstance(out, str):
        return Response(out.encode(), media_type="text/plain; charset=utf-8")
    return Response(json.dumps(out).encode(),
                    media_type="application/json")


def _encode_sse(item) -> bytes:
    if isinstance(item, bytes):
        data = item.decode("utf-8", "replace")
    elif isinstance(item, str):
        data = item
    else:
        data = json.dumps(item)
    return b"".join(b"data: " + line.encode() + b"\n"
                    for line in data.split("\n")) + b"\n"


class ProxyActor:
    """Async actor hosting the HTTP server. One per cluster (single-host
    runtime); the reference runs one per node behind a load balancer."""

    _ROUTE_TTL_S = 1.0
    _REQUEST_TIMEOUT_S = 120.0

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        from concurrent.futures import ThreadPoolExecutor
        self.host = host
        self.port = port
        self._server = None
        # route prefix -> (app, ingress deployment, is_streaming)
        self._routes: Dict[str, Tuple[str, str, bool]] = {}
        self._handles: Dict[Tuple[str, str], object] = {}
        self._routes_ts = 0.0
        self._inflight = 0
        self._draining = False
        # dedicated pool for blocking handle/result calls — the loop's
        # default executor (~32 threads) would let slow replicas starve
        # route refreshes for every other connection
        self._pool = ThreadPoolExecutor(max_workers=128,
                                        thread_name_prefix="proxy-io")

    async def ready(self) -> int:
        """Bind the server; returns the actual port (port=0 → ephemeral)."""
        if self._server is None:
            self._server = await asyncio.start_server(
                self._serve_client, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    # -- routing table --------------------------------------------------------
    async def _refresh_routes(self, force: bool = False):
        if not force and time.monotonic() - self._routes_ts < self._ROUTE_TTL_S:
            return
        from .controller import get_controller
        ctrl = get_controller()
        loop = asyncio.get_running_loop()
        import ray_tpu_torch as rt
        routes = await loop.run_in_executor(
            self._pool, lambda: rt.get(ctrl.get_routes.remote(),
                                            timeout=30))
        self._routes = routes
        self._routes_ts = time.monotonic()

    def _match(self, path: str):
        best = None
        for prefix, target in self._routes.items():
            norm = prefix.rstrip("/") or ""
            if path == norm or path.startswith(norm + "/") or prefix == "/":
                if best is None or len(norm) > len(best[0]):
                    best = (norm, target)
        return best

    def _handle_for(self, app: str, deployment: str):
        key = (app, deployment)
        h = self._handles.get(key)
        if h is None:
            from .handle import DeploymentHandle
            h = self._handles[key] = DeploymentHandle(deployment, app)
        return h

    # -- HTTP -----------------------------------------------------------------
    async def _serve_client(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter):
        try:
            while True:
                keep_alive = await self._serve_one(reader, writer)
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001 - peer already gone
                pass

    async def _read_request(self, reader) -> Optional[Request]:
        return await read_http_request(reader)

    @staticmethod
    def _head(status: int, headers: Dict[str, str]) -> bytes:
        return http_head(status, headers)

    async def _write_plain(self, writer, resp: Response) -> None:
        await write_http_response(writer, resp)

    async def _serve_one(self, reader, writer) -> bool:
        try:
            req = await self._read_request(reader)
        except _BadRequest as e:
            await self._write_plain(writer, Response(
                str(e).encode(), e.status, media_type="text/plain"))
            return False
        if req is None:
            return False
        if self._draining:
            await self._write_plain(writer, Response(b"draining", 503))
            return False
        if req.path == "/-/healthz":
            await self._write_plain(writer, Response(b"ok", 200,
                                                     media_type="text/plain"))
            return True
        if req.path == "/-/routes":
            await self._refresh_routes(force=True)
            await self._write_plain(writer, _coerce_response(
                {p: f"{a}:{d}" for p, (a, d, _s) in self._routes.items()}))
            return True
        await self._refresh_routes()
        match = self._match(req.path)
        if match is None:
            await self._refresh_routes(force=True)
            match = self._match(req.path)
        if match is None:
            await self._write_plain(writer, Response(
                f"no route for {req.path}".encode(), 404,
                media_type="text/plain"))
            return True
        prefix, (app, deployment, is_stream) = match
        req.path = req.path[len(prefix):] or "/"
        req.route_prefix = prefix   # ASGI ingresses mount here (root_path)
        # streaming is a property of the INGRESS (generator __call__, recorded
        # at deploy time) — an Accept header can't turn a unary deployment
        # into a stream (iterating its dict return would leak keys as events)
        want_stream = is_stream
        self._inflight += 1
        try:
            if want_stream:
                await self._respond_streaming(writer, app, deployment, req)
                return False  # close-delimited
            await self._respond_unary(writer, app, deployment, req)
            return req.headers.get("connection", "").lower() != "close"
        except ConnectionError:
            return False
        except Exception:  # noqa: BLE001 - replica/user error → 500
            try:
                await self._write_plain(writer, Response(
                    traceback.format_exc().encode(), 500,
                    media_type="text/plain"))
            except Exception:  # noqa: BLE001
                pass
            return False
        finally:
            self._inflight -= 1

    async def _respond_unary(self, writer, app, deployment, req):
        handle = self._handle_for(app, deployment)
        model_id = req.headers.get("serve_multiplexed_model_id", "")
        if model_id:  # multiplex routing rides the reference's header name
            handle = handle.options(multiplexed_model_id=model_id)
        loop = asyncio.get_running_loop()
        # handle.remote() talks to the serve controller (blocking client IO);
        # run it and the result fetch on the proxy pool so slow replicas
        # don't stall other connections.
        response = await loop.run_in_executor(self._pool, handle.remote, req)
        out = await loop.run_in_executor(
            self._pool, response.result, self._REQUEST_TIMEOUT_S)
        await self._write_plain(writer, _coerce_response(out))

    async def _respond_streaming(self, writer, app, deployment, req):
        handle = self._handle_for(app, deployment).options(stream=True)
        model_id = req.headers.get("serve_multiplexed_model_id", "")
        if model_id:
            handle = handle.options(multiplexed_model_id=model_id)
        loop = asyncio.get_running_loop()
        # errors before the head is written surface as a normal 500
        gen = await loop.run_in_executor(self._pool, handle.remote, req)
        it = iter(gen)
        _END = object()
        # the FIRST item decides the wire shape: a Response means the
        # generator ingress answered this particular request unary (e.g. an
        # OpenAI endpoint whose body said stream=false) — write it as plain
        # HTTP, no SSE framing. Fetching it before the head also turns
        # first-item replica errors into proper 500s instead of a 200 head
        # followed by an SSE error event.
        first = await loop.run_in_executor(self._pool, lambda: next(it, _END))
        if isinstance(first, Response):
            # _serve_one closes this connection (streaming dispatch is
            # close-delimited) — say so, or keep-alive clients (OpenAI SDKs
            # pool connections) reuse the dead socket and hit ECONNRESET
            first.headers.setdefault("Connection", "close")
            await self._write_plain(writer, first)
            return
        writer.write(self._head(200, {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "close"}))
        await writer.drain()
        # after the 200 head no HTTP error can be signalled — mid-stream
        # replica failures become an SSE error event, never a 500-in-body
        item = first
        try:
            while True:
                if item is _END:
                    break
                writer.write(_encode_sse(item))
                await writer.drain()
                item = await loop.run_in_executor(
                    self._pool, lambda: next(it, _END))
            writer.write(b"data: [DONE]\n\n")
        except ConnectionError:
            raise
        except Exception as e:  # noqa: BLE001 - replica/user error mid-stream
            writer.write(b"event: error\n" +
                         _encode_sse({"error": type(e).__name__,
                                      "detail": str(e)}))
        await writer.drain()

    # -- lifecycle ------------------------------------------------------------
    async def drain(self, timeout_s: float = 10.0) -> bool:
        """Stop accepting new requests; wait for in-flight ones to finish."""
        self._draining = True
        deadline = time.monotonic() + timeout_s
        while self._inflight > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        return self._inflight == 0

    def stats(self) -> Dict:
        return {"inflight": self._inflight, "port": self.port,
                "routes": dict(self._routes)}


def ingress_is_streaming(cls_or_fn) -> bool:
    """Detect generator ingress at deploy time (driver has the real class)."""
    target = cls_or_fn
    if inspect.isclass(cls_or_fn):
        target = getattr(cls_or_fn, "__call__", None)
    return (inspect.isgeneratorfunction(target)
            or inspect.isasyncgenfunction(target))


def start_proxy(host: str = "127.0.0.1", port: int = 8000) -> Tuple[object, int]:
    """Get-or-create the proxy actor; returns (handle, bound_port)."""
    import ray_tpu_torch as rt
    try:
        proxy = rt.get_actor(PROXY_NAME)
    except ValueError:
        proxy = rt.remote(num_cpus=0, max_concurrency=64,
                               name=PROXY_NAME)(ProxyActor).remote(host, port)
    bound = rt.get(proxy.ready.remote())
    return proxy, bound
