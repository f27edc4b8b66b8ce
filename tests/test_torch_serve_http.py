"""Serve's HTTP surface and production features: `ray_tpu_torch.serve`
against `ray_tpu.serve` on the same programs over real sockets, on the CPU.

Each program is written once against a `serve` module and run on JAX's
session (`ray_session`) and on the port's (`rt.init`, one "GPU" number), each
with its own HTTP proxy: the cases of `tests/test_serve_http.py` (a JSON
round trip and the route table, SSE, error paths, text, a chunked request
body, the body cap), `tests/test_serve_asgi.py` (`call_asgi`, `@serve.ingress`
end to end and from a factory) and `tests/test_serve_production.py` (the
config deploy round trip, the multiplexed LRU, request cancellation, the
handle timeout, the gRPC ingress). Status, content type and body are held
equal; a 500's body holds each package's own traceback, so only its
message is compared.
"""

import asyncio
import http.client
import json
import pickle
import socket
import sys
import textwrap
import time

import pytest

import ray_tpu
import ray_tpu.serve as jserve
import ray_tpu_torch as rt
import ray_tpu_torch.serve as tserve
from ray_tpu.serve import asgi as jasgi
from ray_tpu_torch.serve import asgi as tasgi
from test_serve_asgi import make_app
from test_torch_serve import port_session  # noqa: F401 - the module's port session


def _req(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def _raw(port, raw: bytes) -> bytes:
    """Send raw bytes; read the head and a Content-Length body."""
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    s.sendall(raw)
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = s.recv(4096)
        if not chunk:
            break
        resp += chunk
    head, _, body = resp.partition(b"\r\n\r\n")
    lengths = [h for h in head.split(b"\r\n") if h.lower().startswith(b"content-length")]
    n = int(lengths[0].split(b":")[1]) if lengths else 0
    while len(body) < n:
        chunk = s.recv(4096)
        if not chunk:
            break
        body += chunk
    s.close()
    return head.split(b"\r\n")[0] + b"\r\n\r\n" + body


def _chunked(*chunks):
    return b"".join(hex(len(c))[2:].encode() + b"\r\n" + c + b"\r\n" for c in chunks) + b"0\r\n\r\n"




@pytest.fixture(scope="module")
def sessions(ray_session, port_session):
    """Each package's (runtime, serve, proxy port)."""
    yield {"jax": (ray_tpu, jserve, jserve.start(http_options={"port": 0})),
           "port": (rt, tserve, tserve.start(http_options={"port": 0}))}
    jserve.shutdown()


def _on_both(sessions, program):
    want = program(*sessions["jax"])
    got = program(*sessions["port"])
    assert got == want
    return got


def test_http_json_roundtrip_and_routes(sessions):
    def program(rt_, serve, port):
        @serve.deployment
        class Echo:
            def __call__(self, request):
                payload = request.json()
                return {"path": request.path, "method": request.method,
                        "q": request.query_params, "doubled": [2 * x for x in payload["xs"]]}

        serve.run(Echo.bind(), name="echo", route_prefix="/echo")
        out = [_req(port, "POST", "/echo/run?x=1", body=json.dumps({"xs": [1, 2, 3]}),
                    headers={"Content-Type": "application/json"}),
               _req(port, "GET", "/nope")[0], _req(port, "GET", "/-/healthz"),
               json.loads(_req(port, "GET", "/-/routes")[2])["/echo"]]
        serve.delete("echo")
        return out

    got = _on_both(sessions, program)
    assert got[0] == (200, "application/json",
                      b'{"path": "/run", "method": "POST", "q": {"x": "1"}, "doubled": [2, 4, 6]}')
    assert got[1:] == [404, (200, "text/plain", b"ok"), "echo:Echo"]


def test_http_streaming_sse(sessions):
    def program(rt_, serve, port):
        @serve.deployment
        class Tokens:
            def __call__(self, request):
                for i in range(int(request.query_params.get("n", 3))):
                    yield {"token": i}

        serve.run(Tokens.bind(), name="gen", route_prefix="/gen")
        out = _req(port, "GET", "/gen?n=4")
        serve.delete("gen")
        return out

    status, ctype, data = _on_both(sessions, program)
    assert (status, ctype) == (200, "text/event-stream")
    events = [ln[6:] for ln in data.decode().split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]" and [json.loads(e)["token"] for e in events[:-1]] == [0, 1, 2, 3]


def test_http_error_paths(sessions):
    def program(rt_, serve, port):
        @serve.deployment
        class Boom:
            def __call__(self, request):
                raise RuntimeError("kaboom")

        serve.run(Boom.bind(), name="boom", route_prefix="/boom")
        status, ctype, data = _req(port, "GET", "/boom")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.putrequest("POST", "/boom", skip_accept_encoding=True)
        conn.putheader("Content-Length", "abc")
        conn.endheaders()
        bad = conn.getresponse()
        out = [status, ctype, b"RuntimeError: kaboom" in data, bad.status, bad.read()]
        conn.close()
        serve.delete("boom")
        return out

    assert _on_both(sessions, program) == [500, "text/plain", True, 400, b"invalid Content-Length"]


def test_http_function_deployment_and_text(sessions):
    def program(rt_, serve, port):
        @serve.deployment
        def hello(request):
            return f"hello {request.query_params.get('name', 'world')}"

        serve.run(hello.bind(), name="hello", route_prefix="/hello")
        out = [_req(port, "GET", "/hello?name=gpu"), _req(port, "GET", "/hello")]
        serve.delete("hello")
        return out

    assert _on_both(sessions, program) == [(200, "text/plain; charset=utf-8", b"hello gpu"),
                                           (200, "text/plain; charset=utf-8", b"hello world")]


def test_http_chunked_request_body(sessions):
    def program(rt_, serve, port):
        @serve.deployment
        class Len:
            def __call__(self, request):
                return {"n": len(request.body), "text": request.body.decode()}

        serve.run(Len.bind(), name="len", route_prefix="/len")
        out = _raw(port, b"POST /len HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                   + _chunked(b"hello ", b"chunked ", b"world"))
        serve.delete("len")
        return out

    assert _on_both(sessions, program) == (b"HTTP/1.1 200 OK\r\n\r\n"
                                           b'{"n": 19, "text": "hello chunked world"}')


def test_call_asgi_unit():
    """`call_asgi` of both packages on the same app and requests."""
    def run(asgi, serve):
        out = []
        for req in (serve.Request("POST", "/echo", query_string="a=1",
                                  headers={"Content-Type": "text/plain"}, body=b"hi there"),
                    serve.Request("GET", "/missing"), serve.Request("GET", "/hello")):
            resp = asyncio.run(asgi.call_asgi(make_app(), req))
            out.append((resp.status_code, resp.content, resp.headers, resp.media_type))
        try:
            serve.ingress(make_app())(lambda req: req)
        except TypeError as e:
            out.append(str(e).split(";")[0])
        return out

    got, want = run(tasgi, tserve), run(jasgi, jserve)
    assert got == want and got[0][0] == 200 and got[1][0] == 404
    assert got[-1] == "@serve.ingress decorates a class"


def test_asgi_ingress_end_to_end_and_factory(sessions):
    def program(rt_, serve, port):
        @serve.deployment
        @serve.ingress(make_app("live"))
        class Api:
            def direct(self):
                return "handle-path still works"

        def build():
            return make_app("factory")

        @serve.deployment
        @serve.ingress(build)
        class Api2:
            pass

        serve.run(Api.bind(), name="api", route_prefix="/api")
        serve.run(Api2.bind(), name="api2", route_prefix="/api2")
        out = [_req(port, "GET", "/api/hello"), _req(port, "POST", "/api/echo?a=2", body=b"ping"),
               _req(port, "GET", "/api/meta"), _req(port, "GET", "/api/nope"),
               serve.get_deployment_handle("Api", "api").direct.remote().result(timeout_s=60),
               _req(port, "GET", "/api2/hello")]
        serve.delete("api")
        serve.delete("api2")
        return out

    got = _on_both(sessions, program)
    assert got[0] == (200, "application/json", b'{"hello": "live"}')
    assert json.loads(got[2][2]) == {"root_path": "/api", "path": "/meta"}
    assert got[3][0] == 404 and got[4] == "handle-path still works"
    assert got[5] == (200, "application/json", b'{"hello": "factory"}')


def test_multiplexed_lru_and_affinity(sessions):
    def program(rt_, serve, port):
        @serve.deployment
        class MultiModel:
            def __init__(self):
                self.loads = []

            @serve.multiplexed(max_num_models_per_replica=2)
            async def get_model(self, model_id: str):
                self.loads.append(model_id)
                return {"id": model_id, "scale": len(model_id)}

            async def __call__(self, x):
                if not isinstance(x, int):      # a Request through the proxy
                    x = len(x.body)
                model = await self.get_model(serve.get_multiplexed_model_id())
                return {"model": model["id"], "out": x * model["scale"], "loads": list(self.loads)}

        serve.run(MultiModel.bind(), name="mux", route_prefix="/mux")
        h = serve.get_deployment_handle("MultiModel", "mux")
        out = [h.options(multiplexed_model_id=m).remote(x).result(timeout_s=60)
               for m, x in (("aa", 1), ("aa", 2), ("bbb", 1), ("cccc", 1), ("aa", 5))]
        out.append(json.loads(_req(port, "POST", "/mux", body=b"abc",
                                   headers={"serve_multiplexed_model_id": "dd"})[2]))
        serve.delete("mux")
        return out

    got = _on_both(sessions, program)
    assert got[1]["loads"].count("aa") == 1 and got[4]["loads"].count("aa") == 2
    assert got[5]["model"] == "dd" and got[5]["out"] == 6


def test_request_cancellation_and_handle_timeout(sessions):
    def program(rt_, serve, port):
        @serve.deployment(max_ongoing_requests=1)
        class Slow:
            def __init__(self):
                self.cancelled = 0

            async def hang(self):
                try:
                    await asyncio.sleep(300)
                except asyncio.CancelledError:
                    self.cancelled += 1
                    raise

            async def quick(self):
                return {"cancelled": self.cancelled}

        serve.run(Slow.bind(), name="slow", route_prefix="/slow")
        h = serve.get_deployment_handle("Slow", "slow")
        resp = h.options(method_name="hang").remote()
        time.sleep(1.0)
        resp.cancel()
        try:
            resp.result(timeout_s=60)
            cancelled = False
        except Exception as e:  # noqa: BLE001 - the runtime's cancellation error
            cancelled = "ancel" in type(e).__name__ or "ancel" in str(e)
        out = [cancelled, h.options(method_name="quick").remote().result(timeout_s=60)]
        t0 = time.time()
        try:
            h.options(method_name="hang", timeout_s=2).remote().result()
        except TimeoutError as e:
            out.append((str(e), time.time() - t0 < 30))
        serve.delete("slow")
        return out

    assert _on_both(sessions, program) == [True, {"cancelled": 1},
                                           ("request timed out after 2s (cancelled)", True)]


APP_MODULE = """
    import {serve} as serve

    @serve.deployment
    class Echo:
        def __init__(self, prefix="x"):
            self.prefix = prefix
            self.cfg = {{}}

        def reconfigure(self, user_config):
            self.cfg = dict(user_config)

        def __call__(self, request):
            return {{"prefix": self.prefix, "cfg": self.cfg}}

    app = Echo.bind("hello")

    def builder(prefix="built"):
        return Echo.bind(prefix)
"""


def test_config_deploy_roundtrip(sessions, tmp_path):
    """A YAML config through deploy_config, then build_app_config's config
    deployed again, each package on a module that imports its serve."""
    import yaml
    for tag, serve_name in (("jax", "ray_tpu.serve"), ("port", "ray_tpu_torch.serve")):
        (tmp_path / f"cfgapp_{tag}.py").write_text(
            textwrap.dedent(APP_MODULE.format(serve=serve_name)))
    sys.path.insert(0, str(tmp_path))

    def program(rt_, serve, port):
        mod = f"cfgapp_{'jax' if serve is jserve else 'port'}"
        cfg = {"applications": [
            {"name": "a1", "import_path": f"{mod}:app", "route_prefix": "/a1",
             "deployments": [{"name": "Echo", "num_replicas": 2, "user_config": {"beam": 4}}]},
            {"name": "a2", "import_path": f"{mod}:builder", "route_prefix": "/a2",
             "args": {"prefix": "fromargs"}}]}
        path = tmp_path / f"{mod}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        handles = serve.deploy_config(str(path), start_http=False)
        out = [sorted(handles), handles["a1"].remote(None).result(timeout_s=60),
               handles["a2"].remote(None).result(timeout_s=60), serve.status()["a1:Echo"]]
        built = serve.build_app_config(__import__(mod).app, f"{mod}:app", name="a3",
                                       route_prefix="/a3")
        out.append(json.loads(json.dumps(built).replace(mod, "<mod>")))
        out.append(serve.deploy_config(built, start_http=False)["a3"].remote(None).result(
            timeout_s=60))
        for name in ("a1", "a2", "a3"):
            serve.delete(name)
        return out

    try:
        got = _on_both(sessions, program)
    finally:
        sys.path.remove(str(tmp_path))
    assert got[1] == {"prefix": "hello", "cfg": {"beam": 4}} and got[3] == {"replicas": 2}


def test_grpc_ingress_roundtrip(sessions):
    """Unary, streaming, health and the app list over a real channel; an
    unknown app is INTERNAL. The port's service is `ray_tpu_torch.serve.Ingress`."""
    import grpc

    def program(rt_, serve, port):
        @serve.deployment
        class Calc:
            def __call__(self, x):
                return {"doubled": x * 2}

            def gen(self, n):
                for i in range(n):
                    yield {"i": i}

        serve.run(Calc.bind(), name="calc", route_prefix="/calc")
        serve.start(http_options={"port": 0}, grpc_options={"port": 0})
        service = "/ray_tpu.serve.Ingress/" if serve is jserve else "/ray_tpu_torch.serve.Ingress/"
        ch = grpc.insecure_channel(f"127.0.0.1:{serve.grpc_port()}")
        call = lambda m, req: ch.unary_unary(service + m)(req, timeout=60)
        out = [pickle.loads(call("Predict", pickle.dumps({"app": "calc", "args": (21,)}))),
               call("Healthz", b""), "calc" in pickle.loads(call("ListApplications", b"")),
               [pickle.loads(b) for b in ch.unary_stream(service + "PredictStream")(
                   pickle.dumps({"app": "calc", "method": "gen", "args": (3,)}), timeout=60)]]
        try:
            call("Predict", pickle.dumps({"app": "nope", "args": ()}))
        except grpc.RpcError as e:
            out.append(e.code() == grpc.StatusCode.INTERNAL)
        ch.close()
        serve.delete("calc")
        return out

    assert _on_both(sessions, program) == [{"doubled": 42}, b"ok", True,
                                           [{"i": 0}, {"i": 1}, {"i": 2}], True]


def test_http_body_size_cap(sessions, monkeypatch):
    """A body over RAY_TPU_MAX_HTTP_BODY is a 413, by Content-Length and
    mid-chunked; the proxy reads the cap at its start, so each package's
    proxy is started again under the variable (and once more without it)."""
    def program(rt_, serve, port):
        serve.shutdown()
        port = serve.start(http_options={"port": 0})

        @serve.deployment
        def echo(request):
            return {"n": len(request.body)}

        serve.run(echo.bind(), name="cap", route_prefix="/cap")
        out = [_raw(port, b"POST /cap HTTP/1.1\r\nHost: x\r\nContent-Length: 99999\r\n\r\n"),
               _raw(port, b"POST /cap HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                    + _chunked(b"x" * 600, b"x" * 600)),
               _raw(port, b"POST /cap HTTP/1.1\r\nHost: x\r\nContent-Length: 3\r\n\r\nabc")]
        serve.shutdown()
        return out

    monkeypatch.setenv("RAY_TPU_MAX_HTTP_BODY", "1024")
    got = _on_both(sessions, program)
    monkeypatch.delenv("RAY_TPU_MAX_HTTP_BODY")
    assert got == [b"HTTP/1.1 413 Payload Too Large\r\n\r\nbody of 99999 bytes exceeds 1024",
                   b"HTTP/1.1 413 Payload Too Large\r\n\r\nchunked body exceeds 1024 bytes",
                   b'HTTP/1.1 200 OK\r\n\r\n{"n": 3}']


def test_cli_deploy_matches_jax(tmp_path):
    """`python -m <package>.serve deploy <config> --non-blocking` in a fresh
    interpreter (its own session) prints the same deployed apps and status
    for both packages."""
    import os
    import subprocess
    for tag, serve_name in (("jax", "ray_tpu.serve"), ("port", "ray_tpu_torch.serve")):
        (tmp_path / f"cliapp_{tag}.py").write_text(
            textwrap.dedent(APP_MODULE.format(serve=serve_name)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path)] + sys.path))
    env.pop("RTPT_ADDRESS", None)
    env.pop("RAY_TPU_ADDRESS", None)
    out = {}
    for tag, pkg in (("jax", "ray_tpu.serve"), ("port", "ray_tpu_torch.serve")):
        cfg = tmp_path / f"cli_{tag}.json"
        cfg.write_text(json.dumps({"applications": [
            {"name": "cli", "import_path": f"cliapp_{tag}:app", "route_prefix": "/cli",
             "deployments": [{"name": "Echo", "num_replicas": 2}]}],
            "http_options": {"port": 0}}))
        run = subprocess.run([sys.executable, "-m", pkg, "deploy", str(cfg), "--non-blocking"],
                             capture_output=True, text=True, timeout=240, env=env, cwd=tmp_path)
        assert run.returncode == 0, run.stderr[-2000:]
        out[tag] = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["port"] == out["jax"] == {"deployed": ["cli"],
                                         "status": {"cli:Echo": {"replicas": 2}}}
