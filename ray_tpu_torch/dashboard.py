"""Dashboard HTTP surface (reference: python/ray/dashboard/dashboard.py +
dashboard/modules/job/job_head.py REST routes), on the port's runtime.

One zero-CPU actor serving JSON over the same hand-rolled asyncio HTTP/1.1
plumbing as the serve proxy (serve/proxy.py read_http_request, which loads
no torch: neither does this actor's process). The CLI (`python -m
ray_tpu_torch dashboard`, `python -m ray_tpu_torch job --address
http://...`) and any browser/curl share this one surface:

  GET  /api/version            build + session info
  GET  /api/cluster_status     resources (cards as "GPU") + store usage
  GET  /api/nodes|actors|tasks|objects|workers    state-API snapshots
  GET  /api/metrics | /metrics Prometheus text exposition (all registries)
  GET  /api/timeline           Chrome trace_event JSON (Perfetto-loadable)
  GET  /api/jobs/              list jobs
  POST /api/jobs/              {entrypoint, submission_id?, runtime_env?, metadata?}
  GET  /api/jobs/{id}          job info
  GET  /api/jobs/{id}/logs     {"logs": ..., "next_offset": N, "terminal": bool}
  POST /api/jobs/{id}/stop     {"stopped": bool}
"""

import asyncio
import json
import traceback
from typing import Tuple

from ray_tpu_torch.serve.proxy import (Request, Response, _BadRequest,
                                 _coerce_response, read_http_request,
                                 write_http_response)

DASHBOARD_ACTOR_NAME = "_rtpt_dashboard"
DASHBOARD_NAMESPACE = "_system"


class DashboardActor:
    """max_concurrency>1 async actor: the asyncio server shares the loop."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self._host = host
        self._port = port
        self._server = None
        self._mgr = None

    async def ready(self) -> int:
        if self._server is None:
            self._server = await asyncio.start_server(
                self._serve_client, self._host, self._port)
            self._port = self._server.sockets[0].getsockname()[1]
        return self._port

    def _job_manager(self):
        if self._mgr is None:
            from ray_tpu_torch.job_submission import _get_or_create_manager
            self._mgr = _get_or_create_manager()
        return self._mgr

    async def _serve_client(self, reader, writer):
        try:
            while True:
                try:
                    req = await read_http_request(reader)
                except _BadRequest as e:
                    await write_http_response(writer, Response(
                        str(e).encode(), e.status, media_type="text/plain"))
                    break
                if req is None:
                    break
                try:
                    resp = await self._route(req)
                except ValueError as e:
                    resp = Response(json.dumps({"error": str(e)}).encode(), 404)
                except Exception as e:  # noqa: BLE001 - handler error → 500
                    resp = Response(json.dumps({
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()}).encode(), 500)
                await write_http_response(writer, resp)
                if req.headers.get("connection", "").lower() == "close":
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _route(self, req: Request) -> Response:
        from ray_tpu_torch._private import state as _state
        path = req.path.rstrip("/") or "/"
        client = _state.global_client()

        if path == "/":
            return Response(_INDEX_HTML.encode(), 200,
                            media_type="text/html; charset=utf-8")
        if path == "/api/version":
            from ray_tpu_torch._version import __version__
            return _coerce_response({
                "ray_tpu_torch_version": __version__, "session": client.job_id})
        if path == "/api/cluster_status":
            total, avail = client.resources()
            nodes = client.state("nodes")
            return _coerce_response({
                "total_resources": total, "available_resources": avail,
                "nodes": nodes})
        if path in ("/api/nodes", "/api/actors", "/api/tasks", "/api/objects",
                    "/api/workers", "/api/placement_groups"):
            return _coerce_response(client.state(path.rsplit("/", 1)[-1]))
        if path == "/api/autoscaler":
            return _coerce_response(client.autoscaler_status())
        if path == "/api/cluster":
            return _coerce_response(client.state("cluster_health"))
        if path == "/api/alerts":
            return _coerce_response(client.state("alerts"))
        if path == "/api/chaos":
            # dev fault-injection surface (_private/chaos.py): GET = head
            # injector snapshot + live node pid map; POST = {"op": ...}
            # (configure / drop_object / kill_node) executed at the head
            if req.method == "POST":
                try:
                    op = req.json() or {}
                except json.JSONDecodeError as e:
                    return Response(
                        json.dumps({"error": f"invalid JSON body: {e}"}).encode(),
                        400)
                return _coerce_response(client.chaos_op(op))
            return _coerce_response(client.chaos_op({"op": "snapshot"}))
        if path == "/api/_boom":
            # test hook: exercises the JSON-500 error path end to end
            raise RuntimeError("boom (dashboard 500 test hook)")
        if path in ("/api/metrics", "/metrics"):
            # Prometheus text exposition of every util.metrics
            # Counter/Gauge/Histogram: the controller process's registry
            # (scheduler/prefetch/transfer series, fetched over the state
            # RPC) merged with this process's, plus cluster-level gauges
            # synthesized from controller state (ref: ray's metrics agent
            # exporting over an HTTP scrape port)
            snaps = _cluster_snapshots(client) + _registry_snapshots(client)
            return Response(_prometheus_text(snaps).encode(), 200,
                            media_type="text/plain; version=0.0.4")
        if path == "/api/timeline":
            # Chrome trace_event JSON (complete events, us timestamps) —
            # load in Perfetto / chrome://tracing. The head aggregates
            # phase spans from every node's heartbeat, so this is the
            # cluster-wide task timeline.
            events = client.timeline()
            body = json.dumps(events).encode()
            return Response(body, 200, media_type="application/json")

        if path == "/api/jobs":
            loop = asyncio.get_running_loop()
            if req.method == "POST":
                try:
                    spec = req.json() or {}
                except json.JSONDecodeError as e:
                    return Response(
                        json.dumps({"error": f"invalid JSON body: {e}"}).encode(),
                        400)
                if "entrypoint" not in spec:
                    return Response(b'{"error": "entrypoint required"}', 400)
                rte = spec.get("runtime_env") or {}
                jid = await loop.run_in_executor(None, self._submit, spec, rte)
                return _coerce_response({"submission_id": jid})
            rows = await loop.run_in_executor(None, self._mgr_call, "list")
            return _coerce_response(rows)

        if path.startswith("/api/jobs/"):
            rest = path[len("/api/jobs/"):]
            loop = asyncio.get_running_loop()
            if rest.endswith("/logs"):
                jid = rest[:-len("/logs")]
                offset = int(req.query_params.get("offset", "0"))
                chunk, nxt, terminal = await loop.run_in_executor(
                    None, self._mgr_call, "logs", jid, offset)
                return _coerce_response({
                    "logs": chunk.decode("utf-8", "replace"),
                    "next_offset": nxt, "terminal": terminal})
            if rest.endswith("/stop") and req.method == "POST":
                jid = rest[:-len("/stop")]
                stopped = await loop.run_in_executor(
                    None, self._mgr_call, "stop", jid)
                return _coerce_response({"stopped": stopped})
            info = await loop.run_in_executor(
                None, self._mgr_call, "get_info", rest)
            return _coerce_response(info)

        return Response(json.dumps({"error": f"no route {path}"}).encode(), 404)

    # blocking helpers run on the default executor so replica IO can't stall
    # other dashboard connections
    def _submit(self, spec, rte):
        import ray_tpu_torch as rt
        return rt.get(self._job_manager().submit.remote(
            spec["entrypoint"], spec.get("submission_id"),
            rte.get("env_vars"), rte.get("working_dir"),
            spec.get("metadata")), timeout=60)

    def _mgr_call(self, method, *args):
        import ray_tpu_torch as rt
        return rt.get(
            getattr(self._job_manager(), method).remote(*args), timeout=60)

    def stats(self):
        return {"host": self._host, "port": self._port}


# Single-file web UI (ref: ray's dashboard SPA — ours is one page over the
# same /api endpoints the CLI uses; no build step, no bundled JS framework).
_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
 body{font-family:ui-monospace,Menlo,monospace;margin:2rem;background:#111;color:#ddd}
 h1{font-size:1.2rem} h2{font-size:1rem;margin:1.2rem 0 .4rem;color:#9cf}
 table{border-collapse:collapse;width:100%;font-size:.85rem}
 td,th{border:1px solid #333;padding:.25rem .5rem;text-align:left}
 th{background:#1c1c1c;color:#9cf} .num{text-align:right}
 #err{color:#f66}
</style></head><body>
<h1>ray_tpu_torch dashboard <span id="session"></span></h1><div id="err"></div>
<h2>cluster</h2><table id="cluster"></table>
<h2>autoscaler</h2><table id="auto"></table>
<h2>actors</h2><table id="actors"></table>
<h2>jobs</h2><table id="jobs"></table>
<h2>recent tasks</h2><table id="tasks"></table>
<script>
const J = p => fetch(p).then(r => r.json());
// API strings (names, entrypoints) are user-controlled: escape before innerHTML
const esc = s => String(s).replace(/[&<>"']/g,
  ch => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[ch]));
const row = cs => "<tr>" + cs.map(c => `<td>${esc(c)}</td>`).join("") + "</tr>";
const head = cs => "<tr>" + cs.map(c => `<th>${esc(c)}</th>`).join("") + "</tr>";
async function refresh(){
 try{
  const v = await J("/api/version");
  document.getElementById("session").textContent = "(session " + v.session + ")";
  const s = await J("/api/cluster_status");
  document.getElementById("cluster").innerHTML = head(["resource","total","available"]) +
   Object.keys(s.total_resources).map(k =>
     row([k, s.total_resources[k], s.available_resources[k] ?? 0])).join("");
  const a = await J("/api/autoscaler");
  document.getElementById("auto").innerHTML = head(["pool workers","idle","pending tasks","max workers"]) +
   row([a.pool_workers, a.idle_workers, a.pending_tasks, a.max_workers]);
  const actors = await J("/api/actors");
  document.getElementById("actors").innerHTML = head(["actor","name","state","pid","restarts"]) +
   actors.map(x => row([x.actor_id, x.name ?? "", x.state, x.pid ?? "", x.restarts])).join("");
  const jobs = await J("/api/jobs");
  document.getElementById("jobs").innerHTML = head(["id","status","entrypoint"]) +
   jobs.map(j => row([j.submission_id, j.status, j.entrypoint ?? ""])).join("");
  const tasks = await J("/api/tasks");
  document.getElementById("tasks").innerHTML = head(["task","name","state","duration_s"]) +
   tasks.slice(0, 25).map(t =>
     row([t.task_id, t.name ?? "", t.state, t.duration_s ? t.duration_s.toFixed(3) : ""])).join("");
  document.getElementById("err").textContent = "";
 }catch(e){ document.getElementById("err").textContent = "refresh failed: " + e; }
}
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""


def _registry_snapshots(client):
    """Controller-process registry (state RPC) merged with this process's
    own; the controller wins name collisions — it owns the shared series
    (both processes register e.g. nothing today, but the merge keeps the
    scrape well-formed if that changes: one TYPE block per name)."""
    from ray_tpu_torch.util.metrics import collect
    try:
        head = client.state("metrics")
    except Exception:  # noqa: BLE001 - a scrape never fails the endpoint
        head = []
    seen = {m["name"] for m in head}
    return head + [m for m in collect() if m["name"] not in seen]


def _cluster_snapshots(client):
    """Cluster health as metric snapshots (resources, workers, store, demand)."""
    total, avail = client.resources()
    auto = client.autoscaler_status()
    node = client.state("nodes")[0]
    by_state: dict = {}
    for w in client.state("workers"):
        k = (("state", w["state"]),)
        by_state[k] = by_state.get(k, 0) + 1
    gauge = lambda name, desc, values: {
        "type": "gauge", "name": name, "description": desc, "values": values}
    tagged = lambda d, tag: {((tag, k),): v for k, v in d.items()}
    return [
        gauge("ray_tpu_torch_resource_total", "cluster resource totals",
              tagged(total, "resource")),
        gauge("ray_tpu_torch_resource_available", "cluster resources available",
              tagged(avail, "resource")),
        gauge("ray_tpu_torch_workers", "worker processes by state", by_state),
        gauge("ray_tpu_torch_pool_workers", "alive pool workers",
              {(): auto["pool_workers"]}),
        gauge("ray_tpu_torch_pending_tasks", "tasks waiting for dispatch",
              {(): auto["pending_tasks"]}),
        gauge("ray_tpu_torch_object_store_used_bytes", "shm store bytes in use",
              {(): node["object_store_used"]}),
        gauge("ray_tpu_torch_object_store_capacity_bytes", "shm store capacity",
              {(): node["object_store_capacity"]}),
    ]


def _esc_label(v) -> str:
    """Label-value escaping per the text exposition format: backslash,
    double quote, and newline must be escaped or the sample line is
    unparseable."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _esc_help(v) -> str:
    # HELP text: only backslash and newline are escaped (quotes are legal)
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _prometheus_text(snapshots) -> str:
    """Render util.metrics snapshots in Prometheus text exposition format
    (ref: ray's metrics agent scrape endpoint). Conformant: label values
    escaped, # HELP/# TYPE emitted once per family even when the same name
    shows up in several merged registries, counters suffixed `_total`."""
    def lbl(k, extra=()):
        items = tuple(k) + tuple(extra)
        if not items:
            return ""
        return ("{" + ",".join(f'{a}="{_esc_label(b)}"' for a, b in items)
                + "}")

    lines = []
    seen = set()
    for m in snapshots:
        name = m["name"].replace(".", "_").replace("-", "_")
        if m["type"] == "counter" and not name.endswith("_total"):
            name += "_total"
        if name not in seen:
            seen.add(name)
            if m.get("description"):
                lines.append(f"# HELP {name} {_esc_help(m['description'])}")
            lines.append(f"# TYPE {name} {m['type']}")
        if m["type"] in ("counter", "gauge"):
            for k, v in m["values"].items():
                lines.append(f"{name}{lbl(k)} {v}")
        else:  # histogram
            for k, buckets in m["buckets"].items():
                cum = 0
                for bound, cnt in zip(m["boundaries"], buckets):
                    cum += cnt
                    lines.append(f'{name}_bucket{lbl(k, (("le", bound),))} {cum}')
                cum += buckets[len(m["boundaries"])]
                lines.append(f'{name}_bucket{lbl(k, (("le", "+Inf"),))} {cum}')
                lines.append(f"{name}_sum{lbl(k)} {m['sum'][k]}")
                lines.append(f"{name}_count{lbl(k)} {m['count'][k]}")
    return "\n".join(lines) + "\n"


def start_dashboard(host: str = "127.0.0.1", port: int = 8265
                    ) -> Tuple[object, int]:
    """Get-or-start the dashboard actor; returns (handle, bound_port)."""
    import ray_tpu_torch as rt
    try:
        actor = rt.get_actor(DASHBOARD_ACTOR_NAME,
                                  namespace=DASHBOARD_NAMESPACE)
    except ValueError:
        cls = rt.remote(num_cpus=0, max_concurrency=16)(DashboardActor)
        try:
            actor = cls.options(name=DASHBOARD_ACTOR_NAME,
                                namespace=DASHBOARD_NAMESPACE,
                                lifetime="detached").remote(host, port)
        except ValueError:
            actor = rt.get_actor(DASHBOARD_ACTOR_NAME,
                                      namespace=DASHBOARD_NAMESPACE)
    bound = rt.get(actor.ready.remote(), timeout=60)
    return actor, bound
