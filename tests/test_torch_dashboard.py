"""The dashboard's observability surface of `ray_tpu_torch` against
`ray_tpu`'s, on the programs of JAX's `tests/test_dashboard_http.py`.

One scenario is written once against a package and run for each in a
fresh interpreter of its own, both at once: a session (JAX's with
`num_tpus=1`, the port's with `num_gpus=1`), the dashboard on port 0, and
the ten programs that need it: the Prometheus scrape (parsed with JAX's
own parser, `test_dashboard_http._parse_prometheus`), the chrome trace,
the task rows' phases, `/api/cluster`, `/api/alerts`, and the 404, 500
and 400 answers. The readings are compared after the names that differ
by design are mapped (`test_torch_jobs.normalize`): HTTP codes and media
types, the JSON keys of every route, the metric families and their types.
The label-escaping case needs no session and runs in process on both
packages' `_prometheus_text`.

No jax at this module's top: the scenarios import it in their own
interpreters, the port's never."""

import importlib
import json
import socket
import time
import urllib.error
import urllib.request

import pytest
from test_dashboard_http import _parse_prometheus
from test_torch_jobs import ACCEL, PACKAGES, normalize, result, spawn


def _get(base, path):
    """(code, media type, body) of a GET; an HTTP error is an answer too."""
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.headers["Content-Type"].split(";")[0], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"].split(";")[0], e.read()


def _typed_invariant(text):
    """Every sample line's metric name has a TYPE (test_dashboard_http.py's
    structural check); returns the names that break it."""
    typed = {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}
    bad = []
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        name = ln.split("{")[0].split()[0]
        base_name = name
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) and name[:-len(suf)] in typed:
                base_name = name[:-len(suf)]
        if base_name not in typed:
            bad.append(ln)
    return bad


def _scenario(pkg):
    """test_dashboard_http.py's programs against `pkg`; returns the
    readings."""
    rt = importlib.import_module(pkg)
    dash = importlib.import_module(f"{pkg}.dashboard")
    kw, _, _ = ACCEL[pkg]
    rt.init(num_cpus=4, **{kw: 1})
    _actor, port = dash.start_dashboard(port=0)
    base = f"http://127.0.0.1:{port}"
    out = {}

    # test_metrics_prometheus_exposition, once the controller's reaper has
    # set the store tier gauges (its first spill scan, 1 s after start)
    rt.get(rt.remote(lambda: 1).remote())
    deadline = time.time() + 10
    code, ctype, body = _get(base, "/api/metrics")
    while b"store_tier_shm_bytes" not in body and time.time() < deadline:
        time.sleep(0.1)
        code, ctype, body = _get(base, "/api/metrics")
    text = body.decode()
    types, samples = _parse_prometheus(text)
    out["metrics"] = dict(code=code, ctype=ctype, workers=f"# TYPE {pkg}_workers gauge" in text,
                          cpu_total=f'{pkg}_resource_total{{resource="CPU"}}' in text,
                          result_async="# TYPE result_async_tasks_total counter" in text,
                          no_unsuffixed="# TYPE result_async_tasks counter" not in text,
                          untyped=_typed_invariant(text))
    out["families"] = sorted(types.items())
    _, _, alias = _get(base, "/metrics")
    out["alias_has_workers"] = f"# TYPE {pkg}_workers gauge".encode() in alias

    # test_timeline_chrome_trace
    @rt.remote
    def traced(x):
        return x + 1

    out["traced"] = rt.get([traced.remote(i) for i in range(4)])
    code, ctype, body = _get(base, "/api/timeline")
    events = json.loads(body)
    phase_evs = [e for e in events if e.get("cat") == "task_phase"]
    by_task = {}
    for e in phase_evs:
        by_task.setdefault(e["args"]["task_id"], set()).add(e["args"]["phase"])
    out["timeline"] = dict(
        code=code, ctype=ctype, is_list=isinstance(events, list), any_phase=bool(phase_evs),
        complete=all(e["ph"] == "X" and "ts" in e and e["dur"] >= 0 for e in phase_evs),
        ids=all(e["args"]["trace_id"] and e["args"]["task_id"] for e in phase_evs),
        full_split=any({"queued", "exec", "publish"} <= ph for ph in by_task.values()),
        derived_trace=any(e["args"]["trace_id"] == e["args"]["task_id"] for e in phase_evs),
        arg_keys=sorted({k for e in phase_evs for k in e["args"]}))

    # test_task_state_rows_carry_phases
    rt.get(rt.remote(lambda: "ok").remote())
    rows = json.loads(_get(base, "/api/tasks")[2])
    done = [r for r in rows if r.get("phases")]
    out["task_rows"] = dict(
        any_done=bool(done),
        phases=bool(done) and {"queued", "exec", "publish"} <= set(done[0]["phases"]),
        nonneg=bool(done) and all(v >= 0 for v in done[0]["phases"].values()),
        keys=sorted({k for r in rows for k in r}))

    # test_live_scrape_parses_clean
    rt.get(rt.remote(lambda: 1).remote())
    types, samples = _parse_prometheus(_get(base, "/api/metrics")[2].decode())
    out["live_scrape"] = dict(samples=bool(samples),
                              counters_total=all(n.endswith("_total") for n, t in types.items()
                                                 if t == "counter"))

    # test_cluster_health_endpoint
    rt.get(rt.remote(lambda: 1).remote())
    health = json.loads(_get(base, "/api/cluster")[2])
    head = health["nodes"][0]
    out["health"] = dict(keys=sorted(health), head_keys=sorted(head), is_head=head["is_head"],
                         alive=head["alive"], capacity=head["store_capacity"] > 0,
                         resources=sorted(health["resources"]),
                         total=sorted(health["resources"]["total"]))

    # test_alerts_endpoint
    code, ctype, body = _get(base, "/api/alerts")
    alerts = json.loads(body)
    out["alerts"] = dict(code=code, ctype=ctype, is_list=isinstance(alerts, list),
                         keys_ok=all({"id", "ts", "kind", "key", "severity", "message"} <= set(ev)
                                     for ev in alerts))

    # test_unknown_route_is_404_json
    code, ctype, body = _get(base, "/api/nonsense")
    out["404"] = [code, ctype, json.loads(body)["error"]]

    # test_handler_exception_is_500_json
    code, ctype, body = _get(base, "/api/_boom")
    payload = json.loads(body)
    out["500"] = [code, ctype, payload["error"], "boom" in payload["traceback"]]

    # test_bad_job_body_is_400
    req = urllib.request.Request(base + "/api/jobs/", data=b"{not json", method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        urllib.request.urlopen(req, timeout=30)
        out["400"] = None
    except urllib.error.HTTPError as e:
        out["400"] = [e.code, json.loads(e.read())["error"]]

    # test_malformed_http_request_is_400
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(b"GET /api/version HTTP/1.1\r\nContent-Length: banana\r\n\r\n")
        s.settimeout(30)
        out["malformed"] = s.recv(4096)[:12].decode()
    rt.shutdown()
    return out


@pytest.fixture(scope="module")
def readings():
    procs = {pkg: spawn("test_torch_dashboard", "_scenario", pkg) for pkg in PACKAGES}
    return {pkg: result(proc) for pkg, proc in procs.items()}


def _same(readings, *keys):
    for key in keys:
        port, jax_side = readings["ray_tpu_torch"][key], readings["ray_tpu"][key]
        assert normalize(port, "ray_tpu_torch") == normalize(jax_side, "ray_tpu"), key


def test_metrics_prometheus_exposition(readings):
    """The same families, each of the same type, in both scrapes; the
    cluster gauges, the controller's counters with `_total`, every sample
    typed, /metrics an alias."""
    _same(readings, "metrics", "families", "alias_has_workers")
    got = readings["ray_tpu_torch"]
    assert got["metrics"] == dict(code=200, ctype="text/plain", workers=True, cpu_total=True,
                                  result_async=True, no_unsuffixed=True, untyped=[])
    assert got["alias_has_workers"]


def test_timeline_chrome_trace(readings):
    _same(readings, "traced", "timeline")
    got = readings["ray_tpu_torch"]["timeline"]
    assert got["code"] == 200 and got["ctype"] == "application/json" and got["is_list"]
    assert all(got[k] for k in ("any_phase", "complete", "ids", "full_split", "derived_trace"))


def test_task_state_rows_carry_phases(readings):
    _same(readings, "task_rows")
    got = readings["ray_tpu_torch"]["task_rows"]
    assert got["any_done"] and got["phases"] and got["nonneg"]


def test_prometheus_label_escaping_round_trip():
    """test_dashboard_http.py's nasty labels through each package's
    `_prometheus_text`: equal texts, and JAX's parser reads back every
    value, one TYPE and HELP a family, `_total` once."""
    nasty = 'a\\b"c\nd'
    snaps = [
        {"type": "counter", "name": "rt_evil", "description": 'has "quotes"',
         "values": {(("tag", nasty),): 3.0}},
        {"type": "counter", "name": "rt_evil", "description": 'has "quotes"',
         "values": {(("tag", "plain"),): 1.0}},
        {"type": "counter", "name": "rt_done_total", "description": "",
         "values": {(): 2.0}},
        {"type": "gauge", "name": "rt_gauge", "description": "",
         "values": {(("node", "n\\1"),): 7.5}},
        {"type": "histogram", "name": "rt_hist", "description": "h",
         "boundaries": [1.0, 2.0], "buckets": {(("k", 'q"v'),): [1, 2, 3]},
         "sum": {(("k", 'q"v'),): 9.0}, "count": {(("k", 'q"v'),): 6}},
    ]
    texts = {pkg: importlib.import_module(f"{pkg}.dashboard")._prometheus_text(snaps)
             for pkg in PACKAGES}
    assert texts["ray_tpu_torch"] == texts["ray_tpu"]
    text = texts["ray_tpu_torch"]
    types, samples = _parse_prometheus(text)
    assert types["rt_evil_total"] == "counter" and "rt_evil" not in types
    assert types["rt_done_total"] == "counter" and "rt_done_total_total" not in types
    assert text.count("# TYPE rt_evil_total") == 1 and text.count("# HELP rt_evil_total") == 1
    by_name = {}
    for name, labels, value in samples:
        by_name.setdefault(name, []).append((labels, value))
    assert ({"tag": nasty}, 3.0) in by_name["rt_evil_total"]
    assert ({"tag": "plain"}, 1.0) in by_name["rt_evil_total"]
    assert ({"node": "n\\1"}, 7.5) in by_name["rt_gauge"]
    buckets = by_name["rt_hist_bucket"]
    assert ({"k": 'q"v', "le": "1.0"}, 1.0) in buckets
    assert ({"k": 'q"v', "le": "2.0"}, 3.0) in buckets
    assert ({"k": 'q"v', "le": "+Inf"}, 6.0) in buckets
    assert by_name["rt_hist_sum"] == [({"k": 'q"v'}, 9.0)]
    assert by_name["rt_hist_count"] == [({"k": 'q"v'}, 6.0)]


def test_live_scrape_parses_clean(readings):
    _same(readings, "live_scrape")
    assert readings["ray_tpu_torch"]["live_scrape"] == dict(samples=True, counters_total=True)


def test_cluster_health_endpoint(readings):
    """The same top-level and head-row keys; the port's totals name its
    card "GPU"."""
    _same(readings, "health")
    got = readings["ray_tpu_torch"]["health"]
    assert {"ts", "nodes", "resources", "queue", "alerts", "leaks"} <= set(got["keys"])
    assert got["is_head"] and got["alive"] and got["capacity"]
    assert {"queue_depth", "workers_busy", "workers_idle", "store_used", "store_capacity",
            "store_objects"} <= set(got["head_keys"])
    assert "GPU" in got["total"]


def test_alerts_endpoint(readings):
    _same(readings, "alerts")
    assert readings["ray_tpu_torch"]["alerts"] == dict(code=200, ctype="application/json",
                                                       is_list=True, keys_ok=True)


def test_unknown_route_is_404_json(readings):
    _same(readings, "404")
    code, ctype, error = readings["ray_tpu_torch"]["404"]
    assert code == 404 and ctype == "application/json" and "no route" in error


def test_handler_exception_is_500_json(readings):
    _same(readings, "500")
    code, ctype, error, tb = readings["ray_tpu_torch"]["500"]
    assert code == 500 and ctype == "application/json" and "RuntimeError" in error and tb


def test_bad_job_body_is_400(readings):
    _same(readings, "400")
    code, error = readings["ray_tpu_torch"]["400"]
    assert code == 400 and "invalid JSON" in error


def test_malformed_http_request_is_400(readings):
    _same(readings, "malformed")
    assert readings["ray_tpu_torch"]["malformed"] == "HTTP/1.1 400"
