"""Job submission, the job half of the dashboard and the CLI's `job` and
`status` commands of `ray_tpu_torch` against `ray_tpu`'s, on the programs
of JAX's `tests/test_jobs.py`.

One scenario is written once against a package and run for each in a
fresh interpreter of its own, both at once (as `test_torch_runtime.py`
does): a session with one accelerator (`num_tpus=1` for JAX, `num_gpus=1`
for the port), the ten programs of `test_jobs.py`, and the port's cases:
a stopped job whose actor holds the accelerator gives it back, the job
manager, the dashboard, a job's driver that only submits tasks and
`status` load no torch, and `/api/cluster_status` and `status` report the
card as "GPU". What each gives is compared after the names that differ by
design are mapped to one word (the package, the accelerator, the system
actors' prefix, a job id's prefix): job statuses, exit codes and logs,
HTTP codes and the JSON keys of every route, the Prometheus series, the
CLI's output fields.

No jax at this module's top: the scenarios import it in their own
interpreters, the port's never."""

import base64
import importlib
import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")
# package -> (accelerator kwarg, resource key, the session's address variable)
ACCEL = {"ray_tpu": ("num_tpus", "TPU", "RAY_TPU_ADDRESS"),
         "ray_tpu_torch": ("num_gpus", "GPU", "RTPT_ADDRESS")}
# names that differ by design, each mapped to one word (longest first)
NAMES = {"ray_tpu": (("ray_tpu", "PKG"), ("TPU", "ACCEL"), ("_rtpu_", "_SYS_"),
                     ("rtpu-job-", "JOB-")),
         "ray_tpu_torch": (("ray_tpu_torch", "PKG"), ("GPU", "ACCEL"), ("_rtpt_", "_SYS_"),
                           ("rtpt-job-", "JOB-"))}
HOLD_LIMIT_S = 30.0     # a stopped job's accelerator is free again within this


def normalize(obj, pkg):
    """`obj` (JSON-able) with the names that differ by design mapped."""
    text = json.dumps(obj, sort_keys=True)
    for old, new in NAMES[pkg]:
        text = text.replace(old, new)
    return json.loads(text)


def _script(body):
    """A `python -c` entrypoint running `body` (base64, so no quoting)."""
    b64 = base64.b64encode(body.encode()).decode()
    return f"{sys.executable} -u -c \"import base64; exec(base64.b64decode('{b64}'))\""


def _maps_load(pid):
    """Which of libtorch and jaxlib a live process has mapped."""
    maps = Path(f"/proc/{pid}/maps").read_text()
    return [lib for lib in ("libtorch", "jaxlib") if lib in maps]


# the held accelerator's job: an unnamed actor claims it and is called
# until the job is stopped
HOLD_JOB = """
import importlib, time
rt = importlib.import_module({pkg!r})
rt.init(address="auto")

class Holder:
    def ids(self):
        return True

h = rt.remote(**{{{kw!r}: 1}})(Holder).remote()
print("holding", rt.get(h.ids.remote(), timeout=120), flush=True)
while True:
    rt.get(h.ids.remote(), timeout=120)
    time.sleep(0.05)
"""

# a job's driver that only submits tasks: which of torch, jax and the
# other package it loaded
TASKS_JOB = """
import importlib, sys
rt = importlib.import_module({pkg!r})
rt.init(address="auto")
f = rt.remote(lambda x: x * 3)
print("result:", rt.get(f.remote(14), timeout=120))
print("loaded:", sorted({{m.split(".")[0] for m in sys.modules}} & {{"torch", "jax", {other!r}}}))
rt.shutdown()
"""

# an actor class in a module that only the job's working dir holds
WORKDIR_MODULE = """
import importlib, os

class Where:
    def cwd_module(self):
        return __name__

def main(pkg):
    rt = importlib.import_module(pkg)
    rt.init(address="auto")
    a = rt.remote(num_cpus=0)(Where).remote()
    print("module:", rt.get(a.cwd_module.remote(), timeout=120), flush=True)
"""


def _http(base, path):
    """(code, content type, body) of a GET; an HTTP error is an answer too."""
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _keys(rows):
    return sorted({k for r in rows for k in r})


def _scenario(pkg, workdir):
    """test_jobs.py's programs and the port's cases, run against `pkg`;
    returns the readings."""
    rt = importlib.import_module(pkg)
    js = importlib.import_module(f"{pkg}.job_submission")
    dash = importlib.import_module(f"{pkg}.dashboard")
    state = importlib.import_module(f"{pkg}.util.state")
    kw, accel, addr_var = ACCEL[pkg]
    other = PACKAGES[1 - PACKAGES.index(pkg)]
    rt.init(num_cpus=4, **{kw: 1})
    out = {}
    py = sys.executable
    client = js.JobSubmissionClient()

    # the programs of test_submit_and_succeed, test_failing_job_reports_failed,
    # test_stop_long_job, test_job_attaches_to_session_and_runs_tasks and
    # test_tail_streams_logs, submitted at once
    ticks = ('import time\nfor i in range(5):\n    print("tick", i, flush=True)\n'
             '    time.sleep(0.1)\n')
    jobs = {
        "succeed": client.submit_job(entrypoint=f"{py} -c \"print('hello from job')\""),
        "fail": client.submit_job(entrypoint=f"{py} -c \"import sys; sys.exit(3)\""),
        "long": client.submit_job(entrypoint=f"{py} -c \"import time; time.sleep(600)\""),
        "tasks": client.submit_job(entrypoint=_script(TASKS_JOB.format(pkg=pkg, other=other))),
        "tail": client.submit_job(entrypoint=_script(ticks)),
    }
    out["long_running"] = client.get_job_status(jobs["long"]).value
    out["long_stop"] = client.stop_job(jobs["long"])
    out["tail_stream"] = "".join(client.tail_job_logs(jobs["tail"]))
    for name, jid in jobs.items():
        status = client.wait_until_finished(jid, timeout_s=180).value
        info = client.get_job_info(jid)
        out[name] = dict(status=status, exit_code=info.exit_code, logs=client.get_job_logs(jid),
                         keys=sorted(info.to_dict()))
    out["long"]["exit_code"] = out["long"]["exit_code"] is not None and out["long"]["exit_code"] < 0
    out["stop_again"] = client.stop_job(jobs["long"])
    out["listed"] = sum(i.submission_id in jobs.values() for i in client.list_jobs())
    out["job_id_prefix"] = normalize(jobs["succeed"], pkg)[:4]

    # test_dashboard_http_surface
    _actor, port = dash.start_dashboard(port=0)
    base = f"http://127.0.0.1:{port}"
    got = {p: _http(base, p) for p in ("/api/version", "/api/nodes", "/api/cluster_status",
                                       "/api/actors", "/api/jobs/", "/api/autoscaler",
                                       "/api/placement_groups", "/metrics", "/api/metrics",
                                       "/")}
    out["routes"] = {p: [code, ctype.split(";")[0]] for p, (code, ctype, _) in got.items()}
    body = {p: json.loads(b) for p, (_, ctype, b) in got.items() if ctype.startswith("application")}
    out["version_keys"] = sorted(body["/api/version"])
    out["node_alive"] = body["/api/nodes"][0]["alive"]
    out["node_keys"] = _keys(body["/api/nodes"])
    status = body["/api/cluster_status"]
    out["cluster_status_keys"] = sorted(status)
    out["cluster_status_total"] = {k: v for k, v in status["total_resources"].items()
                                   if k != "memory"}
    out["actor_keys"] = _keys(body["/api/actors"])
    out["job_row_keys"] = _keys(body["/api/jobs/"])
    out["autoscaler_keys"] = sorted(body["/api/autoscaler"])
    out["placement_groups"] = body["/api/placement_groups"]
    http_client = js.JobSubmissionClient(base)
    jid = http_client.submit_job(entrypoint=f"{py} -c \"print('via http')\"")
    out["http_job"] = [http_client.wait_until_finished(jid, timeout_s=120).value,
                       http_client.get_job_logs(jid),
                       any(j.submission_id == jid for j in http_client.list_jobs())]

    # test_dashboard_metrics_and_autoscaler_endpoints
    text = got["/metrics"][2].decode()
    family = re.compile(r"^# TYPE (\S+) (\S+)$", re.M)
    out["cluster_families"] = sorted(
        (name, t) for name, t in family.findall(text) if name.startswith(f"{pkg}_"))
    out["resource_total_series"] = sorted(re.findall(rf'^{pkg}_resource_total\{{resource="(\w+)"\}} ',
                                                     text, re.M))
    out["store_capacity_line"] = bool(re.search(
        rf"^{pkg}_object_store_capacity_bytes \d", text, re.M))
    out["api_metrics_same_types"] = (sorted(family.findall(got["/api/metrics"][2].decode()))
                                     == sorted(family.findall(text)))

    # test_dashboard_serves_web_ui
    html = got["/"][2].decode()
    out["web_ui"] = [f"{pkg} dashboard" in html, "/api/cluster_status" in html]

    # the system actors' processes and the CLI's `status` on this session
    pids = {a["name"]: a["pid"] for a in state.list_actors() if a.get("name")}
    out["system_actor_libs"] = {normalize(n, pkg): _maps_load(p) for n, p in pids.items()}
    cli = subprocess.run(
        [py, "-c", f"import runpy, sys; sys.argv = [{pkg!r}, 'status', '--once']; "
                   f"runpy.run_module({pkg!r}, run_name='__main__'); "
                   "print('loaded:', sorted({m.split('.')[0] for m in sys.modules} "
                   f"& {{'torch', 'jax', {other!r}}}))"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    out["status_rc"] = cli.returncode
    out["status"] = cli.stdout if cli.returncode == 0 else cli.stderr[-3000:]
    out["address_var_set"] = bool(os.environ.get(addr_var))

    # the port's case: an actor class from a module only the job's working
    # dir holds (the job's cwd reaches the session's workers)
    if pkg == "ray_tpu_torch":
        mod = f"workdir_mod_{os.getpid()}"
        Path(workdir, f"{mod}.py").write_text(WORKDIR_MODULE)
        jid = client.submit_job(entrypoint=f"{py} -c \"import {mod}; {mod}.main({pkg!r})\"",
                                runtime_env={"working_dir": workdir})
        out["workdir_job"] = [client.wait_until_finished(jid, timeout_s=120).value,
                              client.get_job_logs(jid).strip().splitlines()[-1:],
                              mod]
    # the port's case, run last on both packages: a stopped job returns
    # its actor's accelerator
    total = rt.cluster_resources()[accel]
    hold = client.submit_job(entrypoint=_script(HOLD_JOB.format(pkg=pkg, kw=kw)))
    deadline = time.time() + 120
    while "holding True" not in client.get_job_logs(hold) and time.time() < deadline:
        time.sleep(0.1)
    held = rt.available_resources().get(accel, 0)
    holders = {a["actor_id"] for a in state.list_actors()
               if a["state"] == "ALIVE" and not a.get("name")}
    t0 = time.perf_counter()
    stopped = client.stop_job(hold)
    while rt.available_resources().get(accel, 0) < total and time.perf_counter() - t0 < HOLD_LIMIT_S:
        time.sleep(0.05)
    freed_s = time.perf_counter() - t0
    dead = [a["state"] for a in state.list_actors() if a["actor_id"] in holders]
    out["hold"] = dict(total=total, held=held, stopped=stopped,
                       status=client.get_job_status(hold).value,
                       freed=rt.available_resources().get(accel, 0) == total,
                       freed_in_limit=freed_s < HOLD_LIMIT_S, holder_dead=dead == ["DEAD"])
    # then a new actor claims it (JAX's controller counts the chip free but
    # keeps its id off the free list, so its new actor never starts)
    again = rt.remote(**{kw: 1})(type("Again", (), {"ok": lambda self: True})).remote()
    ready, _ = rt.wait([again.ok.remote()], timeout=60 if pkg == "ray_tpu_torch" else 5)
    out["hold_new_actor"] = bool(ready)

    rt.shutdown()
    return out


def _cli_roundtrip(pkg):
    """test_cli_job_submit_roundtrip: `python -m <pkg> job submit` in a fresh
    ephemeral session, from the repo root."""
    env = {**os.environ, "RAY_TPU_NUM_CHIPS": "0", "JAX_PLATFORMS": "cpu"}
    env.pop(ACCEL[pkg][2], None)
    r = subprocess.run([sys.executable, "-m", pkg, "job", "submit", "--",
                        sys.executable, "-c", "print(6*7)"],
                       capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO))
    lines = [normalize(ln, pkg) for ln in r.stdout.splitlines()]
    return dict(rc=r.returncode, lines=[re.sub(r"JOB-\w+", "JOB-id", ln) for ln in lines],
                stderr=r.stderr[-2000:])


def spawn(module, fn, pkg, *args):
    """`module.fn(pkg, *args)` in a fresh interpreter with no session
    inherited; its JSON result is the last line of its output."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", RAY_TPU_NUM_CHIPS="0")
    for var in ("RAY_TPU_ARENA", "RAY_TPU_ADDRESS", "RTPT_ARENA", "RTPT_ADDRESS"):
        env.pop(var, None)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), str(TESTS), env.get("PYTHONPATH", "")])
    code = (f"import json, {module} as m; "
            f"print(json.dumps(m.{fn}({pkg!r}, *{list(args)!r})))")
    return subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=str(REPO))


def result(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """Each package's scenario and CLI round trip in interpreters of their
    own, all four at once."""
    workdir = str(tmp_path_factory.mktemp("job_workdir"))
    procs = {(pkg, fn): spawn("test_torch_jobs", fn, pkg,
                              *((workdir,) if fn == "_scenario" else ()))
             for pkg in PACKAGES for fn in ("_scenario", "_cli_roundtrip")}
    got = {key: result(p) for key, p in procs.items()}
    return {pkg: {**got[(pkg, "_scenario")], "cli": got[(pkg, "_cli_roundtrip")]}
            for pkg in PACKAGES}


def _same(readings, *keys):
    for key in keys:
        port, jax_side = readings["ray_tpu_torch"][key], readings["ray_tpu"][key]
        assert normalize(port, "ray_tpu_torch") == normalize(jax_side, "ray_tpu"), key


def test_submit_and_succeed(readings):
    _same(readings, "succeed", "listed", "job_id_prefix")
    assert readings["ray_tpu_torch"]["listed"] == 5
    got = readings["ray_tpu_torch"]["succeed"]
    assert got["status"] == "SUCCEEDED" and "hello from job" in got["logs"]


def test_failing_job_reports_failed(readings):
    _same(readings, "fail")
    got = readings["ray_tpu_torch"]["fail"]
    assert got["status"] == "FAILED" and got["exit_code"] == 3


def test_stop_long_job(readings):
    _same(readings, "long", "long_running", "long_stop", "stop_again")
    got = readings["ray_tpu_torch"]
    assert got["long_running"] == "RUNNING" and got["long_stop"] is True
    assert got["long"]["status"] == "STOPPED" and got["long"]["exit_code"]
    assert got["stop_again"] is False


def test_job_attaches_to_session_and_runs_tasks(readings):
    """The job's driver joins the session and its task runs there; JAX's
    driver loads no jax and the port's no torch; neither loads the other
    package."""
    _same(readings, "tasks")
    got = readings["ray_tpu_torch"]["tasks"]
    assert got["status"] == "SUCCEEDED", got["logs"]
    assert "result: 42" in got["logs"] and "loaded: []" in got["logs"]


def test_tail_streams_logs(readings):
    _same(readings, "tail", "tail_stream")
    out = readings["ray_tpu_torch"]["tail_stream"]
    assert all(f"tick {i}" in out for i in range(5))


def test_dashboard_http_surface(readings):
    """Every route's HTTP code and media type, and the JSON keys of version,
    nodes, cluster_status, actors and jobs; the job lifecycle over HTTP."""
    _same(readings, "routes", "version_keys", "node_alive", "node_keys", "cluster_status_keys",
          "actor_keys", "job_row_keys", "http_job")
    got = readings["ray_tpu_torch"]
    assert got["version_keys"] == ["ray_tpu_torch_version", "session"]
    assert got["node_alive"] and got["http_job"][0] == "SUCCEEDED"
    assert "via http" in got["http_job"][1] and got["http_job"][2]


def test_cli_job_submit_roundtrip(readings):
    _same(readings, "cli")
    got = readings["ray_tpu_torch"]["cli"]
    assert got["rc"] == 0, got["stderr"]
    assert "42" in got["lines"] and any("SUCCEEDED" in ln for ln in got["lines"])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_prometheus_rendering_unit(pkg):
    """test_jobs.py's rendering case on each package's `_prometheus_text`,
    in this process; the two texts are equal."""
    dash = importlib.import_module(f"{pkg}.dashboard")
    metrics = importlib.import_module(f"{pkg}.util.metrics")
    metrics.clear_registry()
    c = metrics.Counter("dash_test_total", "requests", tag_keys=("route",))
    c.inc(3, tags={"route": "/x"})
    metrics.Gauge("dash_test_gauge").set(1.5)
    h = metrics.Histogram("dash_test_latency", boundaries=[0.1, 1.0])
    h.observe(0.05)
    h.observe(5.0)
    snaps = metrics.collect()
    text = dash._prometheus_text(snaps)
    metrics.clear_registry()
    assert 'dash_test_total{route="/x"} 3.0' in text
    assert "# TYPE dash_test_gauge gauge" in text
    assert 'dash_test_latency_bucket{le="+Inf"} 2' in text
    assert "dash_test_latency_count 2" in text
    other = importlib.import_module(f"{PACKAGES[1 - PACKAGES.index(pkg)]}.dashboard")
    assert other._prometheus_text(snaps) == text


def test_dashboard_metrics_and_autoscaler_endpoints(readings):
    """The cluster gauges (the port's named `ray_tpu_torch_*`), the
    accelerator in the resource series, /api/metrics equal to /metrics,
    the autoscaler's keys, placement groups a list."""
    _same(readings, "cluster_families", "resource_total_series", "store_capacity_line",
          "api_metrics_same_types", "autoscaler_keys", "placement_groups")
    got = readings["ray_tpu_torch"]
    assert ["ray_tpu_torch_workers", "gauge"] in got["cluster_families"]
    assert "CPU" in got["resource_total_series"] and "GPU" in got["resource_total_series"]
    assert got["store_capacity_line"] and got["api_metrics_same_types"]
    assert {"pool_workers", "max_workers"} <= set(got["autoscaler_keys"])


def test_dashboard_serves_web_ui(readings):
    _same(readings, "web_ui")
    assert readings["ray_tpu_torch"]["web_ui"] == [True, True]
    assert readings["ray_tpu_torch"]["routes"]["/"] == [200, "text/html"]


def test_stopped_job_returns_its_accelerator(readings):
    """A job whose unnamed actor holds the session's one accelerator is
    stopped: STOPPED, the accelerator free again within HOLD_LIMIT_S and
    the actor listed dead, JAX's "TPU" as the port's "GPU"; then a new
    actor of the port claims it (JAX's does not: ROADMAP §C)."""
    _same(readings, "hold")
    got = readings["ray_tpu_torch"]
    assert got["hold"] == dict(total=1.0, held=0.0, stopped=True, status="STOPPED", freed=True,
                               freed_in_limit=True, holder_dead=True), got["hold"]
    assert got["hold_new_actor"]


def test_system_actors_and_status_load_no_torch(readings):
    """The job manager's and the dashboard's processes map neither libtorch
    nor jaxlib, in either package; `python -m ray_tpu_torch status`,
    attached through RTPT_ADDRESS, loads none of torch, jax and ray_tpu."""
    _same(readings, "system_actor_libs")
    got = readings["ray_tpu_torch"]
    assert got["system_actor_libs"] == {"_SYS_dashboard": [], "_SYS_job_manager": []}
    assert got["status_rc"] == 0 and got["address_var_set"], got["status"]
    assert got["status"].rstrip().endswith("loaded: []"), got["status"]


def _status_fields(text):
    """The CLI frame's section names and the resource rows' names."""
    sections = re.findall(r"^== (\w+)", text, re.M)
    resources = re.findall(r"^  (\w+)\s+[\d.]+ / [\d.]+ free$", text, re.M)
    return dict(sections=sections, resources=sorted(resources))


def test_status_lists_the_gpu(readings):
    """`status` prints the same sections and resource rows in both
    packages; the port's lists its card as "GPU", 1 total."""
    port = _status_fields(readings["ray_tpu_torch"]["status"])
    jax_side = _status_fields(readings["ray_tpu"]["status"])
    assert normalize(port, "ray_tpu_torch") == normalize(jax_side, "ray_tpu")
    assert "GPU" in port["resources"] and port["sections"][:2] == ["Cluster", "Nodes"]
    assert re.search(r"^  GPU\s+[\d.]+ / 1 free$", readings["ray_tpu_torch"]["status"], re.M)
    assert readings["ray_tpu_torch"]["cluster_status_total"] == {"CPU": 4.0, "GPU": 1.0}


def test_job_working_dir_reaches_its_workers(readings):
    """An actor class the job imports from a module only its working dir
    holds is pickled by reference; the session's worker imports it."""
    status, last, mod = readings["ray_tpu_torch"]["workdir_job"]
    assert status == "SUCCEEDED" and last == [f"module: {mod}"], (status, last)
