"""util's ActorPool, Queue, Pool, state API, metrics and check_serialize,
the timeline export and the CLI's `topology`, of `ray_tpu_torch` against
`ray_tpu`'s, on the programs of JAX's `tests/test_util.py` (nine of its
ten; `test_tpu_topology`'s twin is `test_torch_gpu_util.py`'s) and
`tests/test_check_serialize.py` (all three).

The session programs are written once against a package and run for each
in a fresh interpreter of its own, both at once (JAX's session with
`num_tpus=1`, the port's with `num_gpus=1`); their readings are compared:
the pool's order, the queue's `Empty`/`Full` and timeouts, the state
rows' keys and counts. The Queue's actor loads no torch. `topology` and
`inspect_serializability` need no session and run in process: the CLI's
output fields from equal layouts (a TPU slice's variables for JAX,
torchrun's for the port), and the culprits each names.

No jax at this module's top: the scenarios import it in their own
interpreters, the port's never."""

import importlib
import io
import json
import os
import threading
from contextlib import redirect_stdout

import pytest
from test_torch_jobs import ACCEL, PACKAGES, _maps_load, normalize, result, spawn


def _raises(fn):
    """The class name of what `fn()` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is the reading
        return type(e).__name__
    return None


def _scenario(pkg, tmp):
    """test_util.py's session programs against `pkg`; returns the readings."""
    rt = importlib.import_module(pkg)
    util = importlib.import_module(f"{pkg}.util")
    queue_mod = importlib.import_module(f"{pkg}.util.queue")
    mp = importlib.import_module(f"{pkg}.util.multiprocessing")
    state_api = importlib.import_module(f"{pkg}.util.state")
    kw, _, _ = ACCEL[pkg]
    rt.init(num_cpus=4, **{kw: 1})
    out = {}

    # test_actor_pool_ordered_and_unordered
    @rt.remote
    class Worker:
        def double(self, x):
            return x * 2

    pool = util.ActorPool([Worker.remote(), Worker.remote()])
    out["pool_map"] = list(pool.map(lambda a, v: a.double.remote(v), range(6)))
    out["pool_unordered"] = sorted(pool.map_unordered(lambda a, v: a.double.remote(v), range(6)))
    for i in range(5):
        pool.submit(lambda a, v: a.double.remote(v), i)
    out["pool_backlog"] = [pool.get_next(timeout=60) for _ in range(5)]
    out["pool_drained"] = [pool.has_next(), pool.has_free(), _raises(pool.get_next)]

    # test_queue_basics
    q = util.Queue(maxsize=2)
    q.put(1)
    q.put(2)
    steps = [_raises(lambda: q.put(3, block=False)), q.qsize(), q.full(), q.get(), q.get(),
             q.empty(), _raises(lambda: q.get(block=False)),
             _raises(lambda: q.get(timeout=0.1))]
    q.put_nowait_batch([7, 8])
    steps += [q.get_nowait_batch(2), _raises(lambda: q.get_nowait_batch(1)),
              _raises(lambda: q.put_nowait_batch([1, 2, 3])),
              _raises(lambda: q.put(1) or q.put(2) or q.put(3, timeout=0.1))]
    out["queue"] = steps
    out["queue_errors"] = [queue_mod.Empty.__name__, queue_mod.Full.__name__]
    actors = {a["actor_id"]: a["pid"] for a in state_api.list_actors() if a["state"] == "ALIVE"}
    out["queue_actor_libs"] = _maps_load(actors[q.actor._actor_id])
    q.shutdown()

    # test_queue_shared_between_tasks
    shared = util.Queue()

    @rt.remote
    def producer(queue, n):
        for i in range(n):
            queue.put(i)
        return "done"

    out["producer"] = rt.get(producer.remote(shared, 3), timeout=60)
    out["consumed"] = [shared.get(timeout=10) for _ in range(3)]
    shared.shutdown()

    # test_multiprocessing_pool
    with mp.Pool() as p:
        out["mp"] = [p.map(lambda x: x * x, range(5)),
                     p.apply_async(lambda a, b: a + b, (2, 3)).get(timeout=60),
                     p.apply(lambda: 7), p.starmap(lambda a, b: a * b, [(2, 3), (4, 5)]),
                     sorted(p.imap_unordered(lambda x: x + 1, range(4))),
                     list(p.imap(lambda x: -x, range(3)))]
    out["mp_closed"] = _raises(lambda: p.map(abs, [1]))

    # test_state_api
    @rt.remote
    class Pinger:
        def ping(self):
            return "pong"

    pinger = Pinger.options(name="state-test-actor").remote()
    rt.get(pinger.ping.remote(), timeout=60)
    actors = state_api.list_actors(filters=[("name", "=", "state-test-actor")])
    tasks = state_api.list_tasks()
    nodes = state_api.list_nodes()
    out["state"] = dict(
        actors=[(a["name"], a["state"]) for a in actors], actor_keys=sorted(actors[0]),
        alive=state_api.summarize_actors().get("ALIVE", 0) >= 1,
        ping_task=any(t["name"].endswith("ping") for t in tasks),
        task_keys=sorted({k for t in tasks for k in t}),
        objects=state_api.summarize_objects()["count"] >= 1,
        object_summary_keys=sorted(state_api.summarize_objects()),
        node_alive=bool(nodes) and nodes[0]["alive"], node_keys=sorted(nodes[0]),
        worker_keys=sorted({k for w in state_api.list_workers() for k in w}),
        bad_filter=_raises(lambda: state_api.list_actors(filters=[("name", "~", "x")])),
        not_equal=len(state_api.list_actors(filters=[("name", "!=", "state-test-actor")]))
        == len(state_api.list_actors()) - 1)
    rt.kill(pinger)

    # test_actor_pool_mixed_ordered_unordered
    @rt.remote
    class A:
        def echo(self, v):
            return v

    mixed = util.ActorPool([A.remote() for _ in range(3)])
    for v in (10, 11, 12):
        mixed.submit(lambda a, v: a.echo.remote(v), v)
    first = mixed.get_next_unordered(timeout=60)
    rest = []
    while mixed.has_next():
        rest.append(mixed.get_next(timeout=60))
    out["mixed"] = [sorted([first] + rest), rest == sorted(rest), len(rest)]

    # test_timeline_export
    @rt.remote
    def traced():
        return 1

    rt.get([traced.remote() for _ in range(3)])
    path = os.path.join(tmp, f"trace-{pkg}.json")
    returned = rt.timeline(path)
    with open(path) as f:
        events = json.load(f)
    out["timeline"] = dict(is_list=isinstance(events, list), at_least_3=len(events) >= 3,
                           complete=all("ts" in e and "dur" in e for e in events
                                        if e.get("ph") == "X"),
                           returned_written=len(returned) == len(events))
    rt.shutdown()
    out["uninitialized"] = _raises(state_api.list_actors)
    return out


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("util_belt"))
    procs = {pkg: spawn("test_torch_util_belt", "_scenario", pkg, tmp) for pkg in PACKAGES}
    return {pkg: result(proc) for pkg, proc in procs.items()}


def _same(readings, *keys):
    for key in keys:
        port, jax_side = readings["ray_tpu_torch"][key], readings["ray_tpu"][key]
        assert normalize(port, "ray_tpu_torch") == normalize(jax_side, "ray_tpu"), key


def test_actor_pool_ordered_and_unordered(readings):
    _same(readings, "pool_map", "pool_unordered", "pool_backlog", "pool_drained")
    got = readings["ray_tpu_torch"]
    assert got["pool_map"] == [0, 2, 4, 6, 8, 10] == got["pool_unordered"]
    assert got["pool_backlog"] == [0, 2, 4, 6, 8]
    assert got["pool_drained"] == [False, True, "StopIteration"]


def test_queue_basics(readings):
    """Full on a put past maxsize, Empty on a get from an empty queue and
    on a timed-out get, the batch calls; the queue's actor loads neither
    torch nor jax."""
    _same(readings, "queue", "queue_errors", "queue_actor_libs")
    got = readings["ray_tpu_torch"]
    assert got["queue"] == ["Full", 2, True, 1, 2, True, "Empty", "Empty", [7, 8], "Empty",
                            "Full", "Full"]
    assert got["queue_actor_libs"] == []


def test_queue_shared_between_tasks(readings):
    _same(readings, "producer", "consumed")
    assert readings["ray_tpu_torch"]["consumed"] == [0, 1, 2]


def test_multiprocessing_pool(readings):
    _same(readings, "mp", "mp_closed")
    got = readings["ray_tpu_torch"]
    assert got["mp"] == [[0, 1, 4, 9, 16], 5, 7, [6, 20], [1, 2, 3, 4], [0, -1, -2]]
    assert got["mp_closed"] == "ValueError"


def test_state_api(readings):
    _same(readings, "state", "uninitialized")
    got = readings["ray_tpu_torch"]["state"]
    assert got["actors"] == [["state-test-actor", "ALIVE"]]
    assert got["alive"] and got["ping_task"] and got["objects"] and got["node_alive"]
    assert got["bad_filter"] == "ValueError" and got["not_equal"]
    assert readings["ray_tpu_torch"]["uninitialized"] == "RuntimeError"


def test_actor_pool_mixed_ordered_unordered(readings):
    _same(readings, "mixed")
    assert readings["ray_tpu_torch"]["mixed"] == [[10, 11, 12], True, 2]


def test_timeline_export(readings):
    _same(readings, "timeline")
    assert readings["ray_tpu_torch"]["timeline"] == dict(is_list=True, at_least_3=True,
                                                         complete=True, returned_written=True)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_metrics(pkg):
    """test_util.py's metrics program on each package's registry, in this
    process; the snapshots are equal."""
    metrics = importlib.import_module(f"{pkg}.util").metrics
    metrics.clear_registry()
    c = metrics.Counter("requests", "total requests", ("route",))
    c.inc()
    c.inc(2, tags={"route": "/a"})
    with pytest.raises(ValueError):
        c.inc(-1)
    g = metrics.Gauge("inflight")
    g.set(5)
    g.dec()
    h = metrics.Histogram("latency", boundaries=[0.1, 1.0])
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    snap = {m["name"]: m for m in metrics.collect()}
    metrics.clear_registry()
    assert snap["requests"]["values"][()] == 1
    assert snap["requests"]["values"][(("route", "/a"),)] == 2
    assert snap["inflight"]["values"][()] == 4
    assert snap["latency"]["buckets"][()] == [1, 1, 1]
    assert snap["latency"]["count"][()] == 3


# the same layout in each package's variables: 16 chips, 8 a host, host 1
TOPOLOGY_ENV = {"ray_tpu": {"TPU_ACCELERATOR_TYPE": "v5e-16",
                            "TPU_WORKER_HOSTNAMES": "host0,host1", "TPU_WORKER_ID": "1"},
                "ray_tpu_torch": {"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "8",
                                  "GROUP_RANK": "1"}}


def test_cli_topology(monkeypatch):
    """`topology` through each package's `main()`: the layout's fields
    agree (JAX's TPU generation is the port's card name, None without a
    card), and each prints its package's `slice_topology()`."""
    printed = {}
    for pkg in PACKAGES:
        for k in {k for env in TOPOLOGY_ENV.values() for k in env}:
            monkeypatch.delenv(k, raising=False)
        for k, v in TOPOLOGY_ENV[pkg].items():
            monkeypatch.setenv(k, v)
        buf = io.StringIO()
        with redirect_stdout(buf):
            importlib.import_module(f"{pkg}.__main__").main(["topology"])
        printed[pkg] = json.loads(buf.getvalue())
        util = importlib.import_module(f"{pkg}.util.{'tpu' if pkg == 'ray_tpu' else 'gpu'}")
        assert printed[pkg] == util.slice_topology()
    fields = ("num_chips", "num_hosts", "chips_per_host", "worker_id")
    assert [printed["ray_tpu_torch"][f] for f in fields] == [printed["ray_tpu"][f] for f in fields]
    assert [printed["ray_tpu"][f] for f in fields] == [16, 2, 8, 1]
    assert printed["ray_tpu"]["generation"] == "v5e"
    assert printed["ray_tpu_torch"]["device_name"] is None   # no card here


def _serialize_cases():
    """test_check_serialize.py's three objects: a lambda, a function whose
    closure holds a lock, an object with a lock attribute."""
    lock = threading.Lock()

    def task():
        return lock.acquire()

    class Holder:
        def __init__(self):
            self.fine = 42
            self.bad = threading.Lock()

    return {"serializable": lambda x: x + 1, "closure": task, "attribute": Holder()}


@pytest.mark.parametrize("case", ["serializable", "closure", "attribute"])
def test_check_serialize(case):
    """Each package's `inspect_serializability` on the same object: the
    verdict, the culprits' names and the trace it prints are equal."""
    obj = _serialize_cases()[case]
    got = {}
    for pkg in PACKAGES:
        buf = io.StringIO()
        ok, failures = importlib.import_module(f"{pkg}.util").inspect_serializability(
            obj, print_file=buf)
        got[pkg] = (ok, sorted(f.name for f in failures), buf.getvalue())
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    ok, names, _ = got["ray_tpu_torch"]
    want = {"serializable": (True, []), "closure": (False, ["lock"]),
            "attribute": (False, ["bad"])}[case]
    assert (ok, names) == want
