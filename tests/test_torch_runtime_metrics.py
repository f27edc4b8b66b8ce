"""The runtime's nine metric readers in `ray_tpu_torch/util/metrics.py`
against `ray_tpu.util.metrics`'s, on the programs JAX's own tests run.

One scenario is written once against a runtime module and run for each
package in a fresh interpreter of its own, both at once (as
`test_torch_runtime.py` does): the pipelined-submit, worker fan-out and
owned-chain programs of `tests/test_control_plane.py` and
`tests/test_ownership.py` (`control_roundtrips_total`,
`control_frames_sent_total`, `result_async_counters`), the dispatch
program of `tests/test_prefetch_dispatch.py` (`prefetch_counters`,
`prefetch_hit_rate`), and the pressure and restore-before-dispatch
programs of `tests/test_object_store.py` (`spill_counters`,
`tier_occupancy`). A second scenario runs with `RAY_TPU_PREFETCH=0` and
`RAY_TPU_SYNC_SUBMIT=1`, the escape hatches those tests hold. The
placement program of `tests/test_locality_sched.py`
(`sched_locality_hit_rate`) drives each package's `ClusterServer` in this
process. Where a tally is deterministic its reading equals JAX's; where it
depends on timing, both hold the invariant JAX's test asserts.

No jax at this module's top: the scenarios import it in their own
interpreters, the port's never."""

import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _scenario(pkg):
    """JAX's reader programs against `pkg`; returns the readings."""
    import asyncio

    import numpy as np

    rt = importlib.import_module(pkg)
    metrics = importlib.import_module(f"{pkg}.util.metrics")
    api = importlib.import_module(f"{pkg}.api")
    rt.init(num_cpus=2, object_store_memory=256 << 20)
    out = {}

    @rt.remote
    def double(i):
        return i * 2

    @rt.remote
    def inc(x):
        return x + 1

    @rt.remote
    def at5(a):
        return int(a[5])

    @rt.remote
    def fanout(m):
        run = importlib.import_module(pkg)
        mt = importlib.import_module(f"{pkg}.util.metrics")

        @run.remote
        def child(i):
            return i + 100

        rt0 = mt.control_roundtrips_total()
        refs = [child.remote(i) for i in range(m)]
        submit_rt = mt.control_roundtrips_total() - rt0
        return submit_rt, run.get(refs)

    # test_prefetch_dispatch.py:76-88: a shm-resident ref arg counts a hit
    before = metrics.prefetch_counters()
    x = rt.put(np.arange(1 << 16))
    out["prefetch_result"] = rt.get(at5.remote(x), timeout=60)
    after = metrics.prefetch_counters()
    out["prefetch"] = {k: after[k] - before[k] for k in ("hits", "misses")}
    out["prefetch_hit_rate"] = metrics.prefetch_hit_rate()
    out["prefetch_keys"] = sorted(after)

    # test_control_plane.py:53: 50 pipelined submits cost <= 1 round trip
    rt.get(double.remote(0))
    rt0, fs0 = metrics.control_roundtrips_total(), metrics.control_frames_sent_total()
    ra0 = metrics.result_async_counters()
    refs = [double.remote(i) for i in range(50)]
    out["submit_roundtrips"] = metrics.control_roundtrips_total() - rt0
    out["submit_results"] = rt.get(refs, timeout=60) == [i * 2 for i in range(50)]
    out["frames_sent"] = metrics.control_frames_sent_total() - fs0
    ra1 = metrics.result_async_counters()
    out["result_async"] = {k: ra1[k] - ra0[k] for k in ra1}
    # test_control_plane.py:106: a worker's 20 submits cost <= 1 round trip
    out["fanout"] = rt.get(fanout.remote(20), timeout=60)
    # test_ownership.py:49: an owned chain costs no round trip
    rt0, lg0 = metrics.control_roundtrips_total(), metrics.control_local_gets_total()
    ref = inc.remote(0)
    for _ in range(4):
        ref = inc.remote(ref)
    out["chain"] = rt.get(ref, timeout=60)
    out["chain_roundtrips"] = metrics.control_roundtrips_total() - rt0
    out["chain_local_gets"] = metrics.control_local_gets_total() - lg0 >= 1
    # one host: no transfer between nodes
    out["transfer_bytes"] = [metrics.transfer_bytes_total(),
                             metrics.transfer_counters()["bytes"]]

    # test_object_store.py:161-182: pressure demotion spares the pinned object
    runtime = api._runtime
    val = np.arange(1 << 18, dtype=np.uint8)
    prefs = [rt.put(val) for _ in range(6)]
    runtime.client.flush()
    sc0, occ0 = metrics.spill_counters(), metrics.tier_occupancy()

    async def drive():
        c = runtime.controller
        for _ in range(200):
            if all(c.objects.get(r.id) is not None and c.objects[r.id].location == "shm"
                   for r in prefs):
                break
            await asyncio.sleep(0.02)
        c.objects[prefs[0].id].prefetched = True
        c._spill_down(0, pressure=True)
        c._tier_gauges()
        return [c.objects[r.id].location for r in prefs]

    out["pressure_locations"] = asyncio.run_coroutine_threadsafe(
        drive(), runtime.loop).result(60)
    sc, occ = metrics.spill_counters(), metrics.tier_occupancy()
    out["pressure_spill"] = {k: sc[k] - sc0[k] for k in sc}
    out["pressure_occupancy"] = {"disk_objects": occ["disk_objects"] - occ0["disk_objects"],
                                 "disk_over_val": (occ["disk_bytes"] - occ0["disk_bytes"])
                                 >= 5 * val.nbytes}
    out["pressure_spill_counts"] = {k: v for k, v in out["pressure_spill"].items()
                                    if not k.endswith("_bytes")}
    out["spill_bytes_over_val"] = out["pressure_spill"]["spill_bytes"] >= 5 * val.nbytes
    got = rt.get(list(prefs), timeout=60)
    out["pressure_restored_equal"] = all(bool((g == val).all()) for g in got)
    sc2 = metrics.spill_counters()
    out["pressure_restores"] = {"objects": sc2["restored_objects"] - sc0["restored_objects"],
                                "bytes_over_val": sc2["restore_bytes"] - sc0["restore_bytes"]
                                >= 5 * val.nbytes}
    occ2 = metrics.tier_occupancy()
    out["occupancy_keys"] = sorted(occ2)
    del got, prefs

    # test_object_store.py:199-227: a spilled arg is restored before dispatch
    fval = np.arange(1 << 18, dtype=np.float32)
    fx = rt.put(fval)
    runtime.client.flush()
    sc0 = metrics.spill_counters()

    async def spill_all():
        c = runtime.controller
        for _ in range(200):
            m = c.objects.get(fx.id)
            if m is not None and m.location == "shm":
                break
            await asyncio.sleep(0.02)
        c._spill_down(0, pressure=True)
        return c.objects[fx.id].location

    @rt.remote
    def at123(a):
        return float(a[123])

    out["restore_spilled"] = asyncio.run_coroutine_threadsafe(
        spill_all(), runtime.loop).result(60)
    out["restore_result"] = rt.get(at123.remote(fx), timeout=120)
    sc = metrics.spill_counters()
    out["restore_dispatch"] = {"objects": sc["restored_objects"] - sc0["restored_objects"],
                               "bytes_over_val": sc["restore_bytes"] - sc0["restore_bytes"]
                               >= fval.nbytes}

    async def where():
        return runtime.controller.objects[fx.id].location

    out["restore_location"] = asyncio.run_coroutine_threadsafe(where(), runtime.loop).result(30)
    rt.shutdown()
    return out


def _legacy(pkg):
    """RAY_TPU_PREFETCH=0 and RAY_TPU_SYNC_SUBMIT=1 (set by the caller):
    test_prefetch_dispatch.py's escape hatch moves no prefetch counter and
    test_control_plane.py:252's sync submit blocks on every submit."""
    import numpy as np

    rt = importlib.import_module(pkg)
    metrics = importlib.import_module(f"{pkg}.util.metrics")
    rt.init(num_cpus=2)

    @rt.remote
    def at5(a):
        return int(a[5])

    @rt.remote
    def ident(i):
        return i

    out = {"prefetch_result": rt.get(at5.remote(rt.put(np.arange(1 << 16))), timeout=60)}
    c = metrics.prefetch_counters()
    out["prefetch"] = [c["hits"], c["misses"]]
    rt.get(ident.remote(0))
    rt0 = metrics.control_roundtrips_total()
    refs = [ident.remote(i) for i in range(10)]
    out["sync_roundtrips_at_least_10"] = metrics.control_roundtrips_total() - rt0 >= 10
    out["sync_results"] = rt.get(refs) == list(range(10))
    out["put_get"] = rt.get(rt.put(b"z" * 100)) == b"z" * 100
    rt.shutdown()
    return out


def _spawn(fn, pkg, env=None):
    full = dict(os.environ, JAX_PLATFORMS="cpu", RAY_TPU_NUM_CHIPS="0", **(env or {}))
    for var in ("RAY_TPU_ARENA", "RAY_TPU_ADDRESS", "RTPT_ARENA", "RTPT_ADDRESS"):
        full.pop(var, None)
    full["PYTHONPATH"] = os.pathsep.join([str(REPO), str(TESTS), full.get("PYTHONPATH", "")])
    code = (f"import json, test_torch_runtime_metrics as m; "
            f"print(json.dumps(m.{fn}({pkg!r})))")
    return subprocess.Popen([sys.executable, "-c", code], env=full, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=str(REPO))


def _result(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def readings():
    """Each package's two scenarios in interpreters of their own, all four
    at once."""
    legacy = {"RAY_TPU_PREFETCH": "0", "RAY_TPU_SYNC_SUBMIT": "1"}
    procs = {(pkg, fn): _spawn(fn, pkg, legacy if fn == "_legacy" else None)
             for pkg in PACKAGES for fn in ("_scenario", "_legacy")}
    got = {key: _result(p) for key, p in procs.items()}
    return {pkg: {**got[(pkg, "_scenario")],
                  **{f"legacy_{k}": v for k, v in got[(pkg, "_legacy")].items()}}
            for pkg in PACKAGES}


# deterministic readings: equal to JAX's
@pytest.mark.parametrize("key", [
    "prefetch_result", "prefetch", "prefetch_hit_rate", "prefetch_keys", "submit_results",
    "chain", "chain_roundtrips", "chain_local_gets", "transfer_bytes", "pressure_locations",
    "pressure_occupancy", "pressure_spill_counts", "spill_bytes_over_val",
    "pressure_restored_equal", "pressure_restores", "occupancy_keys", "restore_spilled",
    "restore_result",
    "restore_dispatch", "restore_location", "legacy_prefetch_result", "legacy_prefetch",
    "legacy_sync_roundtrips_at_least_10", "legacy_sync_results", "legacy_put_get"])
def test_reading_matches_ray_tpu(readings, key):
    assert readings["ray_tpu_torch"][key] == readings["ray_tpu"][key]


def test_deterministic_readings_are_jax_tests_values(readings):
    """The values JAX's tests assert, on the port."""
    got = readings["ray_tpu_torch"]
    assert got["prefetch"]["hits"] >= 1 and got["prefetch"]["misses"] == 0
    assert got["prefetch_hit_rate"] == 1.0
    assert got["chain"] == 5 and got["chain_roundtrips"] == 0 and got["chain_local_gets"]
    assert got["transfer_bytes"] == [0, 0]
    assert got["pressure_locations"][0] == "shm"
    assert got["pressure_locations"].count("spilled") == 5
    assert got["pressure_occupancy"]["disk_objects"] >= 5   # the prefetch arg spills too
    assert got["pressure_occupancy"]["disk_over_val"]
    assert got["pressure_restores"] == {"objects": 5, "bytes_over_val": True}
    assert got["restore_spilled"] == "spilled" and got["restore_result"] == 123.0
    assert got["restore_dispatch"] == {"objects": 1, "bytes_over_val": True}
    assert got["restore_location"] == "shm"
    assert got["legacy_prefetch"] == [0, 0] and got["legacy_sync_roundtrips_at_least_10"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_spill_tallies_hold_the_pressure_invariants(readings, pkg):
    """The pressure demotion's tallies, as test_object_store.py holds them:
    the pinned object is spared and counted, nothing protected is demoted.
    The byte tallies count each package's own serialized bytes, so they
    are held to the value's bytes, not to each other."""
    sc = readings[pkg]["pressure_spill"]
    assert sc["pinned_demotions"] == 0 and sc["pinned_skips"] >= 1, sc
    assert sc["spilled_objects"] >= 5 and sc["pressure_spills"] >= 5, sc
    assert readings[pkg]["spill_bytes_over_val"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_timing_dependent_tallies_hold_jax_invariants(readings, pkg):
    """Pipelined submits and a worker's fan-out cost at most one round trip
    (test_control_plane.py:53,106); the submits sent frames; the results
    of the 50 tasks rode batched `task_done` entries (the controller is
    this process), each a result."""
    got = readings[pkg]
    assert got["submit_roundtrips"] <= 1 and got["submit_results"]
    submit_rt, vals = got["fanout"]
    assert submit_rt <= 1 and vals == [i + 100 for i in range(20)]
    assert got["frames_sent"] >= 0
    ra = got["result_async"]
    assert ra["tasks"] >= 1 and ra["results"] >= ra["tasks"] - 1, ra


def _locality_program(pkg):
    """test_locality_sched.py's placements on `pkg`'s ClusterServer; the
    locality tallies' deltas and the hit rate after each."""
    cluster = importlib.import_module(f"{pkg}._private.cluster")
    task_spec = importlib.import_module(f"{pkg}._private.task_spec")
    metrics = importlib.import_module(f"{pkg}.util.metrics")
    strategies = importlib.import_module(f"{pkg}.util.scheduling_strategies")

    def head(cpus=2.0):
        return types.SimpleNamespace(node_id="head", available={"CPU": cpus},
                                     total={"CPU": cpus}, ready_queue=[], objects={})

    def node(cs, node_id, cpus=2.0, avail=None):
        n = cluster.NodeConn(node_id=node_id, writer=None, resources={"CPU": cpus},
                             available={"CPU": cpus if avail is None else avail})
        cs.nodes[node_id] = n
        return n

    def obj(cs, oid, size, location):
        cs.c.objects[oid] = task_spec.ObjectMeta(object_id=oid, size=size, location=location,
                                                 holders=[])

    def place(cs, refs=(), cpus=1.0, strategy=None):
        spec = task_spec.TaskSpec(task_id="t-1", fn_blob=b"", resources={"CPU": cpus},
                                  args=[("ref", r) for r in refs], nested_refs=[],
                                  scheduling_strategy=strategy)
        placed = cs.place(types.SimpleNamespace(spec=spec))
        return None if placed is None else placed.node_id

    metrics.clear_registry()     # the hit rate reads the whole registry
    out = []

    def record(what, placed):
        c = metrics.sched_locality_counters()
        out.append([what, placed, c["hits"], c["misses"], c["bytes"],
                    metrics.sched_locality_hit_rate()])

    cs = cluster.ClusterServer(head())
    node(cs, "node-a"), node(cs, "node-b")
    obj(cs, "o1", 50 << 20, "remote:node-a")
    record("args on a node win", place(cs, ["o1"]))
    cs = cluster.ClusterServer(head())
    node(cs, "node-a")
    obj(cs, "o1", 10 << 20, "shm")
    record("head-resident args prefer the head", place(cs, ["o1"]))
    cs = cluster.ClusterServer(head())
    node(cs, "node-a", avail=0.0), node(cs, "node-b")
    obj(cs, "o1", 20 << 20, "remote:node-a")
    record("a full node misses", place(cs, ["o1"]))
    strat = strategies.NodeAffinitySchedulingStrategy(node_id="node-a", soft=True,
                                                       locality_hint=True)
    record("a locality hint to the full node", place(cs, ["o1"], strategy=strat))
    cs = cluster.ClusterServer(head())
    node(cs, "node-a")
    obj(cs, "o1", 1 << 20, "remote:node-a")
    record("hit-rate read surface", place(cs, ["o1"]))
    return out


def test_sched_locality_hit_rate_matches_ray_tpu():
    """test_locality_sched.py's placements on both packages' ClusterServers
    in this process, each registry cleared first: the same nodes chosen,
    the same tallies, the same hit rate after each; the rate in [0, 1] and
    hits + misses > 0, as `test_hit_rate_read_surface` holds."""
    jax_side, port = _locality_program("ray_tpu"), _locality_program("ray_tpu_torch")
    assert port == jax_side
    assert port[0][1:5] == ["node-a", 1, 0, 50 << 20] and port[1][1] is None
    assert all(0.0 <= row[5] <= 1.0 for row in port)
    assert port[-1][2] + port[-1][3] > 0
