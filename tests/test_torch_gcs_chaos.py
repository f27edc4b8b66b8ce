"""The port's GCS journal, chaos knobs and node-death recovery: ports of
tests/test_gcs_ft.py (3), tests/test_chaos.py (8) and
tests/test_node_death.py (2 of 3) under the port's names.

- GCS fault tolerance: a named session journals detached actors and
  spilled objects; a NEW driver process on the same session restores both
  after the first died with os._exit. The journal folds last write wins
  and drops a torn tail frame.
- The chaos injector: the same seed and call order give the same fault
  schedule, knob parsing, runtime reconfiguration, drop_object against a
  live store, and the transfer plane's backoff and deadline helpers.
- Node death (driver subprocesses through test_torch_cluster.py's
  prelude, no JAX): SIGKILL of the only holder of task outputs re-executes
  them from lineage (a single object and a chain) with the dead node's
  entries purged eagerly; an actor's output on the dead node surfaces
  ObjectLostError.

test_node_death.py's chaos-ladder gate (tools/chaos_ladder.py --smoke) is
not ported: the port has no chaos ladder tool.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private.chaos import ChaosInjector, enabled
from test_torch_cluster import _run_driver

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------- GCS FT
_CHILD_A = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import ray_tpu_torch as ray

    session = sys.argv[1]
    ray.init(num_cpus=2, num_gpus=0, session_name=session,
             object_store_memory=4 * 1024 * 1024)

    # three 2MB objects against a 4MB store: capacity pressure spills the
    # oldest unpinned ones (the first two) to disk
    a = np.arange(500_000, dtype=np.float32)
    ref_a = ray.put(a)
    ref_b = ray.put(a * 2.0)
    ref_c = ray.put(a * 3.0)

    @ray.remote
    class Survivor:
        def __init__(self, tag):
            self.tag = tag
            self.calls = 0
        def ping(self):
            self.calls += 1
            return (self.tag, self.calls)

    s = Survivor.options(name="survivor", lifetime="detached").remote("v1")
    assert ray.get(s.ping.remote(), timeout=60) == ("v1", 1)

    print(json.dumps({"ref_a": ref_a.id, "ref_b": ref_b.id}), flush=True)
    os._exit(0)  # crash: no atexit shutdown, workers orphaned
""")

_CHILD_B = textwrap.dedent("""
    import json, sys
    import numpy as np
    import ray_tpu_torch as ray

    session, ref_a = sys.argv[1], sys.argv[2]
    ray.init(num_cpus=2, num_gpus=0, session_name=session)

    got = ray.get(ray.object_ref_from_id(ref_a), timeout=60)
    np.testing.assert_allclose(got, np.arange(500_000, dtype=np.float32))

    s = ray.get_actor("survivor")
    assert ray.get(s.ping.remote(), timeout=60) == ("v1", 1)
    assert "jax" not in sys.modules
    print("GCS_RESTORE_OK", flush=True)
    ray.shutdown()
""")


def _run(code, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("RTPT_ADDRESS", "RTPT_ARENA"):
        env.pop(k, None)       # never attach to a test session
    return subprocess.run([sys.executable, "-c", code, *args],
                          env=env, capture_output=True, timeout=120)


def test_named_session_restores_actor_and_spilled_object():
    session = f"gcsft-{uuid.uuid4().hex[:8]}"
    ra = _run(_CHILD_A, session)
    assert ra.returncode == 0, ra.stdout.decode() + ra.stderr.decode()
    ids = json.loads(ra.stdout.decode().strip().splitlines()[-1])

    rb = _run(_CHILD_B, session, ids["ref_a"])
    out = rb.stdout.decode() + rb.stderr.decode()
    assert rb.returncode == 0, out
    assert "GCS_RESTORE_OK" in out


def test_journal_fold_last_write_wins(tmp_path):
    from ray_tpu_torch._private.gcs import GcsJournal, fold

    j = GcsJournal(str(tmp_path))
    j.record("detached_actor", actor_id="a1", spec=None, options=None)
    j.record("spilled", object_id="o1", path="/x", size=1, meta_len=0)
    j.record("actor_dead", actor_id="a1")
    j.record("spilled", object_id="o2", path="/y", size=2, meta_len=0)
    j.record("object_gone", object_id="o1")
    j.close()
    actors, objects = fold(GcsJournal(str(tmp_path)).load())
    assert actors == {}
    assert list(objects) == ["o2"]


def test_torn_tail_frame_dropped(tmp_path):
    from ray_tpu_torch._private.gcs import GcsJournal, fold

    j = GcsJournal(str(tmp_path))
    j.record("spilled", object_id="o1", path="/x", size=1, meta_len=0)
    j.close()
    with open(os.path.join(str(tmp_path), "gcs.journal"), "ab") as f:
        # a half-written pickle frame (crash mid-write)
        f.write(pickle.dumps({"kind": "spilled", "object_id": "o2"})[:7])
    _actors, objects = fold(GcsJournal(str(tmp_path)).load())
    assert list(objects) == ["o1"]


# ----------------------------------------------------------------- chaos
def _armed(monkeypatch):
    monkeypatch.setenv("RAY_TPU_CHAOS", "1")


def test_deterministic_draw_sequence(monkeypatch):
    _armed(monkeypatch)
    cfg = {"sever_stream": 0.3, "drop_segment": 0.5}
    a = ChaosInjector(seed=42, config=cfg)
    b = ChaosInjector(seed=42, config=cfg)
    schedule = [("sever_stream" if i % 2 else "drop_segment") for i in range(40)]
    assert [a.should(p) for p in schedule] == [b.should(p) for p in schedule]
    assert a.draws == b.draws == 40
    assert a.fired == b.fired
    assert sum(a.fired.values()) > 0
    c = ChaosInjector(seed=43, config=cfg)
    assert [c.should(p) for p in schedule] != [a.should(p) for p in schedule] \
        or c.fired != a.fired


def test_unarmed_injector_is_inert(monkeypatch):
    monkeypatch.setenv("RAY_TPU_CHAOS", "0")
    inj = ChaosInjector(seed=1, config={"sever_stream": 1.0, "heartbeat_drop": 1.0,
                                        "heartbeat_delay_s": 5.0})
    assert not enabled()
    assert inj.should("sever_stream") is False
    assert inj.heartbeat_fault() == (False, 0.0)
    assert inj.draws == 0


def test_env_knob_parsing(monkeypatch):
    _armed(monkeypatch)
    monkeypatch.setenv("RAY_TPU_CHAOS_SEED", "7")
    monkeypatch.setenv("RAY_TPU_CHAOS_HEARTBEAT_DROP", "0.25")
    monkeypatch.setenv("RAY_TPU_CHAOS_HEARTBEAT_DELAY_S", "1.5")
    monkeypatch.setenv("RAY_TPU_CHAOS_SEVER_STREAM", "bogus")
    inj = ChaosInjector()
    assert inj.armed and inj.seed == 7
    assert inj.config["heartbeat_drop"] == 0.25
    assert inj.config["heartbeat_delay_s"] == 1.5
    assert inj.config["sever_stream"] == 0.0


def test_heartbeat_fault_drop_and_delay(monkeypatch):
    _armed(monkeypatch)
    inj = ChaosInjector(seed=0, config={"heartbeat_drop": 1.0})
    assert inj.heartbeat_fault() == (True, 0.0)
    inj2 = ChaosInjector(seed=0, config={"heartbeat_delay_s": 0.75})
    assert inj2.heartbeat_fault() == (False, 0.75)
    assert inj2.fired["heartbeat_delay"] == 1


def test_configure_reseeds_and_snapshot(monkeypatch):
    _armed(monkeypatch)
    inj = ChaosInjector(seed=5, config={"drop_segment": 0.5})
    first = [inj.should("drop_segment") for _ in range(20)]
    snap = inj.configure(seed=5)
    assert snap["draws"] == 0
    assert [inj.should("drop_segment") for _ in range(20)] == first
    snap = inj.configure(armed=False, sever_stream=0.9)
    assert snap["armed"] is False
    assert snap["config"]["sever_stream"] == 0.9
    assert inj.should("sever_stream") is False


def test_drop_object_against_store(monkeypatch):
    """drop_object deletes the shm bytes but leaves the meta: the
    lost-segment shape lineage reconstruction recovers from."""
    from ray_tpu_torch._private import state

    rt.init(num_cpus=2, num_gpus=0)
    try:
        ctrl = state.global_client().controller

        @rt.remote
        def make():
            return np.arange(50_000, dtype=np.float64)

        ref = make.remote()
        rt.get(ref, timeout=60)
        meta = ctrl.objects[ref.id]
        assert meta.location == "shm"
        assert ChaosInjector.drop_object(ctrl, ref.id) is True
        assert not ctrl.store.exists(ref.id)
        assert ctrl.objects[ref.id].location == "shm"
        assert ChaosInjector.drop_object(ctrl, ref.id) is False
        out = rt.get(ref, timeout=60)
        assert out.shape == (50_000,) and float(out[123]) == 123.0
    finally:
        rt.shutdown()


def test_retry_backoff_deterministic_and_bounded(monkeypatch):
    from ray_tpu_torch._private.node_agent import retry_backoff_s, transfer_deadline_s

    seq = [retry_backoff_s(i, key="obj-x") for i in range(6)]
    assert seq == [retry_backoff_s(i, key="obj-x") for i in range(6)]
    assert all(0.0 <= d <= 2.0 for d in seq)
    assert seq[4] > seq[1]
    assert [retry_backoff_s(i, key="obj-y") for i in range(6)] != seq
    monkeypatch.setenv("RAY_TPU_TRANSFER_DEADLINE_S", "12.5")
    assert transfer_deadline_s() == 12.5
    monkeypatch.setenv("RAY_TPU_TRANSFER_DEADLINE_S", "0.01")
    assert transfer_deadline_s() == 1.0
    monkeypatch.delenv("RAY_TPU_TRANSFER_DEADLINE_S")
    assert transfer_deadline_s() == 30.0


def test_reconstruct_enabled_knob(monkeypatch):
    from ray_tpu_torch._private.controller import reconstruct_enabled

    monkeypatch.delenv("RAY_TPU_RECONSTRUCT", raising=False)
    assert reconstruct_enabled() is True
    monkeypatch.setenv("RAY_TPU_RECONSTRUCT", "0")
    assert reconstruct_enabled() is False


# ------------------------------------------------------------ node death
_DEATH = textwrap.dedent("""
    from ray_tpu_torch._private import state
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    ctrl = state.global_client().controller
    nid = node_id_of()

    def on_node(ref):
        meta = ctrl.objects.get(ref.id)
        return meta is not None and meta.location == "remote:" + nid

    def kill_node():
        os.killpg(node_proc.pid, signal.SIGKILL)
        wait_for(lambda: len(ray.nodes()) == 1, 40, "node-death detection")
""")


def test_node_death_reconstructs_single_and_chain():
    """SIGKILL the only holder of task outputs mid-run: get() re-executes
    the producing tasks (a single object AND a base→derived chain, torch
    tensors) and returns the right bytes; the dead node's holder entries
    are purged eagerly; the tombstone keeps the agent's pid."""
    _run_driver(_DEATH + """
    strat = NodeAffinitySchedulingStrategy(node_id=nid, soft=True)

    @ray.remote(num_cpus=0.5)
    def produce(seed):
        return torch.full((40_000,), float(seed))   # ~160KB: shm, never inline

    @ray.remote(num_cpus=0.5)
    def double(a):
        return a * 2.0

    single = produce.options(scheduling_strategy=strat).remote(3)
    base = produce.options(scheduling_strategy=strat).remote(5)
    derived = double.options(scheduling_strategy=strat).remote(base)
    wait_for(lambda: all(on_node(r) for r in (single, base, derived)),
             60, "outputs parked on the worker node")

    kill_node()

    out = ray.get(single, timeout=60)
    assert out.shape == (40_000,) and float(out[7]) == 3.0, out[:4]
    out2 = ray.get(derived, timeout=60)
    assert float(out2[7]) == 10.0, out2[:4]

    from ray_tpu_torch.util import metrics
    assert metrics._counter_total("reconstructions_total") >= 1.0

    dead_loc = "remote:" + nid
    stale = [oid for oid, m in ctrl.objects.items()
             if m.location == dead_loc or nid in m.holders]
    assert not stale, stale
    assert nid in ctrl.health.dead_nodes
    assert ctrl.health.dead_nodes[nid].get("pid") == node_proc.pid
    """)


def test_node_death_actor_output_is_lost():
    """Actor method outputs are not replayable from lineage: after the
    holding node dies, get() surfaces ObjectLostError promptly."""
    _run_driver(_DEATH + """
    from ray_tpu_torch.exceptions import ObjectLostError

    @ray.remote(resources={"worker_node": 0.5})
    class Counter:
        def blob(self):
            return np.ones(50_000)

    a = Counter.remote()
    ref = a.blob.remote()
    wait_for(lambda: on_node(ref), 60, "actor output parked on the node")

    kill_node()

    try:
        ray.get(ref, timeout=60)
        raise SystemExit("expected ObjectLostError for actor output")
    except ObjectLostError:
        pass
    """)
