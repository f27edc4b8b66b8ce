"""The port's autoscaler: tests/test_autoscaler.py's eight tests and
test_cluster.py's autoscaler_node_provider under the port's names, and the
GPU provider that takes the place of JAX's `GcpTpuNodeProvider`.

- `sdk.request_resources` on a module session of the port's runtime:
  explicit demand warms the worker pool, requests overwrite, infeasible
  requests are clamped and reported.
- The alert-driven Reconciler on fakes and a fake clock (no cluster, no
  subprocess, no sleep): a dead node's replacement with its causality,
  the clamp at max_nodes, pressure scale-up with cooldown, idle
  scale-down, and the RAY_TPU_AUTOSCALE knob.
- Through a head in a driver subprocess that imports no JAX (the
  prelude of test_torch_cluster.py: one manual node bound to card "3"):
  SubprocessNodeProvider launching nodes past the cluster's capacity;
  `GcpGpuNodeProvider` on `FakeGpuApi` (a node joins with its bound card
  as "GPU", a num_gpus actor lands on it and sees that card; its agent
  killed, the reconciler replaces it on the same card; the node leaves
  at shutdown).
- `GcpGpuNodeProvider` on `GcloudGpuApi(dry_run=True)`: the recorded
  `gcloud compute instances` invocations, nothing executed.
"""

import time
from types import SimpleNamespace

import pytest

import ray_tpu_torch as rt
from test_torch_cluster import _run_driver


@pytest.fixture(scope="module")
def port_session():
    rt.init(num_cpus=4, num_gpus=0)
    yield rt
    rt.shutdown()


def test_request_resources_warms_pool(port_session):
    from ray_tpu_torch.autoscaler import sdk

    res = sdk.request_resources(num_cpus=3)
    assert res["target_cpus"] == 3
    assert res["fulfilled_cpus"] == 3
    assert res["clamped"] is False
    st = sdk.status()
    assert st["pool_workers"] >= 3
    assert st["request"]["target_cpus"] == 3
    deadline = time.time() + 30
    while time.time() < deadline and sdk.status()["idle_workers"] < 3:
        time.sleep(0.1)
    assert sdk.status()["idle_workers"] >= 3

    @rt.remote
    def f(x):
        return x * 2

    assert rt.get([f.remote(i) for i in range(6)], timeout=60) == [0, 2, 4, 6, 8, 10]
    res = sdk.request_resources()       # overwrite: clears the standing request
    assert res["target_cpus"] == 0
    assert sdk.status()["request"]["target_cpus"] == 0


def test_request_resources_clamped_to_host(port_session):
    from ray_tpu_torch.autoscaler import sdk

    res = sdk.request_resources(num_cpus=10_000)
    assert res["clamped"] is True
    assert res["fulfilled_cpus"] == sdk.status()["max_workers"]
    # cards no node provider can add are reported clamped, not "satisfied"
    res = sdk.request_resources(bundles=[{"GPU": 1}])
    assert res["target_gpus"] == 1.0 and res["clamped"] is True
    sdk.request_resources()


def test_request_resources_bundles(port_session):
    from ray_tpu_torch.autoscaler import sdk

    res = sdk.request_resources(bundles=[{"CPU": 1}, {"CPU": 2}])
    assert res["target_cpus"] == 3
    sdk.request_resources()


# --------------------------------------------------------------- reconciler
class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _FakeProvider:
    """Records create/terminate calls and hands out deterministic pids."""

    cpus_per_node = 2.0
    gpus_per_node = 1.0

    def __init__(self):
        self.created = []
        self.resources = []
        self.terminated = []
        self._pids = {}
        self._n = 0

    def create_node(self, resources, address):
        self._n += 1
        h = f"fake-node-{self._n}"
        self._pids[h] = 10000 + self._n
        self.created.append(h)
        self.resources.append(dict(resources))
        return h

    def terminate_node(self, h):
        self.terminated.append(h)
        self._pids.pop(h, None)

    def non_terminated_nodes(self):
        return list(self._pids)

    def pid_of(self, h):
        return self._pids.get(h)


def _fake_head(clock, max_nodes=4):
    """Narrow controller surface the Reconciler is written against."""
    from ray_tpu_torch._private.health import HealthMonitor

    c = SimpleNamespace(
        node_id="node-head",
        node_provider=_FakeProvider(),
        provider_max_nodes=max_nodes,
        _provider_nodes={},
        cluster=SimpleNamespace(nodes={}, address="127.0.0.1:7777"),
        ready_queue=[])
    c.health = HealthMonitor(c, clock=clock)
    return c


def _register_node(c, node_id, pid):
    c.cluster.nodes[node_id] = SimpleNamespace(
        node_id=node_id, pid=pid, alive=True, inflight={}, actors=set())
    c.health.note_node_alive(node_id)


def _launch_provider_node(c, node_id):
    """Simulate a prior provider launch whose agent is registered+alive."""
    h = c.node_provider.create_node({"CPU": 2.0, "GPU": 1.0}, c.cluster.address)
    c._provider_nodes[h] = {"CPU": 2.0, "GPU": 1.0}
    _register_node(c, node_id, c.node_provider.pid_of(h))
    return h


def test_reconciler_replaces_dead_node_with_causality():
    """node_dead alert -> terminate the dead handle, launch a replacement
    asking for the provider's CPUs and cards, and record the alert-id ->
    create_node causality; the pending launch closes to `recovered` when
    the replacement's pid registers; the same alert is never consumed
    twice (cursor)."""
    from ray_tpu_torch.autoscaler.reconciler import Reconciler

    clock = _FakeClock()
    c = _fake_head(clock)
    rec = Reconciler(c, clock=clock)
    h1 = _launch_provider_node(c, "node-a")
    dead_pid = c.node_provider.pid_of(h1)
    rec.tick()
    assert c.node_provider.terminated == [] and rec.replacements == 0

    clock.advance(1.0)
    c.cluster.nodes["node-a"].alive = False
    c.health.note_node_dead("node-a", host="127.0.0.1", pid=dead_pid)
    clock.advance(0.5)
    rec.tick()

    assert c.node_provider.terminated == [h1]
    assert rec.replacements == 1
    assert h1 not in c._provider_nodes
    h2 = c.node_provider.created[-1]
    assert h2 != h1 and h2 in c._provider_nodes and h2 in rec._pending
    assert c.node_provider.resources[-1] == {"CPU": 2.0, "GPU": 1.0}

    alert = c.health.alerts.events()[-1]
    assert alert["kind"] == "node_dead" and alert["data"]["pid"] == dead_pid
    actions = [(e["action"], e["handle"], e["alert_id"]) for e in rec.events]
    assert ("terminate_dead", h1, alert["id"]) in actions
    assert ("replace", h2, alert["id"]) in actions

    clock.advance(2.0)
    _register_node(c, "node-b", c.node_provider.pid_of(h2))
    rec.tick()
    assert rec._pending == {}
    recovered = [e for e in rec.events if e["action"] == "recovered"]
    assert recovered and recovered[-1]["handle"] == h2
    assert recovered[-1]["alert_id"] == alert["id"]

    rec.tick()
    assert rec.replacements == 1 and len(c.node_provider.created) == 2

    st = rec.status()
    assert st["replacements"] == 1 and st["cursor"] == alert["id"]


def test_reconciler_replace_clamped_at_max_nodes():
    """A death the provider can't absorb (slot cap, dead node wasn't a
    provider launch) records replace_clamped instead of over-launching."""
    from ray_tpu_torch.autoscaler.reconciler import Reconciler

    clock = _FakeClock()
    c = _fake_head(clock, max_nodes=1)
    rec = Reconciler(c, clock=clock)
    _launch_provider_node(c, "node-a")
    _register_node(c, "node-x", pid=4242)

    c.cluster.nodes["node-x"].alive = False
    c.health.note_node_dead("node-x", pid=4242)
    rec.tick()

    assert rec.replacements == 0
    assert len(c.node_provider.created) == 1
    assert c.node_provider.terminated == []
    assert any(e["action"] == "replace_clamped" for e in rec.events)


def test_reconciler_pressure_scale_up_with_cooldown():
    """store_pressure / queue_growth alerts scale up one node, then the
    cooldown suppresses the next pressure alert until it expires."""
    from ray_tpu_torch.autoscaler.reconciler import Reconciler

    clock = _FakeClock()
    c = _fake_head(clock)
    rec = Reconciler(c, clock=clock)

    c.health.alerts.fire("store_pressure", "node-head", "store 93% full")
    rec.tick()
    assert rec.scale_ups == 1 and len(c.node_provider.created) == 1

    clock.advance(1.0)
    c.health.alerts.fire("queue_growth", "node-head", "queue growing")
    rec.tick()
    assert rec.scale_ups == 1
    assert any(e["action"] == "scale_up_suppressed" for e in rec.events)

    clock.advance(15.0)
    c.health.alerts.resolve("queue_growth", "node-head")
    c.health.alerts.fire("queue_growth", "node-head", "queue growing again")
    rec.tick()
    assert rec.scale_ups == 2 and len(c.node_provider.created) == 2


def test_reconciler_idle_scale_down():
    """An idle cluster sheds ONE idle provider node after the idle window;
    busy signals re-arm the timer; a node with work is never the victim."""
    from ray_tpu_torch.autoscaler.reconciler import Reconciler

    clock = _FakeClock()
    c = _fake_head(clock)
    rec = Reconciler(c, clock=clock)
    h1 = _launch_provider_node(c, "node-a")

    c.ready_queue.append(object())
    rec.tick()
    c.ready_queue.clear()
    rec.tick()
    clock.advance(30.0)
    rec.tick()
    assert rec.scale_downs == 0 and c.node_provider.terminated == []

    clock.advance(45.0)
    rec.tick()
    assert rec.scale_downs == 1 and c.node_provider.terminated == [h1]
    assert h1 not in c._provider_nodes
    assert any(e["action"] == "scale_down" for e in rec.events)

    h2 = _launch_provider_node(c, "node-b")
    c.cluster.nodes["node-b"].inflight["t1"] = object()
    rec.tick()
    clock.advance(120.0)
    rec.tick()
    assert c.node_provider.terminated == [h1] and h2 in c._provider_nodes


def test_autoscale_enabled_knob(monkeypatch):
    from ray_tpu_torch._private.controller import autoscale_enabled

    monkeypatch.delenv("RAY_TPU_AUTOSCALE", raising=False)
    assert autoscale_enabled() is True
    monkeypatch.setenv("RAY_TPU_AUTOSCALE", "0")
    assert autoscale_enabled() is False
    monkeypatch.setenv("RAY_TPU_AUTOSCALE", "1")
    assert autoscale_enabled() is True


# ------------------------------------------------------------ node providers
def test_autoscaler_node_provider():
    """request_resources beyond the cluster's capacity launches worker
    nodes through the NodeProvider seam; they register and become
    schedulable; a repeated request does not launch again."""
    _run_driver("""
    from ray_tpu_torch.autoscaler import sdk, SubprocessNodeProvider

    provider = SubprocessNodeProvider(cpus_per_node=2.0,
                                      extra_resources={"provider_node": 1}, env=env)
    sdk.set_node_provider(provider, max_nodes=2)

    # head 2 CPUs + the manual node's 2: ask for 8 -> 2 launches
    out = sdk.request_resources(num_cpus=8)
    assert len(out["launched_nodes"]) == 2, out
    wait_for(lambda: len(ray.nodes()) == 4, 90, "provider nodes registering")
    assert ray.cluster_resources()["CPU"] == 8.0
    assert ray.cluster_resources()["provider_node"] == 2.0
    assert ray.cluster_resources()["GPU"] == 1.0        # the manual node's card only

    out2 = sdk.request_resources(num_cpus=8)
    assert out2["launched_nodes"] == [], out2

    @ray.remote(resources={"provider_node": 0.1})
    def where():
        return os.getppid()
    hosts = set(ray.get([where.remote() for _ in range(4)], timeout=60))
    assert len(hosts) >= 1 and os.getpid() not in hosts

    st = sdk.status()
    assert st["nodes"] == 4 and len(st["provider_nodes"]) == 2

    provider.shutdown()
    wait_for(lambda: len(ray.nodes()) == 2, 60, "provider nodes leaving")
    """)


def test_gcp_gpu_provider_on_fake_api_binds_and_replaces():
    """GcpGpuNodeProvider (a3-highgpu-1g) on FakeGpuApi with cards "6" and
    "7": a request for two cards beyond the manual node's one launches one
    host, bound to card "6"; its agent registers with "GPU" 1 and the
    machine type's marker; a repeated request launches nothing; a
    num_gpus=1 actor with the marker lands on it and sees "6". Its agent
    SIGKILLed, the head's reconciler replaces the host on card "6" and a
    new actor there sees it again. At shutdown the node leaves."""
    _run_driver("""
    from ray_tpu_torch.autoscaler import FakeGpuApi, GcpGpuNodeProvider, sdk

    api = FakeGpuApi(env=env, cards=["6", "7"])
    provider = GcpGpuNodeProvider(machine_type="a3-highgpu-1g", api=api)
    sdk.set_node_provider(provider, max_nodes=1)
    marker = "accelerator_type:a3-highgpu-1g"

    out = sdk.request_resources(bundles=[{"GPU": 2}])
    assert len(out["launched_nodes"]) == 1, out
    assert out["target_gpus"] == 2.0
    wait_for(lambda: ray.cluster_resources().get("GPU", 0) == 2.0, 60, "the GPU host")
    assert ray.cluster_resources()[marker] == 1.0
    name = out["launched_nodes"][0]
    assert api.cards_of(name) == ["6"]

    assert sdk.request_resources(bundles=[{"GPU": 2}])["launched_nodes"] == []

    @ray.remote(num_gpus=1, resources={marker: 1})
    class GpuWorker:
        def binding(self):
            return os.getppid(), os.environ.get("CUDA_VISIBLE_DEVICES"), ray.get_gpu_ids()
    w = GpuWorker.remote()
    ppid, cvd, ids = ray.get(w.binding.remote(), timeout=60)
    assert ppid == provider.pid_of(name) and cvd == "6" and ids == [0], (ppid, cvd, ids)

    os.killpg(provider.pid_of(name), signal.SIGKILL)
    wait_for(lambda: provider.non_terminated_nodes() and
             provider.non_terminated_nodes()[0] != name, 30, "the replacement launch")
    replacement = provider.non_terminated_nodes()[0]
    assert api.cards_of(replacement) == ["6"]
    wait_for(lambda: ray.cluster_resources().get(marker, 0) == 1.0, 60,
             "the replacement registering")
    w2 = GpuWorker.remote()
    ppid, cvd, ids = ray.get(w2.binding.remote(), timeout=60)
    assert ppid == provider.pid_of(replacement) and cvd == "6" and ids == [0]

    provider.shutdown()
    wait_for(lambda: ray.cluster_resources().get(marker, 0) == 0, 60, "the host leaving")
    """)


def test_gcp_gpu_provider_dry_run_records_gcloud():
    """GcloudGpuApi(dry_run=True) records the provisioning contract:
    `gcloud compute instances create` with the machine type, the
    accelerator type and count, and a startup script that runs node_main
    with --num-gpus; list and delete; nothing is executed."""
    from ray_tpu_torch.autoscaler import GcloudGpuApi, GcpGpuNodeProvider, host_info

    assert host_info("a3-highgpu-8g") == {"gpus": 8, "hosts": 1, "gpus_per_host": 8,
                                          "accelerator_type": "nvidia-h100-80gb"}
    with pytest.raises(ValueError, match="unknown machine_type"):
        host_info("v5litepod-8")
    api = GcloudGpuApi("proj", "us-central1-a", dry_run=True)
    provider = GcpGpuNodeProvider(project="proj", zone="us-central1-a",
                                  machine_type="a3-highgpu-4g", api=api)
    assert (provider.cpus_per_node, provider.gpus_per_node) == (1.0, 4.0)
    h = provider.create_node({"CPU": 1.0, "GPU": 4.0}, "10.0.0.2:6380")
    create = api.commands[0]
    assert create[:5] == ["gcloud", "compute", "instances", "create", h]
    flags = dict(zip(create[5::2], create[6::2]))
    assert flags["--machine-type"] == "a3-highgpu-4g"
    assert flags["--project"] == "proj" and flags["--zone"] == "us-central1-a"
    assert flags["--labels"] == "accelerator-type=nvidia-h100-80gb,accelerator-count=4"
    assert flags["--maintenance-policy"] == "TERMINATE"
    assert flags["--metadata-from-file"] == f"startup-script=<startup-script:{h}>"
    script = api.scripts[h]
    assert "python3 -m ray_tpu_torch._private.node_main" in script
    assert "--address 10.0.0.2:6380" in script and "--num-gpus 4" in script
    assert '"accelerator_type:a3-highgpu-4g": 1' in script
    assert provider.non_terminated_nodes() == [h]
    assert provider.pids_of(h) is None           # the head counts marker nodes
    provider.terminate_node(h)
    assert api.commands[-1][:5] == ["gcloud", "compute", "instances", "delete", h]
    assert provider.non_terminated_nodes() == []
    assert all(c[0] == "gcloud" for c in api.commands)
