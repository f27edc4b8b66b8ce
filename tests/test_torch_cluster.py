"""The port's runtime across nodes: JAX's tests/test_cluster.py programs
under the port's names (`ray_tpu_torch`, `RTPT_*`, "GPU").

Each program runs in a DRIVER SUBPROCESS that imports no JAX (checked at
its end): it becomes a cluster head (init(cluster_port=0)) and starts a
worker-node agent (`ray_tpu_torch._private.node_main`, through
`node_provider.spawn_agent`) — two controllers, two shm arenas, one
cluster. The node is started bound to the string card "3"
(CUDA_VISIBLE_DEVICES="3", --num-gpus 1): on the CPU a card is a name, and
a num_gpus=1 actor placed there must see "3" and get_gpu_ids() [0].
Programs that share the one-node setup run in one driver, and the three
drivers run at once. Every get has a timeout and every driver a time
limit."""

import os
import subprocess
import sys
import textwrap

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = textwrap.dedent("""
    import json, os, signal, subprocess, sys, time
    import numpy as np
    import torch
    import ray_tpu_torch as ray
    from ray_tpu_torch.autoscaler.node_provider import spawn_agent

    ray.init(num_cpus=2, num_gpus=0, cluster_port=0)
    addr = ray.cluster_address()
    assert addr and ":" in addr, addr
    env = dict(os.environ)
    node_proc = spawn_agent(addr, 2, {"worker_node": 1}, env, gpus=["3"])

    def wait_for(pred, timeout=60, msg="condition"):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pred():
                return
            time.sleep(0.2)
        raise TimeoutError("timed out waiting for " + msg)

    wait_for(lambda: len(ray.nodes()) == 2, 60, "node registration")

    def node_id_of(key="worker_node"):
        for row in ray.nodes():
            if row["resources"].get(key):
                return row["node_id"]
        raise AssertionError("worker node not registered")
""")

_EPILOGUE = textwrap.dedent("""
    if node_proc.poll() is None:
        os.killpg(node_proc.pid, signal.SIGKILL)
        node_proc.wait(timeout=10)
    ray.shutdown()
    assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu")], \\
        "the port's driver imported jax or ray_tpu"
    print("CLUSTER_TEST_OK", flush=True)
""")


def _start_driver(body: str, env_extra=None):
    script = _PRELUDE + textwrap.dedent(body) + _EPILOGUE
    env = dict(os.environ)
    for k in ("RTPT_ARENA", "RTPT_ADDRESS", "RTPT_GPU_IDS"):
        env.pop(k, None)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def drivers():
    """Every program's driver started at once, each its own cluster (a head
    and its node agents): the module takes the slowest driver's time.
    name -> (process, its time limit)."""
    procs = {name: (_start_driver(body, env_extra), timeout)
             for name, (body, timeout, env_extra) in _DRIVERS.items()}
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _wait_driver(proc, timeout, name="driver"):
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        raise AssertionError(f"{name} exceeded {timeout} s\n--- stdout\n{stdout}"
                             f"\n--- stderr\n{stderr[-12000:]}")
    assert proc.returncode == 0, \
        f"{name} failed\n--- stdout\n{stdout}\n--- stderr\n{stderr[-12000:]}"
    assert "CLUSTER_TEST_OK" in stdout


def _run_driver(body: str, timeout=120, env_extra=None):
    """One driver run to its end (test_torch_autoscaler.py and
    test_torch_gcs_chaos.py run theirs so)."""
    _wait_driver(_start_driver(body, env_extra), timeout)


def _finish(drivers, name):
    proc, timeout = drivers[name]
    _wait_driver(proc, timeout, f"driver {name}")


_PLACEMENT = """
    rows = ray.nodes()
    assert sum(1 for r in rows if r.get("is_head")) == 1
    assert ray.cluster_resources().get("CPU") == 4.0
    assert ray.cluster_resources().get("worker_node") == 1.0
    assert ray.cluster_resources().get("GPU") == 1.0     # the node's one card

    # the card binding: the node's card "3", indexed as the actor's card 0
    @ray.remote(num_gpus=1)
    class Carded:
        def binding(self):
            return (os.getppid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                    ray.get_gpu_ids())
    carded = Carded.remote()
    assert ray.get(carded.binding.remote(), timeout=60) == (node_proc.pid, "3", [0])
    ray.kill(carded)

    # custom resource: must run on the node (worker's parent == node agent)
    @ray.remote(resources={"worker_node": 0.1})
    def where():
        return os.getppid()
    assert ray.get(where.remote(), timeout=60) == node_proc.pid

    # hard NodeAffinity to the node
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy
    nid = node_id_of()

    @ray.remote
    def where2():
        return os.getppid()
    strat = NodeAffinitySchedulingStrategy(node_id=nid, soft=False)
    assert ray.get(where2.options(scheduling_strategy=strat).remote(),
                   timeout=60) == node_proc.pid

    # hard affinity to a nonexistent node fails fast
    bad = NodeAffinitySchedulingStrategy(node_id="node-nope", soft=False)
    try:
        ray.get(where2.options(scheduling_strategy=bad).remote(), timeout=30)
        raise SystemExit("expected hard-affinity failure")
    except Exception as e:
        assert "not alive" in str(e), e

    # large results: bytes stay on the node until this get pulls them
    @ray.remote(resources={"worker_node": 0.1})
    def big():
        return np.arange(300_000, dtype=np.int64), torch.arange(300_000, dtype=torch.int64)
    arr, ten = ray.get(big.remote(), timeout=60)
    assert arr.shape == (300_000,) and int(arr[12345]) == 12345
    assert ten.dtype == torch.int64 and torch.equal(ten, torch.arange(300_000))

    # dep shipping: large driver-put arrays and tensors consumed on the node
    x = np.random.default_rng(0).standard_normal(200_000)
    t = torch.from_numpy(np.random.default_rng(1).standard_normal(200_000)).to(torch.bfloat16)

    @ray.remote(resources={"worker_node": 0.1})
    def total(a, b):
        return float(a.sum()), b.dtype, float(b.double().sum())
    got = ray.get(total.remote(ray.put(x), ray.put(t)), timeout=60)
    assert abs(got[0] - float(x.sum())) < 1e-6
    assert got[1] == torch.bfloat16 and got[2] == float(t.double().sum())

    # chained refs across hosts: node-produced ref consumed by a head task
    @ray.remote(resources={"worker_node": 0.1})
    def produce():
        return torch.ones(100_000)

    @ray.remote(num_cpus=0.1)
    def consume(a):
        return float(a.sum())
    assert ray.get(consume.remote(produce.remote()), timeout=60) == 100_000.0

    # SPREAD reaches both hosts
    @ray.remote(num_cpus=0.1)
    def where3():
        return os.getppid()
    hosts = set(ray.get([where3.options(scheduling_strategy="SPREAD").remote()
                         for _ in range(8)], timeout=60))
    assert len(hosts) == 2, hosts

    # DEFAULT overflow: 4 concurrent 1-cpu holds over 2+2 cpus overlap
    @ray.remote(num_cpus=1)
    def hold():
        time.sleep(1.5)
        return os.getppid()
    t0 = time.time()
    hosts = ray.get([hold.remote() for _ in range(4)], timeout=60)
    assert len(set(hosts)) == 2, hosts
    assert time.time() - t0 < 30

    # placement groups: STRICT_SPREAD bundles land on different hosts
    from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                    placement_group, remove_placement_group)
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    ray.get(pg.ready(), timeout=60)

    @ray.remote(num_cpus=1)
    def where4():
        return os.getppid()

    def bundle_hosts(group):
        return [ray.get(where4.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=group, placement_group_bundle_index=i)).remote(), timeout=60)
            for i in range(2)]
    hosts = bundle_hosts(pg)
    assert len(set(hosts)) == 2 and node_proc.pid in hosts, hosts
    node_row = next(r for r in ray.nodes() if r["resources"].get("worker_node"))
    assert node_row["available"].get("CPU", 0) <= 1.0 + 1e-9, node_row
    remove_placement_group(pg)
    wait_for(lambda: next(
        r for r in ray.nodes() if r["resources"].get("worker_node")
    )["available"].get("CPU", 0) >= 2.0 - 1e-9, 30, "node bundle release")

    # STRICT_PACK of 2x1CPU fits a single host
    pg2 = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
    ray.get(pg2.ready(), timeout=60)
    assert len(set(bundle_hosts(pg2))) == 1
    remove_placement_group(pg2)

    # 3 bundles over 2 hosts: STRICT_SPREAD fails fast
    try:
        placement_group([{"CPU": 0.5}] * 3, strategy="STRICT_SPREAD")
        raise SystemExit("expected STRICT_SPREAD infeasibility")
    except ValueError:
        pass

    # direct node-to-node transfer (test_direct_node_to_node_transfer): a
    # ~104 MB array and a 32 MiB bf16 tensor produced on the node and
    # consumed on a second node move producer→consumer over the data
    # plane, never staging in the head store
    node2_proc = spawn_agent(addr, 2, {"node_b": 1}, env)
    try:
        wait_for(lambda: len(ray.nodes()) == 3, 60, "node B registration")

        N = 13_000_000  # ~104 MB of float64
        M = 16 << 20    # 32 MiB of bf16

        @ray.remote(resources={"worker_node": 0.1})
        def produce():
            return np.arange(N, dtype=np.float64)

        @ray.remote(resources={"worker_node": 0.1})
        def produce_t():
            return torch.arange(M, dtype=torch.float32).to(torch.bfloat16)

        @ray.remote(resources={"node_b": 0.1})
        def consume(a):
            return float(a[12345]) + float(a[-1])

        @ray.remote(resources={"node_b": 0.1})
        def consume_t(t):
            want = torch.arange(M, dtype=torch.float32).to(torch.bfloat16)
            return t.dtype == torch.bfloat16 and bool(torch.equal(t, want))

        ref, tref = produce.remote(), produce_t.remote()
        # TWO consumers share the dep: one transfer (deduped pull), two
        # balanced decrefs; the third consume proves the copy survived
        got = ray.get([consume.remote(ref), consume.remote(ref)], timeout=120)
        assert got == [12345.0 + (N - 1)] * 2, got
        assert ray.get(consume.remote(ref), timeout=120) == 12345.0 + (N - 1)
        assert ray.get(consume_t.remote(tref), timeout=120) is True

        head_row = next(r for r in ray.nodes() if r.get("is_head"))
        assert head_row["staged_bytes"] == 0, head_row
        assert head_row["object_store_used"] < 50_000_000, head_row

        blob = N * 8 + M * 2
        def counters_reported():
            rows = [r for r in ray.nodes() if not r.get("is_head")]
            pulled = sum(r.get("direct_pull_bytes", 0) for r in rows)
            served = sum(r.get("direct_serve_bytes", 0) for r in rows)
            return pulled >= blob and served >= blob
        wait_for(counters_reported, 30, "data-plane counters via heartbeat")
    finally:
        if node2_proc.poll() is None:
            os.killpg(node2_proc.pid, signal.SIGKILL)
            node2_proc.wait(timeout=10)
    """


def test_cluster_placement_objects_transfer_and_cards(drivers):
    """test_cluster.py's placement_and_objects, placement_groups_span_nodes
    and direct_node_to_node_transfer in one driver, with torch tensors
    among the objects, and the node's card binding: registration, cluster
    resources, custom-resource + NodeAffinity placement, lazy pull of a
    large remote result, dep shipping head→node, SPREAD across hosts,
    DEFAULT overflow, STRICT_SPREAD / STRICT_PACK bundles, a num_gpus=1
    actor bound to the node's card "3", and a second node pulling an
    array and a tensor straight from the first: head staged_bytes stays 0,
    the nodes' direct_pull_bytes and direct_serve_bytes cover the blobs."""
    _finish(drivers, "placement")


_FAILOVER = """
    silent = spawn_agent(addr, 1, {"silent_node": 1}, env, gpus=["5"])
    wait_for(lambda: len(ray.nodes()) == 3, 60, "the silent node's registration")
    assert ray.cluster_resources().get("GPU") == 2.0
    os.kill(silent.pid, signal.SIGSTOP)  # freeze: socket stays open
    try:
        t0 = time.time()
        wait_for(lambda: len(ray.nodes()) == 2, 30, "heartbeat-silence node death")
        assert time.time() - t0 >= 3.0, time.time() - t0   # silence, not EOF
        assert ray.cluster_resources().get("silent_node") is None
        assert ray.cluster_resources().get("GPU") == 1.0
    finally:
        os.kill(silent.pid, signal.SIGCONT)
        os.killpg(silent.pid, signal.SIGKILL)
        silent.wait(timeout=10)

    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy
    nid = node_id_of()

    @ray.remote
    class Acc:
        def __init__(self):
            self.vals = []
        def add(self, v):
            self.vals.append(float(torch.as_tensor(np.asarray(v)).sum()))
            return len(self.vals)
        def host(self):
            return os.getppid()
        def total(self):
            return sum(self.vals)

    a = Acc.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id=nid, soft=False)).remote()
    assert ray.get(a.host.remote(), timeout=60) == node_proc.pid
    assert ray.get(a.add.remote(1.0), timeout=60) == 1
    big = ray.put(np.ones(100_000))
    assert ray.get(a.add.remote(big), timeout=60) == 2
    assert ray.get(a.total.remote(), timeout=60) == 1.0 + 100_000.0

    ray.kill(a)
    try:
        ray.get(a.total.remote(), timeout=60)
        raise SystemExit("expected ActorDiedError")
    except ray.exceptions.ActorDiedError:
        pass

    @ray.remote(num_cpus=2)
    def two():
        return "ok"
    assert ray.get(two.remote(), timeout=60) == "ok"

    @ray.remote(resources={"worker_node": 0.1}, max_retries=2)
    def produce():
        return np.full(120_000, 7.0)
    ref = produce.remote()
    wait_for(lambda: ray.wait([ref], num_returns=1, timeout=0.1)[0] == [ref],
             60, "remote result ready")

    os.killpg(node_proc.pid, signal.SIGKILL)
    node_proc.wait(timeout=15)
    wait_for(lambda: len(ray.nodes()) == 1, 60, "node removal")

    @ray.remote(max_retries=2)
    def produce2():
        return np.full(50_000, 3.0)
    assert float(ray.get(produce2.remote(), timeout=60).sum()) == 150000.0

    assert ray.cluster_resources().get("CPU") == 2.0
    assert ray.cluster_resources().get("worker_node") is None
    assert ray.cluster_resources().get("GPU") in (None, 0.0)
    """


def test_cluster_remote_actors_failover_and_heartbeat_death(drivers):
    """test_cluster.py's remote_actors_and_failover and
    node_death_by_heartbeat_silence in one driver. A second node that stops
    heartbeating WITHOUT closing its TCP connection (SIGSTOP: no FIN/RST)
    is declared dead by the head's liveness sweep (RAY_TPU_NODE_DEATH_S=4
    here, 15 s by default), its card leaving the cluster's totals. Then the
    remote actor lifecycle (create/mutate/ship-ref/kill) on the first node,
    and node-death failover: the dead node leaves nodes(), a head-runnable
    task still runs, the totals shrink back to the head's."""
    _finish(drivers, "failover")


_RLLIB = """
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=32, scheduling_strategy="SPREAD")
            .training(train_batch_size=128, minibatch_size=64, num_epochs=1, lr=3e-4,
                      model={"hiddens": (32, 32)})
            .resources(device="cpu")
            .debugging(seed=0)
            .build())
    try:
        infos = ray.get([r.node_info.remote() for r in algo._runner_handles], timeout=90)
        assert len({i["ppid"] for i in infos}) == 2, infos
        assert node_proc.pid in {i["ppid"] for i in infos}, infos
        for _ in range(2):
            result = algo.train()
            assert np.isfinite(result["learner"]["total_loss"]), result
            assert result["num_env_steps_sampled_this_iter"] == 128
    finally:
        algo.stop()

    import tempfile
    node2_proc = spawn_agent(addr, 2, {"worker_node": 1}, env)
    try:
        wait_for(lambda: len(ray.nodes()) == 3, 60, "node B registration")
        from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
        tmp = tempfile.mkdtemp(prefix="rtpt-spmd-")

        def loop(config):
            import os as _os
            import torch as _torch
            import torch.distributed as dist
            from ray_tpu_torch import train

            ctx = train.get_context()
            rank, size = ctx.get_world_rank(), ctx.get_world_size()
            assert size == 2 and dist.get_world_size() == 2
            with open(_os.path.join(config["tmp"], f"rank_{rank}.txt"), "w") as f:
                f.write(str(_os.getppid()))
            X = _torch.arange(16, dtype=_torch.float32).reshape(16, 1) / 16.0
            Y = 2.0 * X
            x, y = X[rank * 8:rank * 8 + 8], Y[rank * 8:rank * 8 + 8]
            w = _torch.zeros((), requires_grad=True)
            for _ in range(3):
                loss = ((w * x - y) ** 2).sum() / 16.0
                w.grad = None
                loss.backward()
                stats = _torch.stack([loss.detach(), w.grad])
                dist.all_reduce(stats)
                with _torch.no_grad():
                    w -= 0.5 * stats[1]
                train.report({"loss": float(stats[0])})

        res = TorchTrainer(
            loop, train_loop_config={"tmp": tmp},
            scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                         resources_per_worker={"worker_node": 0.1}),
            run_config=RunConfig(name="spmd", storage_path=tmp),
            use_worker_actor=True).fit()
        assert res.error is None, (res.error, getattr(res, "path", None))

        X = np.arange(16, dtype=np.float32).reshape(16, 1) / 16.0
        mx2 = float(np.mean(X ** 2))
        w, lr, expected = 0.0, 0.5, []
        for _ in range(3):
            expected.append((w - 2.0) ** 2 * mx2)
            w -= lr * 2.0 * (w - 2.0) * mx2
        losses = [m["loss"] for m in res.metrics_history]
        assert len(losses) == 3, res.metrics_history
        for got, want in zip(losses, expected):
            assert abs(got - want) < 1e-4 * max(1.0, want), (losses, expected)

        ppids = set()
        for r in (0, 1):
            with open(os.path.join(tmp, f"rank_{r}.txt")) as f:
                ppids.add(int(f.read()))
        assert ppids == {node_proc.pid, node2_proc.pid}, (ppids, node_proc.pid,
                                                          node2_proc.pid)
    finally:
        if node2_proc.poll() is None:
            os.killpg(node2_proc.pid, signal.SIGKILL)
            node2_proc.wait(timeout=10)
    """


def test_rllib_runners_spread_and_trainer_across_nodes(drivers):
    """test_cluster.py's rllib_env_runners_spread_across_nodes and
    trainer_orchestrates_spmd_across_nodes in one driver. PPO's remote
    EnvRunner actors SPREAD over the head and the node (two distinct parent
    pids) feed the head's learner for two finite train()s; then a second
    node joins and TorchTrainer's worker group (ScalingConfig(num_workers=2)
    with a node-only resource) places one TrainWorker per node agent, the
    two ranks one gloo world whose losses equal the closed form, the
    marker files naming the two agents."""
    _finish(drivers, "rllib")


# name -> (driver body, time limit in s, extra environment)
_DRIVERS = {"placement": (_PLACEMENT, 120, None),
            "failover": (_FAILOVER, 120, {"RAY_TPU_NODE_DEATH_S": "4"}),
            "rllib": (_RLLIB, 240, None)}
