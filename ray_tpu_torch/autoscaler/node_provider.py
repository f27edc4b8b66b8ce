"""Node providers: the policy/provisioning seam of the autoscaler.

Reference parity: python/ray/autoscaler/node_provider.py separates the
autoscaler's POLICY (how many nodes, when) from PROVISIONING (how a node is
created) — AWS/GCP/K8s implement the same interface. Here the interface is
re-cut for this runtime's cluster model (head + node agents over TCP,
_private/cluster.py): a provider "creates a node" by getting a
`ray_tpu_torch._private.node_main` agent running somewhere with the head's
address; the node then registers itself, so the provider never talks to the
scheduler directly.

- `SubprocessNodeProvider` launches agents as local subprocesses. It is the
  test/fake provider AND genuinely useful on one big host (per-node shm
  stores and worker pools isolate noisy jobs from each other).
- A cloud provider (GPU VMs through gcloud, `gcp_gpu.py`) implements the
  same three methods with its own machinery.

A node owns the cards it was started with: the agent runs under
CUDA_VISIBLE_DEVICES naming them and `--num-gpus` counting them, so an
actor placed there is bound to one of them (the node controller's
`_physical_cards` maps its card ids through that list), never to the
head's card of the same index.
"""

import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence


def spawn_agent(head_address: str, num_cpus: float,
                resources: Optional[Dict[str, float]] = None,
                env: Optional[Dict[str, str]] = None,
                gpus: Sequence = ()) -> subprocess.Popen:
    """Launch one `node_main` agent that dials into `head_address` — the
    single agent-launch contract shared by every local/fake provider (a
    node is its own session: never inherit the head's arena/socket). The
    node owns the cards `gpus` (CUDA_VISIBLE_DEVICES entries: indices or
    UUIDs) and no other, and imports from this process's sys.path."""
    import json
    env = dict(env if env is not None else os.environ)
    env.pop("RTPT_ARENA", None)
    env.pop("RTPT_ADDRESS", None)
    env.pop("RTPT_GPU_IDS", None)
    env["CUDA_VISIBLE_DEVICES"] = ",".join(str(g) for g in gpus)
    # this process's sys.path, as the controller gives its workers: code
    # sent by reference (a driver script's module) resolves on the node
    extra = [p if p else os.getcwd() for p in sys.path if p == "" or os.path.isdir(p)]
    env["PYTHONPATH"] = os.pathsep.join(extra + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                                                 else []))
    cmd = [sys.executable, "-m", "ray_tpu_torch._private.node_main",
           "--address", head_address, "--num-cpus", str(num_cpus),
           "--num-gpus", str(len(gpus))]
    if resources:
        cmd += ["--resources", json.dumps(resources)]
    return subprocess.Popen(cmd, env=env, stdin=subprocess.DEVNULL,
                            start_new_session=True)


def visible_cards() -> List[str]:
    """This process's cards as CUDA_VISIBLE_DEVICES entries: the variable's
    own entries where it is set, else "0".."n-1" for the cards torch
    counts."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [x.strip() for x in env.split(",") if x.strip()]
    import torch
    return [str(i) for i in range(torch.cuda.device_count())]


class CardPool:
    """The cards a provider binds its nodes to, handed out lowest first and
    taken back when a node is terminated (a replacement node gets the dead
    node's card)."""

    def __init__(self, cards: Optional[Sequence] = None):
        self.cards = [str(c) for c in (cards if cards is not None else visible_cards())]
        self.free = list(self.cards)

    def take(self, n: int) -> List[str]:
        if n > len(self.free):
            raise RuntimeError(f"no {n} free cards to bind a node to: free {self.free} "
                               f"of {self.cards}")
        got, self.free = self.free[:n], self.free[n:]
        return got

    def give(self, cards: Sequence[str]) -> None:
        self.free = [c for c in self.cards if c in self.free or c in cards]


class NodeProvider:
    """Minimal provisioning interface (ref: node_provider.py:1-120).

    Implementations must be non-blocking-ish: `create_node` should kick off
    provisioning and return a handle; registration with the head happens
    asynchronously when the agent comes up.
    """

    def create_node(self, resources: Dict[str, float],
                    head_address: str) -> str:
        """Start provisioning one worker node that will join
        `head_address`. Returns an opaque node handle."""
        raise NotImplementedError

    def terminate_node(self, handle: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


class SubprocessNodeProvider(NodeProvider):
    """Worker nodes as local `node_main` subprocesses, each bound to
    `gpus_per_node` cards of `cards` (the cards this process sees by
    default).

    The cloud equivalent is `gcp_gpu.GcpGpuNodeProvider`: `create_node`
    creates a GPU VM whose startup script runs
    `python -m ray_tpu_torch._private.node_main --address <head>` (the head
    address reachable over the VPC, RTPT_CLUSTER_TOKEN injected as a
    secret); `terminate_node` deletes the instance; liveness is the
    instance's state. The head never changes — nodes always dial in.
    """

    def __init__(self, cpus_per_node: float = 2.0,
                 extra_resources: Optional[Dict[str, float]] = None,
                 env: Optional[Dict[str, str]] = None,
                 gpus_per_node: float = 0.0, cards: Optional[Sequence] = None):
        self.cpus_per_node = cpus_per_node
        self.gpus_per_node = float(gpus_per_node)
        self.extra_resources = dict(extra_resources or {})
        self.env = env
        self._pool = CardPool(cards) if (gpus_per_node or cards is not None) else None
        self._procs: Dict[str, subprocess.Popen] = {}
        self._bound: Dict[str, List[str]] = {}
        self._n = 0

    def create_node(self, resources: Dict[str, float],
                    head_address: str) -> str:
        extra = {**self.extra_resources,
                 **{k: v for k, v in resources.items()
                    if k not in ("CPU", "GPU", "memory")}}
        n_gpus = int(resources.get("GPU", self.gpus_per_node))
        gpus = self._pool.take(n_gpus) if n_gpus else []
        proc = spawn_agent(head_address,
                           resources.get("CPU", self.cpus_per_node),
                           extra or None, self.env, gpus)
        self._n += 1
        handle = f"subproc-node-{self._n}-pid{proc.pid}"
        self._procs[handle] = proc
        self._bound[handle] = gpus
        return handle

    def cards_of(self, handle: str) -> List[str]:
        """The cards a node was bound to."""
        return list(self._bound.get(handle, []))

    def terminate_node(self, handle: str) -> None:
        if self._pool is not None:
            self._pool.give(self._bound.pop(handle, []))
        proc = self._procs.pop(handle, None)
        if proc is not None and proc.poll() is None:
            import signal
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            deadline = time.time() + 5
            while time.time() < deadline and proc.poll() is None:
                time.sleep(0.05)
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass

    def non_terminated_nodes(self) -> List[str]:
        return [h for h, p in self._procs.items() if p.poll() is None]

    def pid_of(self, handle: str) -> Optional[int]:
        """The agent pid for a handle — lets the head match registered
        nodes (which report their pid) to launch promises."""
        proc = self._procs.get(handle)
        return proc.pid if proc is not None else None

    def shutdown(self):
        for h in list(self._procs):
            self.terminate_node(h)
