"""GCP GPU node provider (reference parity:
python/ray/autoscaler/_private/gcp/node_provider.py).

The reference autoscaler provisions GCE instances through the GCP API. This
provider re-cuts that for this runtime's dial-in cluster model: "creating
a node" means getting ONE `node_main` agent running on a new GPU VM with
the head's address; the agent owns the host's cards and advertises them
as "GPU", and the scheduler's resource accounting does the rest. Machine
types are GCP's A3 family (a3-highgpu-1g/2g/4g/8g: 1, 2, 4 or 8 H100
80GB cards on one host), so one handle is one host; `pids_of` still
answers a list, as the head's promise accounting expects of multi-host
providers.

Three operating modes, same interface:
- `GcloudGpuApi` (real): shells out to `gcloud compute instances
  create/delete/list`, injecting a startup script that launches the agent.
- `GcloudGpuApi(dry_run=True)`: records the exact gcloud invocations
  without executing them — the provisioning contract is testable with zero
  cloud access.
- `FakeGpuApi`: emulates the API locally — `create` spawns the node_main
  subprocess the startup script would start on the VM, bound to cards of
  this host (`node_provider.CardPool`), so a `num_gpus` actor lands on it.
"""

import json
import os
import re
import subprocess
import time
from typing import Dict, List, Optional, Sequence

from .node_provider import CardPool, NodeProvider, spawn_agent

# machine type -> (cards, GCE accelerator type): GCP's A3 machine types
_MACHINE_TYPES = {
    "a3-highgpu-1g": (1, "nvidia-h100-80gb"),
    "a3-highgpu-2g": (2, "nvidia-h100-80gb"),
    "a3-highgpu-4g": (4, "nvidia-h100-80gb"),
    "a3-highgpu-8g": (8, "nvidia-h100-80gb"),
}


def host_info(machine_type: str) -> Dict:
    """{gpus, hosts, gpus_per_host, accelerator_type} of a GPU machine type
    ("a3-highgpu-8g", ...): one VM is one host."""
    if machine_type not in _MACHINE_TYPES:
        raise ValueError(f"unknown machine_type {machine_type!r}; known: "
                         f"{sorted(_MACHINE_TYPES)}")
    gpus, accel = _MACHINE_TYPES[machine_type]
    return {"gpus": gpus, "hosts": 1, "gpus_per_host": gpus, "accelerator_type": accel}


def _marker(machine_type: str) -> str:
    return f"accelerator_type:{machine_type}"


def _startup_script(head_address: str, gpus_per_host: int, machine_type: str) -> str:
    """What the GPU VM runs on boot: join the head as a node agent owning
    the host's cards. RTPT_CLUSTER_TOKEN arrives via instance
    metadata/secret, mirroring the reference's auth bootstrap."""
    resources = json.dumps({_marker(machine_type): 1})
    return ("#! /bin/bash\n"
            f"python3 -m ray_tpu_torch._private.node_main "
            f"--address {head_address} --num-cpus 1 --num-gpus {gpus_per_host} "
            f"--resources '{resources}'\n")


# ------------------------------------------------------------------ API seams
class GcloudGpuApi:
    """Thin gcloud CLI wrapper; dry_run records commands instead of running.

    Ref contrast: the reference uses the googleapiclient discovery API
    (gcp/node.py); a CLI wrapper keeps the package dependency-free while
    preserving the exact provisioning contract. A3 machine types come with
    their cards attached: the accelerator type and count ride the
    instance's labels. `image_family`/`image_project` name a boot image
    with the NVIDIA driver, python3 and this package (gcloud's default
    image otherwise)."""

    def __init__(self, project: str, zone: str, dry_run: bool = False,
                 image_family: Optional[str] = None, image_project: Optional[str] = None):
        self.project = project
        self.zone = zone
        self.dry_run = dry_run
        self.image_family = image_family
        self.image_project = image_project
        self.commands: List[List[str]] = []   # dry-run ledger
        self.scripts: Dict[str, str] = {}     # name → startup script text
        self._dry_nodes: Dict[str, str] = {}  # name → status

    def _run(self, cmd: List[str]) -> str:
        self.commands.append(cmd)
        if self.dry_run:
            return ""
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"gcloud failed: {out.stderr[-500:]}")
        return out.stdout

    def create(self, name: str, machine_type: str, startup_script: str) -> None:
        # --metadata splits its value on commas (the script's JSON has
        # them), so the script must travel via --metadata-from-file
        import tempfile
        info = host_info(machine_type)
        self.scripts[name] = startup_script
        if self.dry_run:
            script_path = f"<startup-script:{name}>"
        else:
            fd, script_path = tempfile.mkstemp(prefix="rtpt-gpu-boot-", suffix=".sh")
            with os.fdopen(fd, "w") as f:
                f.write(startup_script)
        cmd = ["gcloud", "compute", "instances", "create", name,
               "--project", self.project, "--zone", self.zone,
               "--machine-type", machine_type,
               "--maintenance-policy", "TERMINATE"]
        if self.image_family:
            cmd += ["--image-family", self.image_family]
        if self.image_project:
            cmd += ["--image-project", self.image_project]
        cmd += ["--labels", f"accelerator-type={info['accelerator_type']},"
                            f"accelerator-count={info['gpus']}",
                "--metadata-from-file", f"startup-script={script_path}"]
        try:
            self._run(cmd)
        finally:
            if not self.dry_run:
                try:  # gcloud read it synchronously during _run
                    os.unlink(script_path)
                except OSError:
                    pass
        if self.dry_run:
            self._dry_nodes[name] = "RUNNING"

    def delete(self, name: str) -> None:
        self._run(["gcloud", "compute", "instances", "delete", name,
                   "--project", self.project, "--zone", self.zone, "--quiet"])
        if self.dry_run:
            self._dry_nodes.pop(name, None)

    def list(self) -> Dict[str, str]:
        """name → status."""
        cmd = ["gcloud", "compute", "instances", "list", "--project", self.project,
               "--filter", f"zone:{self.zone}", "--format", "json"]
        if self.dry_run:
            self.commands.append(cmd)
            return dict(self._dry_nodes)
        out = self._run(cmd)
        return {row["name"].rsplit("/", 1)[-1]: row.get("status", "UNKNOWN")
                for row in json.loads(out or "[]")}


class FakeGpuApi:
    """Local GPU-VM emulation: a created host becomes a node_main subprocess
    owning `gpus_per_host` cards of `cards` (this process's cards by
    default) — what the startup script starts on a real VM."""

    def __init__(self, env: Optional[Dict[str, str]] = None,
                 cards: Optional[Sequence] = None):
        self.env = env
        self._pool = CardPool(cards)
        self._hosts: Dict[str, List[subprocess.Popen]] = {}
        self._bound: Dict[str, List[str]] = {}

    def create(self, name: str, machine_type: str, startup_script: str) -> None:
        # the head address and the card count are the startup script's, as
        # a real boot would receive them
        m = re.search(r"--address (\S+)", startup_script)
        g = re.search(r"--num-gpus (\d+)", startup_script)
        if not m or not g:
            raise ValueError("startup script has no --address or --num-gpus")
        cards = self._pool.take(int(g.group(1)))
        self._bound[name] = cards
        self._hosts[name] = [spawn_agent(m.group(1), 1, {_marker(machine_type): 1},
                                         self.env, cards)]

    def delete(self, name: str) -> None:
        import signal
        procs = self._hosts.pop(name, [])
        for proc in procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGTERM)
                except ProcessLookupError:
                    continue
        deadline = time.time() + 5
        while time.time() < deadline and any(p.poll() is None for p in procs):
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
        self._pool.give(self._bound.pop(name, []))

    def list(self) -> Dict[str, str]:
        return {name: ("RUNNING" if any(p.poll() is None for p in procs) else "TERMINATED")
                for name, procs in self._hosts.items()}

    def pids(self, name: str) -> List[int]:
        return [p.pid for p in self._hosts.get(name, [])]

    def cards_of(self, name: str) -> List[str]:
        return list(self._bound.get(name, []))


# ------------------------------------------------------------------- provider
class GcpGpuNodeProvider(NodeProvider):
    """GPU-VM NodeProvider: one handle = one VM, whose agent dials into the
    head carrying the host's cards as "GPU".

    `cpus_per_node`/`gpus_per_node` feed the controller's scale-up
    projection (controller.request_resources): launching one more node
    promises `gpus` more "GPU"."""

    def __init__(self, project: str = "fake-project", zone: str = "us-central1-a",
                 machine_type: str = "a3-highgpu-1g", api=None):
        self.project = project
        self.zone = zone
        self.machine_type = machine_type
        self.api = api if api is not None else GcloudGpuApi(project, zone)
        info = host_info(machine_type)
        self.cpus_per_node = float(info["hosts"])   # 1 agent cpu per host
        self.gpus_per_node = float(info["gpus"])
        self.hosts_per_node = float(info["hosts"])
        # pid-less mode (real gcloud API): the head drains launch promises
        # by counting registered nodes that carry this marker resource
        self.registration_marker = _marker(machine_type)
        self._n = 0
        self._handles: List[str] = []

    def create_node(self, resources: Dict[str, float], head_address: str) -> str:
        self._n += 1
        name = f"ray-gpu-{self.machine_type}-{self._n}"
        script = _startup_script(head_address, host_info(self.machine_type)["gpus_per_host"],
                                 self.machine_type)
        self.api.create(name, self.machine_type, script)
        self._handles.append(name)
        return name

    def terminate_node(self, handle: str) -> None:
        self.api.delete(handle)
        if handle in self._handles:
            self._handles.remove(handle)

    def non_terminated_nodes(self) -> List[str]:
        states = self.api.list()
        return [h for h in self._handles
                if states.get(h) not in (None, "TERMINATED", "STOPPING", "SUSPENDED")]

    def pid_of(self, handle: str) -> Optional[int]:
        """The host's agent pid (FakeGpuApi only)."""
        pids = self.pids_of(handle)
        return pids[0] if pids else None

    def pids_of(self, handle: str) -> Optional[List[int]]:
        """The agent pids of a handle, or None when the API cannot map pids
        (real gcloud mode): then the head drains promises by counting
        registered nodes with `registration_marker`, so launched capacity
        never double-counts against registered capacity."""
        pids_fn = getattr(self.api, "pids", None)
        if pids_fn is None:
            return None
        return list(pids_fn(handle))

    def shutdown(self):
        for h in list(self._handles):
            self.terminate_node(h)
