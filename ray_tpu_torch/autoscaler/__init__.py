"""Autoscaler surface (ref: python/ray/autoscaler/).

Two units of elasticity, mirroring the reference split:

- worker PROCESSES on each host: the controller scales these demand-driven
  (and `sdk.request_resources` warms them ahead of bursts);
- worker NODES across hosts: with a cluster head (init(cluster_port=...))
  and a provider installed via `sdk.set_node_provider`, requests beyond the
  cluster's capacity launch node agents through the NodeProvider seam
  (node_provider.py — the policy/provisioning split of
  python/ray/autoscaler/node_provider.py). A GPU node owns the cards it was
  started with and advertises them as "GPU" (`gcp_gpu.py` for GPU VMs).
"""

from . import sdk
from .gcp_gpu import FakeGpuApi, GcloudGpuApi, GcpGpuNodeProvider, host_info
from .node_provider import NodeProvider, SubprocessNodeProvider
from .reconciler import Reconciler

__all__ = ["sdk", "NodeProvider", "SubprocessNodeProvider",
           "GcpGpuNodeProvider", "GcloudGpuApi", "FakeGpuApi", "host_info",
           "Reconciler"]
