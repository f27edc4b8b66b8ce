"""Autoscaler SDK (ref: python/ray/autoscaler/sdk.py).

`request_resources(num_cpus=..., bundles=[...])` records an explicit demand
with the controller, which warms worker processes up to the request (bounded
by max_workers) so bursty task submission doesn't pay per-task spawn
latency. A bundle's cards are "GPU" (`{"GPU": 8}`). A new call replaces the
previous request (reference overwrite semantics); `request_resources()`
with no arguments clears it.
"""

from typing import Dict, List, Optional

from .._private import state


def request_resources(num_cpus: Optional[int] = None,
                      bundles: Optional[List[Dict[str, float]]] = None) -> dict:
    """Ask the cluster to hold capacity for `num_cpus` CPUs and/or a list of
    resource bundles. Returns {target_cpus, fulfilled_cpus, target_gpus,
    clamped, spawned_workers, launched_nodes}; `clamped` is True when the
    request exceeds what the cluster can provide (without a node provider,
    what this host can)."""
    return state.global_client().request_resources(num_cpus, bundles)


def status() -> dict:
    """Autoscaler view: last request, pool/idle worker counts, pending task
    demand, and cluster totals (ref: `ray status` / autoscaler reporting)."""
    return state.global_client().autoscaler_status()


def set_node_provider(provider, max_nodes: int = 4) -> None:
    """Install a provisioning backend (autoscaler/node_provider.py,
    autoscaler/gcp_gpu.py) on the cluster head. After this,
    `request_resources` beyond the cluster's current capacity launches
    worker nodes through the provider; each node registers itself and
    becomes schedulable, and the head's reconciler replaces a node that
    dies (ref: the reference autoscaler's NodeProvider seam,
    python/ray/autoscaler/node_provider.py). Driver-side only."""
    client = state.global_client()
    if not hasattr(client, "set_node_provider"):
        raise RuntimeError("set_node_provider must run in the head driver")
    client.set_node_provider(provider, max_nodes)
