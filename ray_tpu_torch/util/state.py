"""State API (reference: python/ray/util/state/api.py — list_actors,
list_tasks, list_objects, list_nodes, list_workers, summarize_*), read
from the port runtime's controller through `_private/state.py`'s client.
"""

from typing import Any, Dict, List, Optional


def _snapshot(kind: str) -> List[Dict]:
    from ray_tpu_torch._private import state as _state
    client = _state.global_client_or_none()
    if client is None:
        raise RuntimeError("ray_tpu_torch is not initialized")
    return client.state(kind)


def _filtered(rows: List[Dict], filters) -> List[Dict]:
    """filters: [(key, "=", value)] triples (reference predicate shape)."""
    for key, op, value in filters or []:
        if op in ("=", "=="):
            rows = [r for r in rows if r.get(key) == value]
        elif op == "!=":
            rows = [r for r in rows if r.get(key) != value]
        else:
            raise ValueError(f"unsupported filter op {op!r}")
    return rows


def list_actors(filters=None, limit: int = 100) -> List[Dict]:
    return _filtered(_snapshot("actors"), filters)[:limit]


def list_tasks(filters=None, limit: int = 100) -> List[Dict]:
    return _filtered(_snapshot("tasks"), filters)[:limit]


def get_task(task_id: str) -> Optional[Dict]:
    """One task's row, including its trace context and per-phase durations
    once it completed: ``phases={queued, prefetch, exec, publish}`` in
    seconds (``prefetch`` only when an eager pull ran for its args; None
    while the task is still in flight). Forwarded tasks carry the phases
    computed by their node's controller."""
    for row in _snapshot("tasks"):
        if row.get("task_id") == task_id:
            return row
    return None


def list_objects(filters=None, limit: int = 100) -> List[Dict]:
    return _filtered(_snapshot("objects"), filters)[:limit]


def list_workers(filters=None, limit: int = 100) -> List[Dict]:
    return _filtered(_snapshot("workers"), filters)[:limit]


def list_nodes(filters=None, limit: int = 100) -> List[Dict]:
    return _filtered(_snapshot("nodes"), filters)[:limit]


def summarize_tasks() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for t in _snapshot("tasks"):
        out[t["state"]] = out.get(t["state"], 0) + 1
    return out


def summarize_actors() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for a in _snapshot("actors"):
        out[a["state"]] = out.get(a["state"], 0) + 1
    return out


def cluster_health() -> Dict[str, Any]:
    """The /api/cluster aggregate: per-node health rows (dead nodes kept as
    tombstones), resource totals, queue state, alert tail, current leaks."""
    return _snapshot("cluster_health")


def list_alerts(limit: int = 100) -> List[Dict]:
    """Chronological threshold-rule alert events (store pressure, node
    death, heartbeat silence, queue growth, object leaks)."""
    return _snapshot("alerts")[-limit:]


def summarize_objects() -> Dict[str, Any]:
    objs = _snapshot("objects")
    by_loc: Dict[str, int] = {}
    total = 0
    for o in objs:
        by_loc[o["location"]] = by_loc.get(o["location"], 0) + 1
        total += o.get("size") or 0
    return {"count": len(objs), "total_bytes": total, "by_location": by_loc}
