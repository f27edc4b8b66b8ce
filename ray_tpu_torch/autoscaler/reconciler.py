"""Alert-driven reconciler: the reaction layer of the resilience subsystem.

Reference: python/ray/autoscaler/_private/autoscaler.py StandardAutoscaler
— an update loop that diffs desired vs actual nodes and drives a
NodeProvider. GPU-native cut: instead of a separate monitor process
polling the GCS, the reconciler is a plain object ticked from the head
controller's existing 1 Hz reaper loop, and its *sensor* is the
alert event log (health.AlertLog) — the same deduplicated events the
dashboard serves at /api/alerts:

  node_dead      → terminate the dead provider handle (if it was ours) and
                   launch a replacement node, recording the alert-id →
                   create_node causality so time-to-replace is auditable
  store_pressure → scale up one node (cooldown-gated)
  queue_growth   → scale up one node (cooldown-gated)
  (idle)         → after RAY_TPU_SCALE_DOWN_IDLE_S of empty queue and no
                   active alerts, terminate one idle provider node

Every action appends a causality record to `self.events` and lands trace
windows in the head timeline (`reconcile.replace` = alert → create_node,
`reconcile.recovered` = create_node → replacement registered), so
`python -m ray_tpu_torch timeline` shows detect / replace / recovered side by
side with the lineage-recovery windows.

Clock-injectable and built against a narrow controller surface (health,
node_provider, provider_max_nodes, _provider_nodes, cluster, ready_queue)
so tests drive it with fakes and a fake clock — no subprocesses, no sleeps.

Env knobs:
  RAY_TPU_AUTOSCALE             "0" disables the loop entirely
  RAY_TPU_SCALE_UP_COOLDOWN_S   min seconds between pressure scale-ups (10)
  RAY_TPU_SCALE_DOWN_IDLE_S     idle seconds before scale-down (60)
"""

import os
import time
from typing import Callable, Dict, List, Optional


def scale_up_cooldown_s() -> float:
    try:
        return float(os.environ.get("RAY_TPU_SCALE_UP_COOLDOWN_S", "10"))
    except ValueError:
        return 10.0


def scale_down_idle_s() -> float:
    try:
        return float(os.environ.get("RAY_TPU_SCALE_DOWN_IDLE_S", "60"))
    except ValueError:
        return 60.0


class ScaleLedger:
    """Bounded causality audit trail for scaling actions — the
    reconciler's `_record` shape, factored out so the serve controller's
    SLO-driven deployment scaling runs through the same path:
    every action appends a timestamped record and bumps a tagged counter,
    giving `fleet_bench` and the tests an exact reaction-time measurement
    (burst start -> first scale_up record). Clock-injectable like the
    reconciler itself."""

    def __init__(self, clock: Callable[[], float] = time.time,
                 cap: int = 256, counter: str = "reconciler_actions_total"):
        self.clock = clock
        self.cap = cap
        self.counter = counter
        self.events: List[dict] = []

    def record(self, action: str, **fields) -> dict:
        ev = {"ts": self.clock(), "action": action}
        ev.update(fields)
        self.events.append(ev)
        del self.events[:-self.cap]
        try:
            from ..util import metrics
            metrics.get_or_create(
                metrics.Counter, self.counter,
                "scaling actions by type", tag_keys=("action",)
            ).inc(tags={"action": action})
        except Exception:  # noqa: BLE001 - actions must not need metrics
            pass
        return ev

    def tail(self, n: int = 32) -> List[dict]:
        return [dict(ev) for ev in self.events[-n:]]


class Reconciler:
    # alert kinds that demand capacity (vs node_dead's replacement path)
    _PRESSURE_KINDS = ("store_pressure", "queue_growth")

    def __init__(self, controller, clock: Callable[[], float] = time.time):
        self.c = controller
        self.clock = clock
        # AlertLog event ids are monotone; the cursor makes consumption
        # exactly-once across ticks (events() re-returns the whole ring).
        # Start at the log's tail: alerts raised BEFORE the provider was
        # installed describe history the operator already dealt with —
        # replaying them would spawn a node per past death on install.
        self._cursor = 0
        try:
            evs = controller.health.alerts.events()
            if evs:
                self._cursor = evs[-1]["id"]
        except Exception:  # noqa: BLE001 - health not wired in some fakes
            pass
        self._cooldown_until = 0.0
        self._idle_since: Optional[float] = None
        # handle -> {"t_create": ..., "alert_id": ..., "kind": ...} for
        # launches awaiting registration (time-to-recovered measurement)
        self._pending: Dict[str, dict] = {}
        self._ledger = ScaleLedger(clock=clock)
        self.events = self._ledger.events  # causality audit trail (bounded)
        self.replacements = 0
        self.scale_ups = 0
        self.scale_downs = 0

    # ------------------------------------------------------------- plumbing
    def _launch_res(self) -> Dict[str, float]:
        prov = self.c.node_provider
        per_node = {"CPU": float(getattr(prov, "cpus_per_node", 2.0)),
                    "GPU": float(getattr(prov, "gpus_per_node", 0.0))}
        return {k: v for k, v in per_node.items() if v > 0}

    def _registered_pids(self, alive_only: bool = True) -> set:
        cluster = getattr(self.c, "cluster", None)
        if cluster is None:
            return set()
        return {n.pid for n in cluster.nodes.values()
                if n.pid and (n.alive or not alive_only)}

    def _record(self, action: str, handle: Optional[str],
                alert: Optional[dict], **extra):
        fields = {"handle": handle,
                  "alert_id": alert["id"] if alert else None,
                  "alert_kind": alert["kind"] if alert else None,
                  "alert_key": alert["key"] if alert else None}
        fields.update(extra)  # callers may override (e.g. recovered's
        return self._ledger.record(action, **fields)  # explicit alert_id)

    def _window(self, name: str, t0: float, t1: float, **args):
        try:
            from ..util import tracing
            tracing.record_window(name, "recovery", None, t0, t1,
                                  args=args or None)
        except Exception:  # noqa: BLE001
            pass

    def _create(self, alert: Optional[dict], action: str) -> Optional[str]:
        c = self.c
        if len(c._provider_nodes) >= c.provider_max_nodes:
            self._record(f"{action}_clamped", None, alert,
                         reason="provider_max_nodes")
            return None
        res = self._launch_res()
        try:
            handle = c.node_provider.create_node(res, c.cluster.address)
        except Exception as e:  # noqa: BLE001 - provisioning failure
            self._record(f"{action}_failed", None, alert, error=repr(e))
            return None
        c._provider_nodes[handle] = dict(res)
        now = self.clock()
        self._pending[handle] = {
            "t_create": now,
            "t_alert": alert["ts"] if alert else now,
            "alert_id": alert["id"] if alert else None,
            "kind": action}
        self._record(action, handle, alert)
        if alert is not None:
            # alert fired → node launched: the time-to-replace window
            self._window(f"reconcile.{action}", alert["ts"], now,
                         handle=handle, alert_id=alert["id"],
                         alert_kind=alert["kind"])
        return handle

    # ------------------------------------------------------------ main loop
    def tick(self) -> None:
        c = self.c
        if c.node_provider is None or c.cluster is None:
            return
        now = self.clock()
        alerts = [ev for ev in c.health.alerts.events()
                  if ev["id"] > self._cursor]
        if alerts:
            self._cursor = alerts[-1]["id"]
        for ev in alerts:
            if ev["kind"] == "node_dead":
                self._on_node_dead(ev)
            elif ev["kind"] in self._PRESSURE_KINDS:
                self._on_pressure(ev, now)
        self._check_recovered(now)
        self._maybe_scale_down(now)

    def _on_node_dead(self, alert: dict) -> None:
        c = self.c
        # our handle? (the dead node's agent was provider-launched): release
        # the provider slot and reap the corpse so the replacement isn't
        # blocked on provider_max_nodes
        dead = c.health.dead_nodes.get(alert["key"], {})
        dead_pid = dead.get("pid") or alert.get("data", {}).get("pid")
        live_pids = self._registered_pids()
        pid_of = getattr(c.node_provider, "pid_of", lambda _h: None)
        try:
            live_handles = set(c.node_provider.non_terminated_nodes())
        except Exception:  # noqa: BLE001
            live_handles = set(c._provider_nodes)
        for h in list(c._provider_nodes):
            pid = pid_of(h)
            ours = pid is not None and dead_pid is not None and pid == dead_pid
            # a handle whose process is gone AND is not a live registered
            # node is a corpse either way (covers pid-less death alerts)
            corpse = (h not in live_handles
                      and pid is not None and pid not in live_pids
                      and h not in self._pending)
            if ours or corpse:
                try:
                    c.node_provider.terminate_node(h)
                except Exception:  # noqa: BLE001 - already gone
                    pass
                c._provider_nodes.pop(h, None)
                self._pending.pop(h, None)
                self._record("terminate_dead", h, alert)
        handle = self._create(alert, "replace")
        if handle is not None:
            self.replacements += 1

    def _on_pressure(self, alert: dict, now: float) -> None:
        if now < self._cooldown_until:
            self._record("scale_up_suppressed", None, alert,
                         cooldown_until=self._cooldown_until)
            return
        handle = self._create(alert, "scale_up")
        if handle is not None:
            self.scale_ups += 1
            self._cooldown_until = now + scale_up_cooldown_s()

    def _check_recovered(self, now: float) -> None:
        """A pending launch whose agent pid shows up among registered alive
        nodes is recovered: close the create_node → registered window."""
        pid_of = getattr(self.c.node_provider, "pid_of", lambda _h: None)
        live_pids = self._registered_pids()
        for h, info in list(self._pending.items()):
            pid = pid_of(h)
            if pid is not None and pid in live_pids:
                del self._pending[h]
                self._record("recovered", h, None,
                             alert_id=info["alert_id"],
                             elapsed_s=round(now - info["t_create"], 3))
                self._window("reconcile.recovered", info["t_create"], now,
                             handle=h, alert_id=info["alert_id"],
                             kind=info["kind"])

    def _maybe_scale_down(self, now: float) -> None:
        c = self.c
        busy = (len(c.ready_queue) > 0
                or bool(c.health.alerts.active_count())
                or bool(self._pending))
        if busy:
            self._idle_since = None
            return
        if self._idle_since is None:
            self._idle_since = now
            return
        if now - self._idle_since < scale_down_idle_s():
            return
        # terminate ONE idle provider node per idle period: pick a handle
        # whose registered node (if any) has nothing running
        pid_of = getattr(c.node_provider, "pid_of", lambda _h: None)
        by_pid = {n.pid: n for n in c.cluster.nodes.values() if n.alive}
        for h in list(c._provider_nodes):
            node = by_pid.get(pid_of(h))
            if node is not None and (node.inflight or node.actors):
                continue
            try:
                c.node_provider.terminate_node(h)
            except Exception:  # noqa: BLE001
                pass
            c._provider_nodes.pop(h, None)
            self.scale_downs += 1
            self._record("scale_down", h, None,
                         idle_s=round(now - self._idle_since, 3))
            break
        self._idle_since = None  # one per idle period, re-armed fresh

    # -------------------------------------------------------------- surface
    def status(self) -> dict:
        return {
            "cursor": self._cursor,
            "replacements": self.replacements,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "pending": {h: dict(i) for h, i in self._pending.items()},
            "events": self.events[-32:],
        }
