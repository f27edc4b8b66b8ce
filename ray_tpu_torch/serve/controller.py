"""Serve controller (reference: serve/_private/controller.py ServeController
actor) — registry of apps → deployments → replica actor handles, plus the
autoscaling decision loop. The port's copy, on the port's runtime: the
controller and its named replicas (`SERVE::{app}::{name}#{idx}`) live in
the port's session, so they never meet the JAX package's in one process.
It holds each deployment's class and init arguments as the pickled bytes
`serve.run` sent, so its process loads no torch.
"""

import asyncio
import math
import time
from typing import Dict, List, Optional

CONTROLLER_NAME = "SERVE_CONTROLLER"


class ServeController:
    def __init__(self):
        # {app: {deployment: {"replicas": [handles], "config": DeploymentConfig,
        #        "blob": bytes, "init": (args, kwargs), "version": int}}}
        self.apps: Dict[str, Dict[str, Dict]] = {}
        # route prefix -> (app, ingress deployment, is_streaming)
        self.routes: Dict[str, tuple] = {}
        self._autoscale_task = None
        # SLO-autoscale causality trail, same audited shape as the node
        # reconciler's (reaction time = burst ts -> first record here)
        from ray_tpu_torch.autoscaler.reconciler import ScaleLedger
        self._ledger = ScaleLedger(counter="serve_scale_events_total")

    # -- registry ------------------------------------------------------------
    def register_deployment(self, app: str, name: str, blob, init_args,
                            init_kwargs, config) -> None:
        existing = self.apps.get(app, {}).get(name)
        if existing is not None:
            # redeploy: retire old replicas first (their actor names would
            # collide, and dropping the handles would leak the processes)
            self._scale_to(app, name, 0)
        version = existing["version"] + 1 if existing else 0
        self.apps.setdefault(app, {})[name] = {
            "replicas": [], "config": config, "blob": blob,
            "init": (init_args, init_kwargs), "version": version,
            "next_idx": existing["next_idx"] if existing else 0,
            "last_scale_ts": 0.0,
            # prefix-affinity digests + windowed SLO snapshots, keyed by
            # replica index; refreshed off the autoscale stats gather (or
            # lazily, TTL-gated) and piggybacked to handles in
            # get_replica_state — never a request-path round trip
            "digests": {}, "replica_slo": {}, "digest_ts": 0.0,
        }
        self._scale_to(app, name, config.num_replicas)

    def list_apps(self) -> List[str]:
        return list(self.apps)

    def set_route(self, prefix: str, app: str, ingress: str,
                  is_streaming: bool = False) -> None:
        held_by = self.routes.get(prefix)
        if held_by is not None and held_by[0] != app:
            raise ValueError(
                f"route_prefix '{prefix}' is already used by app "
                f"'{held_by[0]}'; pick a different prefix or delete that app")
        # one route per app: re-registering moves the prefix
        self.routes = {p: t for p, t in self.routes.items() if t[0] != app}
        self.routes[prefix] = (app, ingress, is_streaming)

    def get_routes(self) -> Dict[str, tuple]:
        return dict(self.routes)

    def delete_app(self, app: str) -> None:
        import ray_tpu_torch as rt
        self.routes = {p: t for p, t in self.routes.items() if t[0] != app}
        for name, rec in self.apps.pop(app, {}).items():
            for h in rec["replicas"]:
                try:
                    rt.kill(h)
                except Exception:  # noqa: BLE001 - already dead
                    pass

    def list_deployments(self, app: str) -> List[str]:
        return list(self.apps.get(app, {}))

    def get_replicas(self, app: str, name: str):
        return self.apps[app][name]["replicas"]

    def get_version(self, app: str, name: str) -> int:
        rec = self.apps.get(app, {}).get(name)
        return -1 if rec is None else rec["version"]

    def num_replicas(self, app: str, name: str) -> int:
        return len(self.apps[app][name]["replicas"])

    # seconds a cached digest set stays fresh before get_replica_state
    # re-polls replica stats (RAY_TPU_PREFIX_DIGEST_TTL_S)
    @staticmethod
    def _digest_ttl_s() -> float:
        import os
        try:
            return float(os.environ.get("RAY_TPU_PREFIX_DIGEST_TTL_S", "1.0"))
        except ValueError:
            return 1.0

    def _gather_stats(self, rec) -> list:
        """Poll every replica's stats frame and refresh the digest/SLO
        cache from it — the ONE fan-out both the autoscaler and the lazy
        digest refresh share. Returns [(idx, stats), ...] for replicas
        that answered."""
        import ray_tpu_torch as rt
        refs = [(i, h.stats.remote()) for i, h in enumerate(rec["replicas"])]
        out = []
        digests, slo = {}, {}
        for i, ref in refs:
            try:
                s = rt.get(ref, timeout=5)
            except Exception:  # noqa: BLE001 - replica restarting/dead
                continue
            out.append((i, s))
            if s.get("prefix_digest"):
                digests[i] = s["prefix_digest"]
            if s.get("slo"):
                slo[i] = s["slo"]
        rec["digests"] = digests
        rec["replica_slo"] = slo
        rec["digest_ts"] = time.time()
        return out

    def get_replica_state(self, app: str, name: str) -> Dict:
        """Everything a handle refresh needs in ONE round trip: version,
        replica handles, and the cached prefix-affinity digests. Digests
        are refreshed TTL-gated from here (controller -> replica, off the
        request path) when the autoscaler loop isn't already doing it."""
        rec = self.apps.get(app, {}).get(name)
        if rec is None:
            return {"version": -1, "replicas": [], "digests": {}}
        if time.time() - rec["digest_ts"] > self._digest_ttl_s():
            self._gather_stats(rec)
        return {"version": rec["version"],
                "replicas": list(rec["replicas"]),
                "digests": dict(rec["digests"])}

    # -- scaling -------------------------------------------------------------
    _DRAIN_TIMEOUT_S = 3.0

    def _scale_to(self, app: str, name: str, target: int) -> None:
        import ray_tpu_torch as rt
        from .replica import Replica

        rec = self.apps[app][name]
        cfg = rec["config"]
        replicas = rec["replicas"]
        while len(replicas) < target:
            # monotonic replica index: names never collide with ones being
            # torn down (redeploy) or previously downscaled
            idx = rec.setdefault("next_idx", len(replicas))
            rec["next_idx"] = idx + 1
            opts = dict(cfg.ray_actor_options or {})
            opts.setdefault("max_concurrency", cfg.max_ongoing_requests)
            opts["name"] = f"SERVE::{app}::{name}#{idx}"
            actor_cls = rt.remote(**opts)(Replica)
            args, kwargs = rec["init"]
            replicas.append(actor_cls.remote(rec["blob"], args, kwargs,
                                             cfg.user_config,
                                             (app, name, f"{name}#{idx}")))
        doomed = []
        while len(replicas) > target:
            doomed.append(replicas.pop())
        if doomed:
            # bump version FIRST so handles re-route before the kill lands,
            # then drain: a doomed replica is only killed once its ongoing
            # count hits 0 (or the deadline passes — counted, so the
            # zero-failed-requests drain gate in fleet_bench can assert)
            rec["version"] += 1
            deadline = time.time() + self._DRAIN_TIMEOUT_S
            for h in doomed:
                drained = False
                while time.time() < deadline:
                    try:
                        if rt.get(h.stats.remote(),
                                       timeout=1)["ongoing"] == 0:
                            drained = True
                            break
                    except Exception:  # noqa: BLE001 - already dead
                        drained = True
                        break
                    time.sleep(0.05)
                if not drained:
                    self._ledger.record("drain_timeout", app=app,
                                        deployment=name)
                try:
                    rt.kill(h)
                except Exception:  # noqa: BLE001
                    pass
        rec["version"] += 1
        rec["last_scale_ts"] = time.time()
        # replica indices shifted: cached digests/SLO frames are stale
        rec["digests"], rec["replica_slo"], rec["digest_ts"] = {}, {}, 0.0

    def autoscale_once(self) -> Dict[str, int]:
        """One pass of the autoscaler over every deployment; returns the new
        replica counts. Policy (reference: serve autoscaling_policy.py):
        desired = ceil(total_ongoing / target_ongoing_requests), then the
        SLO overlay: a windowed TTFT/TPOT p99 breach or hot
        batch occupancy forces a one-step scale-up, and scale-down is held
        unless the fleet sits well inside target. Every replica-count
        change (and suppressed change) lands in the scale ledger with its
        reason — the audit trail fleet_bench measures reaction time from.
        The same stats gather refreshes the prefix-digest cache, so
        affinity hints ride the existing refresh for free."""
        decisions = {}
        now = time.time()
        for app, deps in self.apps.items():
            for name, rec in deps.items():
                auto = rec["config"].autoscaling_config
                if auto is None:
                    continue
                stats = self._gather_stats(rec)
                ongoing = sum(s["ongoing"] for _i, s in stats)
                cur = len(rec["replicas"])
                desired, reason = decide_num_replicas_slo(
                    ongoing, cur, auto,
                    aggregate_slo([s.get("slo") for _i, s in stats]))
                decisions[f"{app}:{name}"] = desired
                if desired == cur:
                    continue
                delay = (auto.upscale_delay_s if desired > cur
                         else auto.downscale_delay_s)
                if now - rec["last_scale_ts"] < delay:
                    self._ledger.record("scale_suppressed", app=app,
                                        deployment=name, reason=reason,
                                        cur=cur, desired=desired,
                                        cooldown_s=delay)
                    decisions[f"{app}:{name}"] = cur
                    continue
                self._ledger.record(
                    "scale_up" if desired > cur else "scale_down",
                    app=app, deployment=name, reason=reason,
                    cur=cur, desired=desired, ongoing=ongoing)
                self._scale_to(app, name, desired)
        return decisions

    def scale_events(self, n: int = 64):
        return self._ledger.tail(n)

    def report_replica_death(self, app: str, name: str, actor_id) -> int:
        """A handle hit ActorDiedError on this replica: prune the corpse
        from the fleet and bump the version, so every OTHER handle stops
        routing to it at its next refresh (<= one refresh interval) instead
        of paying a died-retry per request forever. Autoscaled deployments
        get a replacement on the next autoscale tick (len < desired).
        Returns the surviving replica count."""
        rec = self.apps.get(app, {}).get(name)
        if rec is None:
            return 0
        keep = [h for h in rec["replicas"]
                if getattr(h, "_actor_id", None) != actor_id]
        if len(keep) != len(rec["replicas"]):
            rec["replicas"][:] = keep
            rec["version"] += 1
            # replica indices shifted: cached digests/SLO frames are stale
            rec["digests"], rec["replica_slo"], rec["digest_ts"] = {}, {}, 0.0
            self._ledger.record("replica_dead", app=app, deployment=name,
                                actor=str(actor_id))
        return len(keep)

    async def run_autoscaler(self, interval_s: float = 2.0):
        while True:
            await asyncio.sleep(interval_s)
            self.autoscale_once()

    async def start_autoscaler(self, interval_s: float = 2.0):
        # async → runs on the actor's asyncio loop, so the task lives there
        if self._autoscale_task is None:
            self._autoscale_task = asyncio.get_running_loop().create_task(
                self.run_autoscaler(interval_s))
        return True

    def ping(self):
        return "pong"


def aggregate_slo(slo_frames) -> Optional[Dict]:
    """Fleet-level SLO view from per-replica windowed snapshots: worst-case
    (max) p99s — one overloaded replica IS an SLO problem even if the mean
    looks fine — and mean occupancy. None when no replica reported."""
    frames = [f for f in (slo_frames or []) if f]
    if not frames:
        return None
    out = {}
    for key in ("ttft_p99_s", "tpot_p99_ms"):
        vals = [f[key] for f in frames if f.get(key) is not None]
        out[key] = max(vals) if vals else None
    occ = [f["occupancy_mean"] for f in frames
           if f.get("occupancy_mean") is not None]
    out["occupancy_mean"] = sum(occ) / len(occ) if occ else None
    return out


def decide_num_replicas_slo(total_ongoing: float, current: int, auto,
                            slo: Optional[Dict]) -> tuple:
    """Pure SLO-aware scaling decision (unit-testable): start from the
    ongoing-count policy, then overlay the fleet SLO snapshot —

      * breach (windowed TTFT/TPOT p99 over target) or hot batch
        (occupancy >= occupancy_high): force at least current+1;
      * ongoing-count says shrink: only allow it when every tracked p99 is
        within downscale_slo_margin of its target (a fleet near the line
        keeps its headroom).

    Returns (desired, reason) clamped to [min_replicas, max_replicas]."""
    desired = decide_num_replicas(total_ongoing, current, auto)
    reason = "ongoing"
    if slo is not None and current > 0:
        ttft, tpot = slo.get("ttft_p99_s"), slo.get("tpot_p99_ms")
        occ = slo.get("occupancy_mean")
        t_ttft, t_tpot = auto.target_ttft_p99_s, auto.target_tpot_p99_ms
        breach = ((t_ttft is not None and ttft is not None and ttft > t_ttft)
                  or (t_tpot is not None and tpot is not None
                      and tpot > t_tpot))
        hot = occ is not None and occ >= auto.occupancy_high
        if breach or hot:
            desired = max(desired, current + 1)
            reason = "slo_breach" if breach else "occupancy"
        elif desired < current:
            margin = auto.downscale_slo_margin
            inside = ((t_ttft is None or ttft is None
                       or ttft <= margin * t_ttft)
                      and (t_tpot is None or tpot is None
                           or tpot <= margin * t_tpot))
            if not inside:
                desired, reason = current, "slo_hold"
    return (int(min(max(desired, auto.min_replicas), auto.max_replicas)),
            reason)


def decide_num_replicas(total_ongoing: float, current: int, auto) -> int:
    """Pure autoscaling decision (unit-testable): scale toward
    total_ongoing / target, clamped to [min_replicas, max_replicas].
    No special bootstrap branch: with min_replicas=0 and no demand the
    answer stays 0 (a forced floor of 1 would flap 0↔1 every interval)."""
    desired = math.ceil(total_ongoing / max(auto.target_ongoing_requests, 1e-9))
    return int(min(max(desired, auto.min_replicas), auto.max_replicas))


def get_controller():
    """The named controller actor, creating it on first use."""
    import ray_tpu_torch as rt
    try:
        return rt.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    ctrl = rt.remote(num_cpus=0, max_concurrency=16,
                          name=CONTROLLER_NAME)(ServeController).remote()
    # materialize creation before handing out (racing callers get_actor)
    rt.get(ctrl.ping.remote())
    return ctrl
