"""CLI (reference: `ray status` / python/ray/scripts/scripts.py) of the port.

`python -m ray_tpu_torch status` prints cluster health, actors and task
counts of the session at `--address` or RTPT_ADDRESS (attached, loading no
torch), or of a fresh local session; `topology` prints the job's GPU
layout (`util/gpu.py`'s `slice_topology()`); `timeline` exports a chrome
trace; `job` submits, inspects and stops jobs; `dashboard` serves the HTTP
state and job API.
"""

import argparse
import json
import sys


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TiB"


def _render_status(health: dict, alerts: list) -> str:
    """One top-style frame from /api/cluster + /api/alerts payloads. Pure
    function of its inputs so tests render without a live cluster."""
    lines = []
    res = health.get("resources", {})
    total, avail = res.get("total", {}), res.get("available", {})
    lines.append("== Cluster ==")
    for k in sorted(total):
        lines.append(f"  {k:<14} {avail.get(k, 0):g} / {total[k]:g} free")
    q = health.get("queue", {})
    lines.append(f"  queue: ready={q.get('ready', 0)} "
                 f"pending_deps={q.get('pending_deps', 0)}")
    lines.append("== Nodes ==")
    hdr = (f"  {'node':<14} {'alive':<6} {'hb_age':>7} {'queue':>6} "
           f"{'busy':>5} {'idle':>5} {'store':>18} {'objs':>6}")
    lines.append(hdr)
    for n in health.get("nodes", []):
        nid = str(n.get("node_id", "?"))[:14]
        alive = "yes" if n.get("alive") else "DEAD"
        store = (f"{_fmt_bytes(n.get('store_used'))}/"
                 f"{_fmt_bytes(n.get('store_capacity'))}")
        lines.append(
            f"  {nid:<14} {alive:<6} {n.get('heartbeat_age_s', 0.0):>6.1f}s "
            f"{n.get('queue_depth', 0):>6} {n.get('workers_busy', 0):>5} "
            f"{n.get('workers_idle', 0):>5} {store:>18} "
            f"{n.get('store_objects', 0):>6}")
    leaks = health.get("leaks") or []
    if leaks:
        lines.append(f"== Leaks ({len(leaks)}) ==")
        for leak in leaks[:10]:
            lines.append(
                f"  {leak['object_id']}  {leak['reason']}  "
                f"age={leak['ledger']['age_s']:.0f}s  "
                f"owner={leak.get('owner_task') or '-'}")
    a = health.get("alerts", {})
    lines.append(f"== Alerts (active={a.get('active', 0)}, "
                 f"total={a.get('count', 0)}) ==")
    for ev in (alerts or [])[-8:]:
        lines.append(f"  [{ev.get('severity', '?'):<8}] {ev.get('kind')}: "
                     f"{ev.get('message')}")
    return "\n".join(lines)


def _cmd_status(args):
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch.util import state as state_api

    _connect(getattr(args, "address", None))
    watch = (not getattr(args, "once", False)) and sys.stdout.isatty()
    try:
        while True:
            health = state_api.cluster_health()
            alerts = state_api.list_alerts()
            frame = _render_status(health, alerts)
            if watch:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home (top-style)
            print(frame)
            actors = state_api.list_actors()
            print(f"== Actors ({len(actors)}) ==")
            for a in actors:
                print(f"  {a['actor_id']}  {a['state']:<12} "
                      f"name={a['name'] or '-'}")
            print("== Tasks ==")
            print(f"  {json.dumps(state_api.summarize_tasks())}")
            if not watch:
                break
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    rt.shutdown()


def _cmd_topology(args):
    from ray_tpu_torch.util import gpu
    print(json.dumps(gpu.slice_topology(), indent=2))


def _render_bubble(stats: dict) -> str:
    """Bubble-fraction table from tracing.bubble_stats output: per-worker
    gaps between exec-phase windows (pipeline bubbles, scheduling stalls).
    Pure function of its input so tests render without a live cluster."""
    lines = [f"== Bubble fractions (phase={stats['phase']}) ==",
             f"  {'worker':<10} {'windows':>8} {'busy':>9} {'span':>9} "
             f"{'bubble':>9} {'bubble%':>8}"]
    rows = list(stats.get("workers", {}).items())
    for tid, w in rows:
        lines.append(
            f"  {str(tid):<10} {w['windows']:>8} {w['busy_s']:>8.3f}s "
            f"{w['span_s']:>8.3f}s {w['bubble_s']:>8.3f}s "
            f"{w['bubble_fraction'] * 100:>7.1f}%")
    o = stats.get("overall", {})
    lines.append(
        f"  {'overall':<10} {'-':>8} {o.get('busy_s', 0.0):>8.3f}s "
        f"{o.get('span_s', 0.0):>8.3f}s {o.get('bubble_s', 0.0):>8.3f}s "
        f"{o.get('bubble_fraction', 0.0) * 100:>7.1f}%")
    if not rows:
        lines.append("  (no exec-phase windows — is tracing on and did "
                     "any task complete?)")
    return "\n".join(lines)


def _cmd_timeline(args):
    import ray_tpu_torch as rt
    _connect(getattr(args, "address", None))
    events = rt.timeline(args.output)
    print(f"wrote {args.output} ({len(events)} events)")
    if getattr(args, "bubble", False):
        from ray_tpu_torch.util.tracing import bubble_stats
        print(_render_bubble(bubble_stats(events)))
    rt.shutdown()


def _connect(address):
    """Attach to a running session, or start a local one as a fallback.
    Returns "attached" or "ephemeral" (CLI-scoped local session)."""
    import os

    import ray_tpu_torch as rt
    if address or os.environ.get("RTPT_ADDRESS"):
        rt.init(address=address or "auto", ignore_reinit_error=True)
        return "attached"
    rt.init(ignore_reinit_error=True)
    return "ephemeral"


def _job_client(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient
    address = getattr(args, "address", None)
    if address and address.startswith("http"):
        return JobSubmissionClient(address), "attached"
    mode = _connect(address)
    return JobSubmissionClient(), mode


def _cmd_job(args):
    client, session_mode = _job_client(args)
    if args.job_cmd == "submit" and args.no_wait and session_mode == "ephemeral":
        # the session lives in THIS process; returning would tear it down and
        # kill the job moments after submit — wait instead of losing it
        print("warning: no running session (RTPT_ADDRESS unset); the job "
              "runs under this CLI's ephemeral session, so --no-wait is "
              "ignored and logs will stream until it finishes", file=sys.stderr)
        args.no_wait = False
    if args.job_cmd == "submit":
        import shlex
        rte = {}
        if args.working_dir:
            rte["working_dir"] = args.working_dir
        if args.env:
            rte["env_vars"] = dict(kv.split("=", 1) for kv in args.env)
        words = args.entrypoint
        if words and words[0] == "--":
            words = words[1:]
        jid = client.submit_job(entrypoint=shlex.join(words),
                                submission_id=args.submission_id,
                                runtime_env=rte or None)
        print(f"submitted: {jid}")
        if not args.no_wait:
            for chunk in client.tail_job_logs(jid):
                sys.stdout.write(chunk)
                sys.stdout.flush()
            status = client.get_job_status(jid)
            print(f"job {jid} finished: {status.value}")
            sys.exit(0 if status.value == "SUCCEEDED" else 1)
    elif args.job_cmd == "status":
        print(client.get_job_status(args.id).value)
    elif args.job_cmd == "logs":
        if args.follow:
            for chunk in client.tail_job_logs(args.id):
                sys.stdout.write(chunk)
                sys.stdout.flush()
        else:
            sys.stdout.write(client.get_job_logs(args.id))
    elif args.job_cmd == "stop":
        print("stopped" if client.stop_job(args.id) else "already finished")
    elif args.job_cmd == "list":
        for info in client.list_jobs():
            print(f"{info.submission_id}  {info.status:<10} {info.entrypoint}")


def _cmd_dashboard(args):
    import time

    _connect(args.address)
    from ray_tpu_torch.dashboard import start_dashboard
    _actor, port = start_dashboard(args.host, args.port)
    print(f"dashboard: http://{args.host}:{port}  (ctrl-c to exit)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    st = sub.add_parser("status",
                        help="live cluster health (top-style when a TTY)")
    st.add_argument("--address", default=None,
                    help="controller socket path (default: RTPT_ADDRESS)")
    st.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in watch mode (seconds)")
    st.add_argument("--once", action="store_true",
                    help="print one frame and exit (default off a TTY)")
    sub.add_parser("topology", help="GPU topology of the job")
    tl = sub.add_parser("timeline", help="export chrome trace")
    tl.add_argument("--output", default="timeline.json")
    tl.add_argument("--address", default=None,
                    help="controller socket path (default: RTPT_ADDRESS)")
    tl.add_argument("--bubble", action="store_true",
                    help="print per-worker bubble fractions (gaps between "
                         "exec-phase windows)")

    job = sub.add_parser("job", help="submit / inspect / stop jobs")
    jsub = job.add_subparsers(dest="job_cmd", required=True)
    js = jsub.add_parser("submit", help="run an entrypoint as a job")
    js.add_argument("--address", default=None)
    js.add_argument("--submission-id", default=None)
    js.add_argument("--working-dir", default=None)
    js.add_argument("--env", action="append", metavar="K=V")
    js.add_argument("--no-wait", action="store_true",
                    help="return after submit instead of streaming logs")
    js.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for name in ("status", "logs", "stop"):
        p = jsub.add_parser(name)
        p.add_argument("id")
        p.add_argument("--address", default=None)
        if name == "logs":
            p.add_argument("--follow", action="store_true")
    jl = jsub.add_parser("list")
    jl.add_argument("--address", default=None)

    dash = sub.add_parser("dashboard", help="serve the HTTP state/job API")
    dash.add_argument("--host", default="127.0.0.1")
    dash.add_argument("--port", type=int, default=8265)
    dash.add_argument("--address", default=None)

    args = parser.parse_args(argv)
    {"status": _cmd_status, "topology": _cmd_topology,
     "timeline": _cmd_timeline, "job": _cmd_job,
     "dashboard": _cmd_dashboard}[args.cmd](args)


if __name__ == "__main__":
    main()
