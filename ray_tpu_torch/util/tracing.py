"""Tracing: spans with trace/span/parent ids in a per-process bounded ring
buffer, and the readers that turn them into bubble and overlap shares.

The port's own copy of `ray_tpu/util/tracing.py`, with its API, semantics
and environment knobs, without `stamp` (the runtime's TaskSpec submit
path, which the port does not have). The ring is process-global and
separate from the JAX package's; its drop counter registers in the port's
`util/metrics.py`. In a `ray_tpu` worker this module's ship outbox is not
drained: the worker's task_done frame carries
`ray_tpu.util.tracing.take_shipped()` only, so the port's windows stay in
that worker's ring (read them there with `events()`).

Recording stays cheap: `record_span` appends ONE tuple to a deque, ids are
a cached process prefix + an integer counter, `enabled()` is a cached
module bool (re-read by `refresh()`), and formatting is lazy (`events()`).
Sampling (`RAY_TPU_TRACE_SAMPLE`) is decided once per trace,
deterministically from the trace id (crc32), so every holder of the id
agrees.

Timestamps are `time.time()` epoch seconds, so spans from several
processes of one host land on one axis (the Chrome trace's). A window of
work on a CUDA device is timed by the device instead (`DeviceClock`): a
pair of CUDA events on the device's current stream, recorded without a
host sync, put on the same axis when the ring is read, through one
host/device anchor a clock taken at the first read.

Env knobs:
  RAY_TPU_TRACE         "0" disables tracing entirely (default: on)
  RAY_TPU_TRACE_SAMPLE  fraction of traces recorded (default 1.0)
  RAY_TPU_TRACE_BUFFER  per-process ring capacity in spans (default 65536)
"""

import itertools
import os
import threading
import time
import zlib
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "enabled", "sample_rate", "refresh", "new_trace_id", "new_span_id",
    "trace_id_for", "record_span", "span", "set_current", "get_current",
    "current_trace_id", "events", "drain", "clear", "to_chrome", "summary",
    "set_process_label", "record_window", "ship_window", "take_shipped",
    "bubble_stats", "overlap_stats", "DeviceClock",
]

_lock = threading.Lock()

_enabled: bool = True
_sample: float = 1.0
_buf: deque = deque(maxlen=65536)
_dropped: int = 0
# next(_count) is a single C-level op under the GIL: no lock on the id path
_count = itertools.count(1)
_id_prefix: str = ""
_process_label: str = ""
# CUDA events this process created for device windows (DeviceClock): none
# while tracing is off
DEVICE_EVENTS = 0


class _Ctx(threading.local):
    trace: Tuple[Optional[str], Optional[int]] = (None, None)


_ctx = _Ctx()

# spans queued for shipment to a head timeline (Chrome-format dicts, ts/dur
# in µs); bounded, so an outbox nobody drains is harmless
_ship_outbox: List[Dict[str, Any]] = []
_SHIP_CAP = 4096


def refresh() -> None:
    """Re-read the env knobs (process start, tests, bench mode flips)."""
    global _enabled, _sample, _buf, _dropped, _id_prefix
    with _lock:
        _enabled = os.environ.get("RAY_TPU_TRACE", "1") not in ("0", "false")
        try:
            _sample = float(os.environ.get("RAY_TPU_TRACE_SAMPLE", "1.0"))
        except ValueError:
            _sample = 1.0
        try:
            cap = int(os.environ.get("RAY_TPU_TRACE_BUFFER", "65536"))
        except ValueError:
            cap = 65536
        cap = max(16, cap)
        if _buf.maxlen != cap:
            _buf = deque(_buf, maxlen=cap)
        _id_prefix = f"{os.getpid():x}-"


def trace_id_for(key: str) -> Optional[str]:
    """Sampled trace id derived from an already-unique key: the key itself
    is the id, and any holder of the key re-derives the same sampling
    verdict."""
    if not _enabled:
        return None
    if _sample >= 1.0:
        return key
    if _sample <= 0.0:
        return None
    if (zlib.crc32(key.encode()) % 10000) < int(_sample * 10000):
        return key
    return None


refresh()


def enabled() -> bool:
    return _enabled


def sample_rate() -> float:
    return _sample


def set_process_label(label: str) -> None:
    """Human name for this process in Chrome traces ("learner", "node:x")."""
    global _process_label
    _process_label = label


def new_trace_id() -> Optional[str]:
    """Mint a fresh trace id (root spans with no natural key: serve
    requests, data pipelines), or None when this trace is not sampled."""
    if not _enabled:
        return None
    return trace_id_for(_id_prefix + format(next(_count), "x"))


def new_span_id() -> int:
    return next(_count)


def set_current(trace_id: Optional[str], span_id: Optional[int]) -> None:
    _ctx.trace = (trace_id, span_id)


def get_current() -> Tuple[Optional[str], Optional[int]]:
    return _ctx.trace


def current_trace_id() -> Optional[str]:
    return _ctx.trace[0]


def record_span(name: str, cat: str, trace_id: Optional[str],
                span_id: Optional[int], parent_id: Optional[int],
                ts: float, dur: float,
                tid: Any = 0, args: Optional[dict] = None) -> None:
    """Append one completed span. ``ts`` is epoch seconds, ``dur`` seconds.

    Raw tuples only: formatting happens in ``events()``/``to_chrome()``.
    """
    global _dropped
    if not _enabled:
        return
    buf = _buf
    if len(buf) == buf.maxlen:
        _dropped += 1
        # ring overwrite is silent data loss: surface it as a counter (only
        # this degraded path pays the registry lookup)
        try:
            from . import metrics
            metrics.get_or_create(
                metrics.Counter, "tracing_spans_dropped",
                "spans evicted from the trace ring before drain").inc()
        except Exception:  # noqa: BLE001 - tracing must never raise
            pass
    buf.append((name, cat, trace_id, span_id, parent_id, ts, dur, tid, args))


def record_window(name: str, cat: str, trace_id: Optional[str],
                  t0: float, t1: float, tid: Any = 0,
                  args: Optional[dict] = None,
                  parent_id: Optional[int] = None) -> None:
    """Record a span whose window the caller measured (epoch seconds), for
    phases that straddle awaits where ``span()`` cannot wrap the region
    (the PD request's queue / prefill / kv_ship windows)."""
    if not _enabled:
        return
    record_span(name, cat, trace_id, new_span_id(), parent_id, t0,
                max(0.0, t1 - t0), tid=tid, args=args)


def _outbox_put(ev: Dict[str, Any]) -> None:
    global _dropped
    with _lock:
        if len(_ship_outbox) < _SHIP_CAP:
            _ship_outbox.append(ev)
        else:
            _dropped += 1


def _ship_event(name, cat, trace_id, tid, args) -> Dict[str, Any]:
    ev: Dict[str, Any] = {"name": name, "cat": cat, "ph": "X",
                          "pid": os.getpid(), "tid": tid}
    ar = dict(args or {})
    if trace_id is not None:
        ar["trace_id"] = trace_id
    if ar:
        ev["args"] = ar
    return ev


def ship_window(name: str, cat: str, trace_id: Optional[str],
                t0: float, t1: float, tid: Any = 0,
                args: Optional[dict] = None) -> None:
    """``record_window`` + queue the span for shipment to a head timeline
    (``take_shipped``). The outbox is bounded, so an undrained one is
    harmless."""
    if not _enabled:
        return
    record_window(name, cat, trace_id, t0, t1, tid=tid, args=args)
    ev = _ship_event(name, cat, trace_id, tid, args)
    ev["ts"], ev["dur"] = t0 * 1e6, max(t1 - t0, 1e-6) * 1e6
    _outbox_put(ev)


def take_shipped() -> List[Dict[str, Any]]:
    """Drain the ship outbox: each queued span is returned exactly once
    (device windows resolved to the wall-clock axis)."""
    with _lock:
        if not _ship_outbox:
            return []
        out = _ship_outbox[:]
        del _ship_outbox[:]
    for ev in out:
        win = ev.pop("_window", None)
        if win is not None:
            t0, dur = win.resolve()
            ev["ts"], ev["dur"] = t0 * 1e6, max(dur, 1e-6) * 1e6
    return out


@contextmanager
def span(name: str, cat: str = "app", trace_id: Optional[str] = None,
         parent_id: Optional[int] = None, tid: Any = 0,
         args: Optional[dict] = None):
    """Context manager for non-hot paths (serve ticks, data blocks)."""
    if not _enabled:
        yield None
        return
    if trace_id is None:
        trace_id, cur = get_current()
        if parent_id is None:
            parent_id = cur
    sid = new_span_id()
    t0 = time.time()
    m0 = time.monotonic()
    try:
        yield sid
    finally:
        record_span(name, cat, trace_id, sid, parent_id, t0,
                    time.monotonic() - m0, tid=tid, args=args)


# -- device windows ----------------------------------------------------------

def _record_event(device):
    """A timing CUDA event recorded now on `device`'s current stream (no
    host sync)."""
    global DEVICE_EVENTS
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    DEVICE_EVENTS += 1
    return ev


class _DeviceWindow:
    """An (start, end) event pair of one DeviceClock, resolved to (epoch
    seconds, seconds) once, at the first read."""

    __slots__ = ("clock", "start", "end", "_resolved")

    def __init__(self, clock: "DeviceClock", start, end):
        self.clock, self.start, self.end = clock, start, end
        self._resolved: Optional[Tuple[float, float]] = None

    def resolve(self) -> Tuple[float, float]:
        if self._resolved is None:
            self.end.synchronize()
            t_anchor, anchor = self.clock.anchor()
            t0 = t_anchor - self.start.elapsed_time(anchor) / 1e3
            self._resolved = (t0, max(0.0, self.start.elapsed_time(self.end) / 1e3))
        return self._resolved


class DeviceClock:
    """Times windows of work enqueued on one CUDA device: `start()` records
    an event on the device's current stream, `ship_window(...)` records the
    end event on it and appends the window, unresolved, to the ring and the
    ship outbox. Neither waits for the device. The ring's readers
    (`events()`, `drain()`, `take_shipped()`) resolve each window: they wait
    for its end event and place it on the wall-clock axis through this
    clock's anchor, an event recorded on the idle device at a known
    `time.time()` (taken once, at the first read). With tracing off,
    `start()` returns None and no event is created."""

    def __init__(self, device):
        self.device = device
        self._anchor: Optional[Tuple[float, Any]] = None

    def start(self):
        """The window's start event, or None when tracing is off."""
        if not _enabled:
            return None
        return _record_event(self.device)

    def anchor(self) -> Tuple[float, Any]:
        """(epoch seconds, event) of one instant on this device."""
        if self._anchor is None:
            import torch
            torch.cuda.synchronize(self.device)
            t = time.time()
            ev = _record_event(self.device)
            ev.synchronize()
            self._anchor = (t, ev)
        return self._anchor

    def ship_window(self, name: str, cat: str, trace_id: Optional[str], start,
                    tid: Any = 0, args: Optional[dict] = None) -> None:
        """The module's ``ship_window`` for a window opened by `start()`:
        it ends now, on the device's current stream."""
        if start is None or not _enabled:
            return
        win = _DeviceWindow(self, start, _record_event(self.device))
        record_span(name, cat, trace_id, new_span_id(), None, win, None,
                    tid=tid, args=args)
        ev = _ship_event(name, cat, trace_id, tid, args)
        ev["_window"] = win
        _outbox_put(ev)


# -- readers -----------------------------------------------------------------

def _format(raw) -> Dict[str, Any]:
    name, cat, trace_id, span_id, parent_id, ts, dur, tid, args = raw
    if dur is None:     # a device window
        ts, dur = ts.resolve()
    d: Dict[str, Any] = {"name": name, "cat": cat, "ts": ts, "dur": dur,
                         "pid": os.getpid(), "tid": tid}
    if trace_id is not None:
        d["trace_id"] = trace_id
    if span_id is not None:
        d["span_id"] = span_id
    if parent_id is not None:
        d["parent_id"] = parent_id
    if args:
        d["args"] = dict(args)
    return d


def events() -> List[Dict[str, Any]]:
    """Formatted copy of the ring (does not clear)."""
    with _lock:
        raw = list(_buf)
    return [_format(r) for r in raw]


def drain(max_n: Optional[int] = None) -> List[Dict[str, Any]]:
    """Pop up to ``max_n`` oldest spans, formatted, so that each span is
    forwarded exactly once."""
    out = []
    with _lock:
        n = len(_buf) if max_n is None else min(max_n, len(_buf))
        for _ in range(n):
            out.append(_buf.popleft())
    return [_format(r) for r in out]


def clear() -> None:
    global _dropped
    with _lock:
        _buf.clear()
        del _ship_outbox[:]
        _dropped = 0
    if hasattr(_ctx, "trace"):
        _ctx.trace = (None, None)


def to_chrome(evts: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Convert formatted span dicts (ts/dur in SECONDS) to Chrome
    ``trace_event`` complete ("X") events (ts/dur in MICROSECONDS),
    loadable in Perfetto / chrome://tracing."""
    out = []
    for e in evts:
        ev = {"name": e.get("name", "?"), "cat": e.get("cat", "app"),
              "ph": "X", "pid": e.get("pid", 1), "tid": e.get("tid", 0),
              "ts": e["ts"] * 1e6, "dur": max(e.get("dur", 0.0), 1e-6) * 1e6}
        ar = dict(e.get("args") or {})
        for k in ("trace_id", "span_id", "parent_id"):
            if k in e:
                ar[k] = e[k]
        if ar:
            ev["args"] = ar
        out.append(ev)
    if _process_label:
        out.append({"name": "process_name", "ph": "M", "pid": os.getpid(),
                    "tid": 0, "args": {"name": _process_label}})
    return out


def _merge_windows(wins: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sort + coalesce overlapping [t0, t1) intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(wins):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def bubble_stats(events: List[Dict[str, Any]], phase: str = "exec",
                 name_prefix: str = "",
                 extra_cats: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Per-worker bubble fractions from a Chrome-trace event list (ts/dur
    in µs).

    Groups ``task_phase`` windows whose ``args.phase`` matches by ``tid``
    and measures, per tid, the idle gap between its first window start and
    last window end:

        bubble_fraction = 1 - busy / span

    ``name_prefix`` filters to task names starting with it; ``extra_cats``
    additionally admits whole events of those categories (e.g. "pipeline"
    for the stages' fwd/bwd windows, a tid per stage). 1F1B's steady
    state should sit near the GPipe bound (S-1)/(M+S-1).
    """
    per_tid: Dict[Any, List[Tuple[float, float]]] = {}
    for e in events:
        if e.get("ph") not in (None, "X") or "ts" not in e:
            continue
        cat = e.get("cat")
        if cat == "task_phase":
            a = e.get("args") or {}
            if a.get("phase") != phase:
                continue
            if name_prefix and not str(e.get("name", "")).startswith(
                    name_prefix):
                continue
        elif cat not in extra_cats:
            continue
        t0 = e["ts"] / 1e6
        per_tid.setdefault(e.get("tid", 0), []).append(
            (t0, t0 + e.get("dur", 0.0) / 1e6))
    workers = {}
    for tid, wins in sorted(per_tid.items(), key=lambda kv: str(kv[0])):
        merged = _merge_windows(wins)
        busy = sum(b - a for a, b in merged)
        span_s = merged[-1][1] - merged[0][0]
        bubble = max(span_s - busy, 0.0)
        workers[tid] = {
            "windows": len(wins), "busy_s": busy, "span_s": span_s,
            "bubble_s": bubble,
            "bubble_fraction": bubble / span_s if span_s > 0 else 0.0}
    total_busy = sum(w["busy_s"] for w in workers.values())
    total_span = sum(w["span_s"] for w in workers.values())
    return {"phase": phase, "workers": workers,
            "overall": {
                "busy_s": total_busy, "span_s": total_span,
                "bubble_s": max(total_span - total_busy, 0.0),
                "bubble_fraction": (1.0 - total_busy / total_span)
                                   if total_span > 0 else 0.0}}


def overlap_stats(events: List[Dict[str, Any]], name_a: str,
                  name_b: str) -> Dict[str, Any]:
    """Wall-clock overlap between two span families in a Chrome-trace event
    list (ts/dur in µs). Windows whose ``name`` starts with ``name_a``
    (resp. ``name_b``) are merged across all pids/tids, and the
    intersection of the two merged interval sets is measured:

        overlap_fraction = overlap_s / min(busy_a, busy_b)

    A decoupled pipeline reads near 1, a synchronous loop near 0."""
    wins: Dict[str, List[Tuple[float, float]]] = {"a": [], "b": []}
    for e in events:
        if e.get("ph") not in (None, "X") or "ts" not in e:
            continue
        name = str(e.get("name", ""))
        t0 = e["ts"] / 1e6
        w = (t0, t0 + e.get("dur", 0.0) / 1e6)
        if name.startswith(name_a):
            wins["a"].append(w)
        elif name.startswith(name_b):
            wins["b"].append(w)
    a = _merge_windows(wins["a"])
    b = _merge_windows(wins["b"])
    busy_a = sum(t1 - t0 for t0, t1 in a)
    busy_b = sum(t1 - t0 for t0, t1 in b)
    overlap = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            overlap += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    floor = min(busy_a, busy_b)
    return {"windows_a": len(wins["a"]), "windows_b": len(wins["b"]),
            "busy_a_s": busy_a, "busy_b_s": busy_b, "overlap_s": overlap,
            "overlap_fraction": overlap / floor if floor > 0 else 0.0}


def summary() -> Dict[str, Any]:
    """Cheap per-process health snapshot for bench records."""
    with _lock:
        n = len(_buf)
        cats: Dict[str, int] = {}
        for r in _buf:
            cats[r[1]] = cats.get(r[1], 0) + 1
    return {"enabled": _enabled, "sample": _sample, "spans": n,
            "dropped": _dropped, "by_cat": cats}
