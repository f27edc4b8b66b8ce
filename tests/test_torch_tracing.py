"""ray_tpu_torch.util.tracing against ray_tpu.util.tracing on the CPU: the
cases of tests/test_tracing.py that need no runtime (the ring's bound and
drops, the sampling and its edges, the thread-local context, drain, the
Chrome export) and `test_tracing_overlap_stats_math`
(tests/test_rllib_sebulba.py), each run on both modules; the same inputs
give equal outputs (`test_same_outputs`). `stamp` (the runtime's TaskSpec
submit path) is not in the port. Then the port's own device windows
(`DeviceClock`), whose resolution is checked with stand-in events."""

import json
import threading

import pytest

from ray_tpu.util import tracing as jtracing
from ray_tpu_torch.util import metrics as tmetrics
from ray_tpu_torch.util import tracing as ttracing

MODS = {"jax": jtracing, "port": ttracing}


@pytest.fixture(autouse=True)
def _reset_port_tracing():
    """The port's ring is its own: reset it around each test, as conftest
    resets JAX's after each."""
    ttracing.clear()
    yield
    ttracing.clear()
    ttracing.refresh()


@pytest.fixture(params=sorted(MODS))
def tracing(request):
    return MODS[request.param]


def test_ring_is_bounded_and_counts_drops(tracing, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE_BUFFER", "16")
    tracing.refresh()
    for i in range(40):
        tracing.record_span(f"s{i}", "test", None, i, None, 0.0, 0.0)
    assert len(tracing.events()) == 16
    assert tracing.events()[-1]["name"] == "s39"
    assert tracing.summary()["dropped"] >= 40 - 16


def test_dropped_spans_count_in_own_registry(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE_BUFFER", "16")
    ttracing.refresh()
    before = tmetrics._counter_total("tracing_spans_dropped")
    for i in range(20):
        ttracing.record_span(f"s{i}", "test", None, i, None, 0.0, 0.0)
    assert tmetrics._counter_total("tracing_spans_dropped") - before == 4
    assert ttracing.summary()["dropped"] == 4


def test_sampling_is_deterministic_and_proportional(tracing, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", "0.5")
    tracing.refresh()
    keys = [f"t-{i:04d}" for i in range(1000)]
    first = [tracing.trace_id_for(k) for k in keys]
    assert [tracing.trace_id_for(k) for k in keys] == first
    kept = [t for t in first if t is not None]
    assert all(t in keys for t in kept)
    assert 350 < len(kept) < 650


def test_sample_edges(tracing, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", "0.0")
    tracing.refresh()
    assert tracing.trace_id_for("t-x") is None
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", "1.0")
    tracing.refresh()
    assert tracing.trace_id_for("t-x") == "t-x"
    monkeypatch.setenv("RAY_TPU_TRACE", "0")
    tracing.refresh()
    assert tracing.trace_id_for("t-x") is None
    assert tracing.new_trace_id() is None
    tracing.record_window("w", "test", None, 0.0, 1.0)
    tracing.ship_window("w", "test", None, 0.0, 1.0)
    with tracing.span("s") as sid:
        assert sid is None
    assert tracing.events() == [] and tracing.take_shipped() == []


def test_span_context_is_thread_local(tracing):
    seen = {}

    def other():
        seen["other"] = tracing.current_trace_id()

    tracing.set_current("t-main", 1)
    try:
        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert tracing.get_current() == ("t-main", 1)
    finally:
        tracing.set_current(None, None)
    assert seen["other"] is None


def test_drain_pops_each_span_exactly_once(tracing):
    for i in range(10):
        tracing.record_span(f"d{i}", "test", None, i, None, 0.0, 0.0)
    a = tracing.drain(4)
    b = tracing.drain()
    assert [e["name"] for e in a] == [f"d{i}" for i in range(4)]
    assert [e["name"] for e in b] == [f"d{i}" for i in range(4, 10)]
    assert tracing.drain() == []
    assert tracing.events() == []


def test_to_chrome_shape_is_json_serializable(tracing):
    with tracing.span("unit.op", cat="test", trace_id="t-1", args={"k": "v"}):
        pass
    evs = tracing.to_chrome(tracing.events())
    x = [e for e in evs if e.get("ph") == "X"]
    assert x, evs
    e = x[0]
    assert e["name"] == "unit.op" and e["cat"] == "test"
    assert e["ts"] > 1e15
    assert e["dur"] >= 1
    assert e["args"]["trace_id"] == "t-1" and e["args"]["k"] == "v"
    json.dumps(evs)


def test_ship_window_rides_the_outbox_once(tracing):
    tracing.ship_window("pipeline.act", "rllib", "t-9", 10.0, 10.5, tid=7,
                        args={"actor": 0, "version": 3})
    ring = tracing.events()
    assert [(e["name"], e["ts"], e["dur"], e["tid"]) for e in ring] == [
        ("pipeline.act", 10.0, 0.5, 7)]
    shipped = tracing.take_shipped()
    assert shipped == [{"name": "pipeline.act", "cat": "rllib", "ph": "X", "pid": ring[0]["pid"],
                        "tid": 7, "ts": 10.0e6, "dur": 0.5e6,
                        "args": {"actor": 0, "version": 3, "trace_id": "t-9"}}]
    assert tracing.take_shipped() == []


def test_tracing_overlap_stats_math(tracing):
    def ev(name, t0, dur):
        return {"name": name, "ph": "X", "ts": t0 * 1e6, "dur": dur * 1e6}

    events = [ev("pipeline.act", 0.0, 1.0),     # [0, 1]
              ev("pipeline.act", 2.0, 1.0),     # [2, 3]
              ev("pipeline.learn", 0.5, 1.0),   # [0.5, 1.5] -> 0.5s overlap
              ev("pipeline.learn", 2.5, 0.25)]  # [2.5, 2.75] -> 0.25s overlap
    s = tracing.overlap_stats(events, "pipeline.act", "pipeline.learn")
    assert s["windows_a"] == 2 and s["windows_b"] == 2
    assert abs(s["busy_a_s"] - 2.0) < 1e-9
    assert abs(s["busy_b_s"] - 1.25) < 1e-9
    assert abs(s["overlap_s"] - 0.75) < 1e-9
    assert abs(s["overlap_fraction"] - 0.6) < 1e-9   # 0.75 / min(2, 1.25)
    s2 = tracing.overlap_stats(events[:1] + events[3:], "pipeline.act", "pipeline.learn")
    assert s2["overlap_s"] == 0.0


def test_bubble_stats_per_tid(tracing):
    def ev(tid, t0, dur, cat="pipeline"):
        return {"name": "pipeline.fwd", "cat": cat, "ph": "X", "tid": tid,
                "ts": t0 * 1e6, "dur": dur * 1e6}

    events = [ev((1, 0), 0.0, 1.0), ev((1, 0), 0.5, 1.0), ev((1, 0), 3.0, 1.0),
              ev((1, 1), 1.0, 2.0), ev((1, 1), 4.0, 1.0), ev((1, 1), 9.0, 1.0, cat="other")]
    s = tracing.bubble_stats(events, extra_cats=("pipeline",))
    w0, w1 = s["workers"][(1, 0)], s["workers"][(1, 1)]
    assert w0["windows"] == 3 and w0["busy_s"] == pytest.approx(2.5)
    assert w0["span_s"] == pytest.approx(4.0) and w0["bubble_fraction"] == pytest.approx(0.375)
    assert w1["windows"] == 2 and w1["bubble_s"] == pytest.approx(1.0)
    assert s["overall"]["bubble_fraction"] == pytest.approx(1 - 5.5 / 8.0)
    assert tracing.bubble_stats(events)["workers"] == {}


def _outputs(tracing, monkeypatch):
    """Every deterministic output of a module on one set of inputs."""
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", "0.37")
    tracing.refresh()
    verdicts = [tracing.trace_id_for(f"k{i}") for i in range(500)]
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", "1.0")
    tracing.refresh()
    tracing.record_span("a", "x", "t-1", 5, 4, 1.0, 0.25, tid=3, args={"n": 1})
    tracing.record_window("b", "y", None, 2.0, 1.5, tid=(9, 1), args={"stage": 1})
    tracing.ship_window("c", "y", "t-2", 3.0, 3.5)
    ring = [{k: v for k, v in e.items() if k not in ("pid", "span_id")}
            for e in tracing.events()]
    chrome = [{k: v for k, v in e.items() if k != "pid"}
              for e in tracing.to_chrome(tracing.events())]
    for e in chrome:
        e.get("args", {}).pop("span_id", None)
    summary = tracing.summary()
    shipped = [{k: v for k, v in e.items() if k != "pid"} for e in tracing.take_shipped()]
    events = [{"name": n, "cat": "pipeline", "ph": "X", "tid": n[-1], "ts": t * 1e6,
               "dur": d * 1e6} for n, t, d in (("f0", 0.0, 1.0), ("f0", 2.0, 0.5),
                                               ("g1", 0.2, 3.0), ("g1", 1.0, 0.1))]
    stats = (tracing.bubble_stats(events, extra_cats=("pipeline",)),
             tracing.overlap_stats(events, "f", "g"))
    tracing.clear()
    return verdicts, ring, chrome, summary, shipped, stats


def test_same_outputs(monkeypatch):
    assert _outputs(ttracing, monkeypatch) == _outputs(jtracing, monkeypatch)


# -- the port's device windows ------------------------------------------------

class _Event:
    """Stand-in for a timing CUDA event: its device time in ms."""

    def __init__(self, ms):
        self.ms, self.waited = ms, False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_device_window_resolves_through_the_anchor(monkeypatch):
    """A window is stored unresolved; the first read waits for its end
    event and places it at anchor_time - (anchor - start) on the axis;
    later reads and the outbox give the same numbers."""
    times = iter([100.0, 103.0, 90.0])       # start, end, anchor (device ms)
    monkeypatch.setattr(ttracing, "_record_event", lambda device: _Event(next(times)))
    clock = ttracing.DeviceClock("cuda:0")
    start = clock.start()
    clock.ship_window("pipeline.fwd", "pipeline", None, start, tid=(1, 0),
                      args={"stage": 0, "mb": 2})
    anchor_ev = _Event(next(times))
    clock._anchor = (5000.0, anchor_ev)       # the anchor event at epoch 5000 s
    (e,) = ttracing.events()
    assert e["ts"] == pytest.approx(5000.0 + 0.010) and e["dur"] == pytest.approx(0.003)
    assert e["tid"] == (1, 0) and e["args"] == {"stage": 0, "mb": 2}
    assert ttracing.events() == [e]
    (s,) = ttracing.take_shipped()
    assert s["ts"] == pytest.approx(e["ts"] * 1e6) and s["dur"] == pytest.approx(3000.0)
    assert "_window" not in s


def test_device_clock_off_creates_no_event(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE", "0")
    ttracing.refresh()
    n = ttracing.DEVICE_EVENTS
    clock = ttracing.DeviceClock("cuda:0")
    start = clock.start()
    assert start is None
    clock.ship_window("pipeline.fwd", "pipeline", None, start)
    assert ttracing.DEVICE_EVENTS == n and ttracing.events() == []
