"""PD with the prefill replica behind a handle: the port's `PDServer`
reaching its `PrefillServer` through `.remote()` calls, as JAX's decode
side reaches a serve `DeploymentHandle` (`ray_tpu/serve/pd.py`
`ShipSource._call`, `PDServer._remote_prefill`).

- In process over a wire stand-in that pickles every call and every reply
  (JAX's `_WirePrefill` of `benchmarks/serving_bench.py`, and the port's
  counterpart below): greedy ids equal the port's colocated server's and
  JAX's `PDServer` over JAX's `_WirePrefill`, on the same flax weights, on
  every rung: the same-host attach, the KV data server
  (`RAY_TPU_KV_ATTACH=0`), the RPC fetch (`RAY_TPU_KV_ATTACH=0
  RAY_TPU_KV_DATA=0`) and the whole-KV hand-off (`RAY_TPU_KV_SHIP=0`). No
  control frame carries an array; `prefill_fetch` returns bytes and
  `prefill_kv` CPU tensors.
- Across a process: chip_smoke's prefill replica (`EngineReplica`
  "prefill", a serve deployment of the port's runtime, as `serve_pd_proc`
  runs it) on the CPU: equal ids, the segments attached in this process,
  none left in /dev/shm.
- Through a real handle: a `ray_tpu.serve` deployment of the port's
  `PrefillServer` under `ray_session`, its `DeploymentHandle` given to the
  port's `PDServer`: equal ids on both hand-offs.

The servers use `test_torch_pd.py`'s configuration (tiny preset, page 16,
f32, seed 3); ids are inside the tiny vocab of 256."""

import asyncio
import importlib.util
import os
import pickle
import signal
from pathlib import Path

import jax
import pytest
import torch

from ray_tpu.serve import llm as jllm
from ray_tpu.serve import pd as jpd
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import pd as tpd
from ray_tpu_torch.util import metrics as tmetrics
from test_torch_pd import _cfg, _no_arrays

PROMPTS = [list(range(5, 25)), [7, 3, 11] * 9, list(range(60, 100))]
MAX_TOKENS = 8
RUNGS = {
    "attach": {},
    "data_server": {"RAY_TPU_KV_ATTACH": "0"},
    "rpc_fetch": {"RAY_TPU_KV_ATTACH": "0", "RAY_TPU_KV_DATA": "0"},
    "whole_kv": {"RAY_TPU_KV_SHIP": "0"},
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def time_limit():
    """Fail (not hang) a runtime test after 300 s."""
    def expire(signum, frame):
        raise TimeoutError("the prefill deployment exceeded its 300 s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(300)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _jax_wire_prefill():
    """JAX's in-process handle stand-in, from benchmarks/serving_bench.py."""
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "serving_bench.py"
    spec = importlib.util.spec_from_file_location("_serving_bench_for_pd", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._WirePrefill


class _WireMethod:
    """One method behind a pickle boundary both ways; every reply is kept
    in `frames` as (method, reply) for the frame checks."""

    def __init__(self, srv, name, frames):
        self._fn, self._name, self._frames = getattr(srv, name), name, frames

    def remote(self, *a, **kw):
        blob = pickle.dumps((a, kw), protocol=5)

        async def go():
            a2, kw2 = pickle.loads(blob)
            out = await self._fn(*a2, **kw2)
            self._frames.append((self._name, out))
            return pickle.loads(pickle.dumps(out, protocol=5))

        return go()


class _Wire:
    """The port's counterpart of JAX's `_WirePrefill`: shaped like a serve
    DeploymentHandle, so `PDServer` takes its handle branch."""

    def __init__(self, srv):
        self.frames = []
        for name in ("prefill_begin", "prefill_wait", "prefill_fetch", "prefill_drop",
                     "prefill_kv"):
            setattr(self, name, _WireMethod(srv, name, self.frames))


@pytest.fixture(scope="module")
def wired():
    """(JAX's PDServer over `_WirePrefill`, the port's colocated server,
    the port's PDServer over `_Wire`, the wire) on one set of weights."""
    jpre = jpd.PrefillServer(_cfg(jllm))
    jpdsrv = jpd.PDServer(_cfg(jllm), params=jpre.params,
                          prefill=_jax_wire_prefill()(jpre))
    sd = flax_to_state_dict(jax.device_get(jpre.params))
    wire = _Wire(tpd.PrefillServer(_cfg(tllm), params=sd))
    return (jpdsrv, tllm.LLMServer(_cfg(tllm), params=sd),
            tpd.PDServer(_cfg(tllm), params=sd, prefill=wire), wire)


def _ids(server, prompts=PROMPTS):
    return [asyncio.run(server.generate(list(p), max_tokens=MAX_TOKENS))["tokens"]
            for p in prompts]


def _delta(before):
    after = tmetrics.kv_ship_counters()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("rung", list(RUNGS))
def test_pd_over_a_wire_handle_matches_colocated_and_jax(wired, monkeypatch, rung):
    jpdsrv, plain, pd, wire = wired
    for k, v in RUNGS[rung].items():
        monkeypatch.setenv(k, v)
    del wire.frames[:]
    before = tmetrics.kv_ship_counters()
    got = _ids(pd)
    moved = _delta(before)
    assert got == _ids(plain) == _ids(jpdsrv)
    assert all(0 <= t < 256 for ids in got for t in ids)
    pulls = {"attach": "attach_hits", "data_server": "stream_pulls", "rpc_fetch": "rpc_pulls"}
    if rung in pulls:
        assert moved[pulls[rung]] >= len(PROMPTS), moved
        assert sum(moved[k] for k in pulls.values()) == moved["segments"], moved
        assert (moved["rpc_fallback_bytes"] > 0) == (rung == "rpc_fetch")
    else:
        assert moved["segments"] == 0 and moved["requests"] == 0, moved
    # what crossed the wire: metadata in the control frames, bytes from a
    # fetch, CPU tensors from the whole-KV hand-off
    names = {name for name, _ in wire.frames}
    assert names == ({"prefill_kv"} if rung == "whole_kv" else
                     {"prefill_begin", "prefill_wait", "prefill_drop"}
                     | ({"prefill_fetch"} if rung == "rpc_fetch" else set()))
    for name, out in wire.frames:
        if name == "prefill_fetch":
            assert isinstance(out, (bytes, bytearray))
        elif name == "prefill_kv":
            assert out["k"].device.type == out["v"].device.type == "cpu"
            _no_arrays({k: v for k, v in out.items() if k not in ("k", "v")}, name)
        else:
            _no_arrays(out, name)
    st = pd.stats()
    assert st["active"] == 0 and st["free_slots"] == 4 and st["prefill"]["chunks"] == 0


def test_pd_with_prefill_in_a_child_process(time_limit):
    """chip_smoke's prefill replica on the CPU: the PrefillServer in a
    replica process of the port's runtime, reached through the serve
    deployment's handle, every call and reply pickled by the runtime. The
    ids equal the colocated server's on the attach rung, over the
    replica's KV data server and over the whole-KV hand-off; the segments
    are attached in this process and sealed in the replica; none is left
    after it closes its shipping and its app is deleted."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve as tserve
    from chip_smoke import engine_deployment, state_digest
    plain = tllm.LLMServer(_cfg(tllm))
    sd = plain.model.state_dict()
    rt.init(num_cpus=2, num_gpus=1)
    try:
        proc = tserve.run(engine_deployment("prefill").bind(
            "prefill", _cfg(tllm), params=sd), name="pd-child")
        call = lambda name: getattr(proc, name).remote().result(timeout_s=120)
        assert call("binding")["pid"] != os.getpid() and call("digest") == state_digest(sd)
        pd = tpd.PDServer(_cfg(tllm), params=sd, prefill=proc)
        mine = tmetrics.kv_ship_counters()
        theirs = call("ship_counters")
        want = _ids(plain)
        assert _ids(pd) == want
        moved = _delta(mine)
        sealed = {k: v - theirs[k] for k, v in call("ship_counters").items()}
        assert moved["attach_hits"] == sealed["segments"] >= len(PROMPTS)
        assert moved["segments"] == 0 and sealed["rpc_fallback_bytes"] == 0
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RAY_TPU_KV_ATTACH", "0")
            before = tmetrics.kv_ship_counters()
            assert _ids(pd, PROMPTS[:1]) == want[:1]
            assert _delta(before)["stream_pulls"] >= 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RAY_TPU_KV_SHIP", "0")
            assert _ids(pd, PROMPTS[1:2]) == want[1:2]
        assert pd.stats()["active"] == 0 and call("stats")["active"] == 0
        assert pd.stats()["prefill"]["chunks"] == 0
        announced = call("close_shipping")
        tserve.delete("pd-child")
    finally:
        tserve.shutdown()
        rt.shutdown()
    assert announced and not [n for n in announced if os.path.exists(f"/dev/shm/{n}")]


def test_pd_through_a_serve_deployment_handle(ray_session, time_limit):
    """A `ray_tpu.serve` deployment of the port's PrefillServer: its
    DeploymentHandle is the PDServer's prefill replica, on the streaming
    plane and the whole-KV hand-off."""
    from ray_tpu import serve
    plain = tllm.LLMServer(_cfg(tllm))
    sd = plain.model.state_dict()
    app = serve.deployment(tpd.PrefillServer, name="torch_prefill").bind(_cfg(tllm), sd)
    handle = serve.run(app, name="torch-pd")
    try:
        pd = tpd.PDServer(_cfg(tllm), params=sd, prefill=handle)
        assert not isinstance(handle, tpd.PrefillServer)
        want = _ids(plain)
        before = tmetrics.kv_ship_counters()
        assert _ids(pd) == want
        assert _delta(before)["attach_hits"] >= len(PROMPTS)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RAY_TPU_KV_SHIP", "0")
            assert _ids(pd, PROMPTS[:1]) == want[:1]
        assert pd.stats()["active"] == 0 and pd.stats()["prefill"]["chunks"] == 0
        assert pd.stats()["pd_requests"] == len(PROMPTS) + 1
    finally:
        serve.delete("torch-pd")
