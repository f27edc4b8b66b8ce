"""ray_tpu_torch.serve.pd against ray_tpu.serve.pd on the CPU: the port's
counterparts of tests/test_serve_pd.py.

The servers use that file's configuration (tiny preset, 4 slots,
max_seq_len 128, page 16, prefill_chunk 32, seed 3) in f32, and the JAX
prefill server's weights carried across by models/convert.py. Greedy
decoding is exact, so the check is token equality: a PD pipeline (a
prefill engine and a decode engine, KV shipped between them) gives the
ids of one colocated engine with the same weights, in the port and in
JAX's PDServer; logprobs agree with JAX's within 1e-4.

The metrics registries are process-global (one per package), so the
tests read counter deltas."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from ray_tpu.serve import llm as jllm
from ray_tpu.serve import pd as jpd
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import pd as tpd
from ray_tpu_torch.util import metrics as tmetrics


def _cfg(mod, **kw):
    base = dict(preset="tiny", max_batch_slots=4, max_seq_len=128, paged=True,
                page_size=16, prefill_chunk=32, prefix_cache=False, seed=3,
                param_dtype="float32", dtype="float32")
    if mod is tllm:
        base["device"] = "cpu"
    base.update(kw)
    return mod.LLMConfig(**base)


def _build(**kw):
    """(jax (plain, prefill, pd), port (plain, prefill, pd)) on one set of
    weights."""
    jpre = jpd.PrefillServer(_cfg(jllm, **kw))
    jset = (jllm.LLMServer(_cfg(jllm, **kw), params=jpre.params), jpre,
            jpd.PDServer(_cfg(jllm, **kw), params=jpre.params, prefill=jpre))
    sd = flax_to_state_dict(jax.device_get(jpre.params))
    tpre = tpd.PrefillServer(_cfg(tllm, **kw), params=sd)
    tset = (tllm.LLMServer(_cfg(tllm, **kw), params=sd), tpre,
            tpd.PDServer(_cfg(tllm, **kw), params=sd, prefill=tpre))
    return jset, tset


@pytest.fixture(scope="module")
def servers():
    return _build()


def _gen(server, p, **kw):
    return asyncio.run(server.generate(list(p), **kw))


def test_prefill_kv_shapes(servers):
    _, (_, prefill, _) = servers
    out = asyncio.run(prefill.prefill_kv(list(range(2, 39))))
    mc = prefill.model_cfg
    assert out["prompt_len"] == 37
    assert tuple(out["k"].shape) == (mc.n_layers, mc.n_kv_heads, 37, mc.head_dim)
    assert out["v"].shape == out["k"].shape and out["k"].device.type == "cpu"
    assert isinstance(out["token"], int)
    # the prefill slot was released: nothing leaks
    assert prefill.stats()["active"] == 0
    assert prefill.stats()["free_slots"] == 4


def test_prefill_kv_matches_jax(servers):
    (_, jpre, _), (_, tpre, _) = servers
    p = list(range(2, 39))
    want = asyncio.run(jpre.prefill_kv(p))
    got = asyncio.run(tpre.prefill_kv(p))
    assert got["token"] == want["token"]
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=1e-5)


def test_pd_matches_colocated_greedy(servers):
    (_, _, jpdsrv), (plain, _, pd) = servers
    prompts = [list(range(5, 25)), [7, 3, 11] * 9, list(range(60, 100))]
    n0 = pd.pd_requests
    for p in prompts:
        ref = _gen(plain, p, max_tokens=12)
        got = _gen(pd, p, max_tokens=12)
        assert got["tokens"] == ref["tokens"], (p[:4], got, ref)
        assert got["tokens"] == _gen(jpdsrv, p, max_tokens=12)["tokens"]
    assert pd.pd_requests - n0 == len(prompts)
    assert pd.stats()["pd_requests"] == pd.pd_requests


def test_pd_concurrent_requests(servers):
    (_, _, jpdsrv), (plain, _, pd) = servers

    async def many(server):
        outs = await asyncio.gather(*[
            server.generate([i + 2, i + 5, i + 9], max_tokens=8) for i in range(6)])
        return [o["tokens"] for o in outs]

    got = asyncio.run(many(pd))
    assert got == asyncio.run(many(plain)) == asyncio.run(many(jpdsrv))
    # every slot and page returned on both engines
    for s in (plain, pd):
        st = s.stats()
        assert st["active"] == 0 and st["free_slots"] == 4
        assert st["pages_in_use"] == 0


def test_pd_stream_matches_generate(servers):
    _, (plain, _, pd) = servers
    p = list(range(30, 60))

    async def drain():
        return [t async for t in pd.generate_stream(p, max_tokens=7)]

    assert asyncio.run(drain()) == _gen(plain, p, max_tokens=7)["tokens"]


def test_pd_logprobs_and_eos(servers):
    (_, _, jpdsrv), (plain, _, pd) = servers
    p = list(range(30, 50))
    ref = _gen(plain, p, max_tokens=6, logprobs=True)
    got = _gen(pd, p, max_tokens=6, logprobs=True)
    want = _gen(jpdsrv, p, max_tokens=6, logprobs=True)
    assert got["tokens"] == ref["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["logprobs"], ref["logprobs"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=1e-4)
    # eos on the FIRST (prefill-sampled) token truncates to empty
    eos = ref["tokens"][0]
    assert _gen(pd, p, max_tokens=6, eos_id=eos)["tokens"] == []


def test_pd_requires_paged():
    with pytest.raises(ValueError, match="paged"):
        server = tpd.PrefillServer(tllm.LLMConfig(preset="tiny", paged=False,
                                                  max_seq_len=64, device="cpu"))
        asyncio.run(server.prefill_kv([1, 2, 3]))
    with pytest.raises(ValueError, match="paged"):
        tpd.PDServer(tllm.LLMConfig(preset="tiny", paged=False, max_seq_len=64,
                                    device="cpu"))


class _FailingHandle:
    """A prefill handle whose every `.remote()` raises (a replica that
    cannot be reached)."""

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self

    def remote(self, *a, **kw):
        raise ConnectionError("prefill replica unreachable")


@pytest.mark.parametrize("ship", ["1", "0"])
def test_pd_handle_errors_reach_the_request(monkeypatch, ship):
    """A prefill handle whose `.remote()` raises fails the request on both
    hand-offs, as in JAX: nothing falls back to prefill in this process,
    and no slot stays taken."""
    monkeypatch.setenv("RAY_TPU_KV_SHIP", ship)
    pd = tpd.PDServer(_cfg(tllm), prefill=_FailingHandle())
    with pytest.raises(ConnectionError, match="unreachable"):
        _gen(pd, [1, 2, 3], max_tokens=2)
    st = pd.stats()
    assert st["active"] == 0 and st["free_slots"] == 4 and st["prefill"]["chunks"] == 0


def _no_arrays(x, where=""):
    """Control frames carry metadata only: a tensor or an array in a header
    or a segment dict means KV bytes went back into the RPC plane."""
    if isinstance(x, (np.ndarray, torch.Tensor)):
        raise AssertionError(f"array leaked into a control frame at {where}")
    if isinstance(x, dict):
        for k, v in x.items():
            _no_arrays(v, f"{where}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _no_arrays(v, f"{where}[{i}]")


def test_stream_frames_carry_no_kv_bytes(servers):
    _, (_, prefill, _) = servers

    async def drive():
        header = await prefill.prefill_begin(list(range(2, 39)))
        _no_arrays(header, "header")
        have, done = 0, False
        while not done:
            res = await prefill.prefill_wait(header["ship_id"], have)
            _no_arrays(res, "wait")
            have += len(res["segments"])
            done = res["done"]
        assert have >= 1
        await prefill.prefill_drop(header["ship_id"])
        return header

    header = asyncio.run(drive())
    assert header["total_pages"] == 3 and header["prompt_len"] == 37
    assert header["dtype"] == "float32" and header["layout"] == [2, 2, 16, 16]
    assert prefill.stats()["active"] == 0
    assert prefill._ship_writer._sizes == {}   # drop freed every segment


def test_stream_suffix_install_parity():
    """Prefix cache on both sides: the second request, sharing 2 leading
    pages, ships only its suffix and still decodes like colocated; the
    shipment counters move as JAX's do on the same requests."""
    jset, tset = _build(prefix_cache=True)
    p1 = list(range(5, 42))               # 37 tokens -> 3 pages
    p2 = p1[:32] + [91, 92, 93, 94, 95]   # shares the first 2 pages

    def both(server):
        return [_gen(server, p, max_tokens=8)["tokens"] for p in (p1, p2)]

    deltas = []
    for (ref, _, pd), mod in ((jset, jmetrics), (tset, tmetrics)):
        before = mod.kv_ship_counters()
        got = both(pd)
        after = mod.kv_ship_counters()
        assert got == both(ref)
        deltas.append({k: after[k] - before[k] for k in after})
    want, d = deltas
    # the shared prefix pages were never shipped for p2
    assert d["saved_pages"] >= 2
    assert d["pages"] <= 4                 # 3 (p1) + 1 suffix page (p2)
    for key in ("pages", "saved_pages", "segments", "requests", "bytes", "attach_hits"):
        assert d[key] == want[key], key


def test_stream_forced_remote_pull(servers, monkeypatch):
    """RAY_TPU_KV_ATTACH=0 forbids the same-host attach: segments come over
    the KVDataServer's ranged streams."""
    _, (plain, _, pd) = servers
    monkeypatch.setenv("RAY_TPU_KV_ATTACH", "0")
    p = list(range(11, 53))
    before = tmetrics.kv_ship_counters()
    got = _gen(pd, p, max_tokens=10)
    assert got["tokens"] == _gen(plain, p, max_tokens=10)["tokens"]
    after = tmetrics.kv_ship_counters()
    assert after["stream_pulls"] - before["stream_pulls"] >= 1
    assert after["attach_hits"] == before["attach_hits"]


def test_stream_rpc_fetch_fallback(servers, monkeypatch):
    """No attach and no data server: the raw bytes come over the RPC."""
    _, (plain, _, pd) = servers
    monkeypatch.setenv("RAY_TPU_KV_ATTACH", "0")
    monkeypatch.setenv("RAY_TPU_KV_DATA", "0")
    p = list(range(70, 110))
    before = tmetrics.kv_ship_counters()
    got = _gen(pd, p, max_tokens=6)
    assert got["tokens"] == _gen(plain, p, max_tokens=6)["tokens"]
    after = tmetrics.kv_ship_counters()
    assert after["rpc_pulls"] - before["rpc_pulls"] >= 1
    assert after["rpc_fallback_bytes"] > before["rpc_fallback_bytes"]
    assert after["stream_pulls"] == before["stream_pulls"]


def test_legacy_rpc_handoff_escape_hatch(servers, monkeypatch):
    """RAY_TPU_KV_SHIP=0 restores the whole-KV-over-RPC hand-off."""
    (_, _, jpdsrv), (plain, _, pd) = servers
    monkeypatch.setenv("RAY_TPU_KV_SHIP", "0")
    p = [9, 8, 7] * 8
    before = tmetrics.kv_ship_counters()
    got = _gen(pd, p, max_tokens=9)
    assert got["tokens"] == _gen(plain, p, max_tokens=9)["tokens"]
    assert got["tokens"] == _gen(jpdsrv, p, max_tokens=9)["tokens"]
    # the streaming plane was bypassed entirely
    assert tmetrics.kv_ship_counters()["segments"] == before["segments"]


def test_pd_slo_histograms_tagged(servers):
    """PD requests land in the SLO histograms under path=pd (the colocated
    path records path=local)."""
    _, (_, _, pd) = servers
    _gen(pd, list(range(40, 70)), max_tokens=8)

    def series_tags(name):
        m = tmetrics._registry.get(name)
        assert m is not None, f"{name} not registered"
        return [dict(k) for k in m.snapshot()["count"]]

    assert any(t.get("path") == "pd" for t in series_tags("serve_ttft_s"))
    assert any(t.get("path") == "pd" for t in series_tags("serve_tpot_ms"))


def _pd_traces(tracing):
    """The ring's `serve.pd.*` windows and spans as {trace id: [(name,
    args)]} in ring order, and the `serve.decode_chunk` spans' args."""
    traces, chunks = {}, []
    for e in tracing.events():
        if e["name"].startswith("serve.pd."):
            traces.setdefault(e.get("trace_id"), []).append((e["name"], e.get("args")))
        elif e["name"] == "serve.decode_chunk":
            chunks.append(e["args"])
    return traces, chunks


def test_pd_trace_windows_match_jax():
    """JAX's request decomposition, request by request on fresh servers:
    one trace id a request holding the decode side's queue / prefill /
    kv_ship / first_decode windows and the prefill side's prefill_chunk /
    kv_seal spans, in the same order with the same args; the engine's
    decode_chunk spans alike. No timing is compared."""
    from ray_tpu.util import tracing as jtracing
    from ray_tpu_torch.util import tracing as ttracing
    jset, tset = _build()
    prompts = [list(range(5, 25)), list(range(60, 131)), [7, 3, 11] * 9]

    async def one(server, p):
        out = await server.generate(p, max_tokens=6)
        await asyncio.sleep(0.05)     # first_decode's poll records after token 2
        return out

    runs = []
    for (_, _, pd), tracing in ((jset, jtracing), (tset, ttracing)):
        tracing.clear()
        for p in prompts:
            asyncio.run(one(pd, p))
        runs.append(_pd_traces(tracing))
        tracing.clear()
    (want, want_chunks), (got, got_chunks) = runs
    assert None not in got and len(got) == len(want) == len(prompts)
    assert list(got.values()) == list(want.values())
    assert got_chunks == want_chunks and got_chunks
    for seq in got.values():
        names = [n for n, _ in seq]
        assert names[0] == "serve.pd.queue" and names[-1] == "serve.pd.first_decode"
        assert names.count("serve.pd.queue") == names.count("serve.pd.first_decode") == 1
        seal = sum(a["pages"] for n, a in seq if n == "serve.pd.kv_seal")
        shipped = sum(a["pages"] for n, a in seq if n == "serve.pd.kv_ship")
        assert seal == shipped > 0
