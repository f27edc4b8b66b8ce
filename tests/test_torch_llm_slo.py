"""The SLO metrics, `embed` and `prefix_digest` of
ray_tpu_torch.serve.llm.LLMServer against ray_tpu.serve.llm on the CPU
(tiny and moe_tiny presets in f32, on the JAX server's own weights).

- util/metrics: histogram_summary and histogram_window of the port's
  registry equal the JAX registry's on the same observations (exact: same
  buckets, same arithmetic).
- stats()["slo"] has JAX's keys, its radix part JAX's values;
  slo_snapshot() counts the requests since its previous call.
- embed equals JAX's embed within 1e-5 relative to the largest |value|.
- prefix_digest packs to the same bytes as JAX's after the same requests.

The registries are process-global (each package has its own), so every
test that counts clears them before it builds a server."""

import asyncio

import jax
import numpy as np
import pytest

from ray_tpu.serve import llm as jllm
from ray_tpu.serve import prefix_digest as jpd
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import prefix_digest as tpd
from ray_tpu_torch.util import metrics as tmetrics

PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14]]
LONG = [int(x) for x in np.random.default_rng(0).integers(1, 256, 70)]
WAVES = [PROMPTS + [LONG], [LONG[:40] + [9, 8, 7, 6, 5], [42] * 20]]
_WEIGHTS = {}


def _cfg(mod, preset="tiny", paged=True, **kw):
    cfg = dict(preset=preset, max_batch_slots=4, max_seq_len=256, prefill_chunk=32,
               decode_chunk=8, seed=0, param_dtype="float32", dtype="float32", **kw)
    if paged:
        cfg.update(paged=True, page_size=16)
    return mod.LLMConfig(**cfg)


def _weights(preset):
    if preset not in _WEIGHTS:
        srv = jllm.LLMServer(_cfg(jllm, preset, paged=False))
        _WEIGHTS[preset] = (srv.params, flax_to_state_dict(jax.device_get(srv.params)))
    return _WEIGHTS[preset]


def _pair(preset="tiny", paged=True):
    jw, tw = _weights(preset)
    return (jllm.LLMServer(_cfg(jllm, preset, paged), params=jw),
            tllm.LLMServer(_cfg(tllm, preset, paged, device="cpu"), params=tw))


def _serve(srv, waves, **kw):
    async def go():
        out = []
        for wave in waves:
            out += await asyncio.gather(*[srv.generate(list(p), **kw) for p in wave])
        return out
    return asyncio.run(go())


@pytest.fixture
def clean_registries():
    jmetrics.clear_registry()
    tmetrics.clear_registry()
    yield
    jmetrics.clear_registry()
    tmetrics.clear_registry()


def test_histogram_summary_and_window_match_jax(clean_registries):
    values = np.random.default_rng(3).lognormal(0.0, 1.5, 400).tolist()
    bounds = [0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10]
    hists = [m.get_or_create(m.Histogram, "h", "x", boundaries=bounds, tag_keys=("engine",))
             for m in (jmetrics, tmetrics)]
    states = [{}, {}]
    for lo, hi in ((0, 150), (150, 150), (150, 400)):
        for v in values[lo:hi]:
            for i, h in enumerate(hists):
                h.observe(v, tags={"engine": "paged" if int(v * 100) % 2 else "dense"})
        got = [m.histogram_window("h", st) for m, st in zip((tmetrics, jmetrics), states)]
        assert got[0] == got[1]
        assert (got[0] is None) == (lo == hi)
    assert tmetrics.histogram_summary("h") == jmetrics.histogram_summary("h")
    assert tmetrics.histogram_summary("h")["count"] == 400
    assert tmetrics.histogram_summary("missing") is None
    for q, b, n in ((0.5, [1, 2, 3], [1, 1, 0, 2]), (0.99, [1], [0, 5])):
        assert tmetrics._bucket_quantile(q, b, n, sum(n)) == jmetrics._bucket_quantile(
            q, b, n, sum(n))
    with pytest.raises(TypeError):
        tmetrics.get_or_create(tmetrics.Counter, "h")


def test_slo_stats_and_snapshot(clean_registries):
    jsrv, tsrv = _pair()
    assert tsrv.slo_snapshot()["ttft_count"] == 0
    _serve(jsrv, WAVES, max_tokens=10)
    _serve(tsrv, WAVES, max_tokens=10)
    js, ts = jsrv.stats(), tsrv.stats()
    assert ts["slo"].keys() == js["slo"].keys()
    assert ts["slo"]["radix"] == js["slo"]["radix"]
    assert ts["slo"]["ttft_s"]["count"] == js["slo"]["ttft_s"]["count"] == 6
    for key in ("batch_occupancy", "kv_page_util"):
        assert ts["slo"][key]["count"] == js["slo"][key]["count"], key
        assert ts["slo"][key]["sum"] == pytest.approx(js["slo"][key]["sum"]), key
    assert ts["slo"]["tpot_ms"]["count"] > 0
    syncs = {m["name"]: m for m in tmetrics.collect()}["serve_decode_host_syncs"]
    assert sum(syncs["values"].values()) == ts["decode"]["host_syncs"]
    snap = tsrv.slo_snapshot()
    assert snap.keys() == jsrv.slo_snapshot().keys()
    assert snap["ttft_count"] == 6 and snap["ttft_p99_s"] is not None
    assert snap["active"] == 0 and snap["free_slots"] == 4
    # the window restarts at every call
    again = tsrv.slo_snapshot()
    assert again["ttft_count"] == 0 and again["ttft_p99_s"] is None
    _serve(tsrv, [PROMPTS[:2]], max_tokens=3)
    assert tsrv.slo_snapshot()["ttft_count"] == 2


@pytest.mark.parametrize("preset", ["tiny", "moe_tiny"])
def test_embed_matches_jax(preset):
    jsrv, tsrv = _pair(preset, paged=False)
    for prompt in (LONG, [5, 6, 7]):
        want = np.asarray(asyncio.run(jsrv.embed(prompt)))
        got = np.asarray(asyncio.run(tsrv.embed(prompt)))
        assert got.shape == want.shape == (64,)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError):
        asyncio.run(tsrv.embed([]))
    with pytest.raises(ValueError):
        asyncio.run(tsrv.embed([1] * 257))


def test_prefix_digest_bytes_match_jax():
    jsrv, tsrv = _pair()
    assert tsrv.prefix_digest()["entries"] == {}
    _serve(jsrv, WAVES, max_tokens=10)
    _serve(tsrv, WAVES, max_tokens=10)
    want, got = jsrv.prefix_digest(), tsrv.prefix_digest()
    assert got["entries"] and tpd.pack(got) == jpd.pack(want)
    assert max(got["entries"].values()) >= 1          # the radix hit counted
    small = tsrv.prefix_digest(max_bytes=tpd.HEADER_BYTES + tpd.ENTRY_BYTES)
    assert tpd.pack(small) == jpd.pack(jsrv.prefix_digest(
        max_bytes=jpd.HEADER_BYTES + jpd.ENTRY_BYTES))
    assert len(small["entries"]) == 1
    hashes = tpd.prompt_chain_hashes(LONG, 16)
    assert hashes == jpd.prompt_chain_hashes(LONG, 16)
    assert tpd.match_depth(got, hashes) == jpd.match_depth(want, hashes) >= 2
    dense = tllm.LLMServer(_cfg(tllm, paged=False, device="cpu"), params=_weights("tiny")[1])
    assert dense.prefix_digest() is None
