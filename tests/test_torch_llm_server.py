"""ray_tpu_torch.serve.llm.LLMServer against ray_tpu.serve.llm.LLMServer on
the CPU, on the JAX server's own f32 tiny-preset weights carried across by
models/convert.py: greedy token ids identical, logprobs within 1e-4 and the
same host-sync count, for the dense and the paged cache and decode_chunk 1
and 8. The prompts are those of tests/test_llm_decode_chunk.py, one longer
than prefill_chunk (a multi-chunk prefill) and, in a second wave, one
sharing two full pages with it (a radix prefix hit on the paged cache).

Also here: the port-only surface (sampling, streaming, reconfigure), the
configurations that are refused (tp > 1, a later slice; speculation on the
paged cache), the default device, and the import hygiene of the port (an
AST scan: no jax, flax or ray_tpu)."""

import ast
import asyncio
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.serve import llm as tllm

REPO = Path(__file__).resolve().parent.parent
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14]]
LONG = [int(x) for x in np.random.default_rng(0).integers(1, 256, 70)]
WAVES = [PROMPTS + [LONG], [LONG[:40] + [9, 8, 7, 6, 5], [42] * 20]]
_WEIGHTS = {}
_JAX_SERVERS = {}


def _cfg(mod, chunk, paged, **kw):
    cfg = dict(preset="tiny", max_batch_slots=4, max_seq_len=256, prefill_chunk=32,
               decode_chunk=chunk, seed=0, param_dtype="float32", dtype="float32", **kw)
    if paged:
        cfg.update(paged=True, page_size=16)
    return mod.LLMConfig(**cfg)


def _weights():
    """One JAX init, shared by every server in this file (both packages)."""
    if not _WEIGHTS:
        srv = jllm.LLMServer(_cfg(jllm, 1, False))
        _WEIGHTS["jax"] = srv.params
        _WEIGHTS["torch"] = flax_to_state_dict(jax.device_get(srv.params))
    return _WEIGHTS


def _jax(chunk, paged):
    """Memoized per (chunk, paged): greedy decode never consumes the sample
    key, so a reused JAX server gives the same tokens (and its jit variants
    compile once)."""
    if (chunk, paged) not in _JAX_SERVERS:
        _JAX_SERVERS[chunk, paged] = jllm.LLMServer(_cfg(jllm, chunk, paged),
                                                    params=_weights()["jax"])
    return _JAX_SERVERS[chunk, paged]


def _port(chunk=8, paged=True, **kw):
    return tllm.LLMServer(_cfg(tllm, chunk, paged, device="cpu", **kw),
                          params=_weights()["torch"])


def _serve(srv, waves, **kw):
    async def go():
        out = []
        for wave in waves:  # a wave starts once the previous one finished
            out += await asyncio.gather(*[srv.generate(list(p), **kw) for p in wave])
        return out
    return asyncio.run(go())


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_parity_with_jax_server(paged, chunk):
    jsrv = _jax(chunk, paged)
    tsrv = _port(chunk, paged)
    want = _serve(jsrv, WAVES, max_tokens=10, logprobs=True)
    got = _serve(tsrv, WAVES, max_tokens=10, logprobs=True)
    for a, b in zip(want, got):
        assert b["tokens"] == a["tokens"]
        np.testing.assert_allclose(b["logprobs"], a["logprobs"], atol=1e-4)
    js, ts = jsrv.stats(), tsrv.stats()
    assert ts["decode"]["host_syncs"] == js["decode"]["host_syncs"]
    assert ts["decode"]["tokens"] == js["decode"]["tokens"]
    assert ts["decode"]["chunk_sizes"] == js["decode"]["chunk_sizes"]
    if paged:
        assert ts["prefix_hit_tokens"] == js["prefix_hit_tokens"] == 32
        for key in ("pages_in_use", "pages_free", "prefix_cached_pages",
                    "prefix_query_tokens"):
            assert ts[key] == js[key], key
        assert ts["radix"] == {k: v for k, v in js["radix"].items() if k != "stash"}
        assert ts["prefill"]["chunk_local"] == len(PROMPTS) + 2


def test_eos_and_budget_stop_like_jax():
    jsrv = _jax(8, True)
    tsrv = _port(8, True)
    ref = _serve(tsrv, [[PROMPTS[0]]], max_tokens=12)[0]["tokens"]
    eos = ref[5]
    kw = dict(max_tokens=12, eos_id=eos)
    want = _serve(jsrv, [PROMPTS], **kw)
    got = _serve(tsrv, [PROMPTS], **kw)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert got[0]["tokens"] == ref[:ref.index(eos)]


def test_stream_matches_generate():
    srv = _port(8, True)

    async def drain(p):
        return [t async for t in srv.generate_stream(list(p), max_tokens=9)]

    async def go():
        return await asyncio.gather(*[drain(p) for p in PROMPTS])
    streamed = asyncio.run(go())
    assert streamed == [r["tokens"] for r in _serve(_port(8, True), [PROMPTS],
                                                    max_tokens=9)]


def test_sampling_is_seeded_and_in_vocab():
    kw = dict(max_tokens=10, temperature=1.3, top_p=0.9, top_k=20)
    a = _serve(_port(8, True), [PROMPTS], **kw)
    b = _serve(_port(8, True), [PROMPTS], **kw)
    assert [r["tokens"] for r in a] == [r["tokens"] for r in b]
    assert all(0 <= t < 256 for r in a for t in r["tokens"])
    # top_k=1 keeps only the argmax: sampling reduces to greedy
    greedy = _serve(_port(8, True), [PROMPTS], max_tokens=10)
    top1 = _serve(_port(8, True), [PROMPTS], max_tokens=10, temperature=0.7, top_k=1)
    assert [r["tokens"] for r in top1] == [r["tokens"] for r in greedy]


def test_reconfigure_decode_chunk():
    srv = _port(1, False)
    srv.reconfigure({"decode_chunk": 8})
    assert srv.config.decode_chunk == 8
    with pytest.raises(ValueError):
        srv.reconfigure({"decode_chunk": 0})


@pytest.mark.parametrize("kw,exc", [(dict(tp=2), NotImplementedError),
                                    (dict(speculate=2, paged=True), ValueError)],
                         ids=["tp", "speculate-paged"])
def test_later_slices_raise(kw, exc, monkeypatch):
    """tp > 1 is a later slice; speculation on the paged cache is refused
    for good, as in the JAX engine, before any weight or page allocation."""
    def no_alloc(*a, **k):
        raise AssertionError("allocated before the config check")
    monkeypatch.setattr(tllm, "Llama", no_alloc)
    monkeypatch.setattr(tllm.PagedKVCache, "init", no_alloc)
    cfg = dict(preset="tiny", device="cpu")
    cfg.update(kw)
    with pytest.raises(exc):
        tllm.LLMServer(tllm.LLMConfig(**cfg))


def test_kv_stash_demotion_raises(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SPILL_KV", "1")
    with pytest.raises(NotImplementedError):
        tllm.LLMServer(tllm.LLMConfig(preset="tiny", paged=True, device="cpu"))


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tllm.LLMConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllm.LLMServer(tllm.LLMConfig())


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_flax_or_ray_tpu():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu")
    bad = [(str(f.relative_to(REPO)), mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in banned]
    assert bad == []
