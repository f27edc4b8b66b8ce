"""Sampling and prefix caching of ray_tpu_torch.serve.llm.LLMServer against
ray_tpu.serve.llm.LLMServer on the CPU: the port's counterparts of the 11
cases of tests/test_llm_sampling.py (top-p and top-k support of the
first-token sampler, logprobs, a batch of mixed temperatures, prefix-cache
hits and divergent tails, a 3-chunk paged prompt against the dense cache,
prefix pages under a concurrent decode, and the three PageManager cases).

Both packages serve the tiny preset in f32 on one set of weights: JAX's
seed-0 init, carried across by models/convert.py. Greedy ids are equal,
logprobs agree within 1e-4 (as tests/test_torch_llm_server.py holds them),
the prefix-cache tallies are equal, and the two PageManagers give the same
pages and hits for the same sequence of calls. The samplers draw from
different generators, so their top-p and top-k cases compare the set of
tokens drawn."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import paged_attention as jpa
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve import llm as tllm

_WEIGHTS = {}


def _run(coro):
    return asyncio.run(coro)


def _cfg(mod, **kw):
    base = dict(preset="tiny", max_batch_slots=2, max_seq_len=128,
                param_dtype="float32", dtype="float32")
    if mod is tllm:
        base["device"] = "cpu"
    base.update(kw)
    return mod.LLMConfig(**base)


def _weights():
    """One JAX init, shared by every server in this file (both packages)."""
    if not _WEIGHTS:
        srv = jllm.LLMServer(_cfg(jllm))
        _WEIGHTS["jax"] = srv.params
        _WEIGHTS["torch"] = flax_to_state_dict(jax.device_get(srv.params))
    return _WEIGHTS


def _pair(**kw):
    """(JAX server, port server) with one configuration and one set of weights."""
    w = _weights()
    return (jllm.LLMServer(_cfg(jllm, **kw), params=w["jax"]),
            tllm.LLMServer(_cfg(tllm, **kw), params=w["torch"]))


@pytest.fixture(scope="module")
def servers():
    return _pair()


def _draws(servers, logits, n, temp, top_p, top_k):
    """The sets of first tokens each package's sampler draws in `n` tries."""
    jsrv, tsrv = servers
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    want = {int(jsrv._sample_first(jl, jax.random.PRNGKey(i), jnp.float32(temp),
                                   jnp.float32(top_p), jnp.int32(top_k))[0])
            for i in range(n)}
    got = {tsrv._sample_first(tl, temp, top_p, top_k)[0] for _ in range(n)}
    return want, got


def test_top_p_restricts_support(servers):
    """With a peaked distribution and a small top_p, sampling never draws
    outside the nucleus; with top_p=1 and a hot temperature it ranges wider.
    The port draws the same support as JAX's sampler in both."""
    logits = np.array([5.0, 4.9, -5.0, -5.0, -6.0, -8.0], np.float32)
    want, tight = _draws(servers, logits, 200, 1.0, 0.6, 0)
    # nucleus at p=0.6: tokens {0, 1} carry the mass needed
    assert tight == want == {0, 1}, (tight, want)
    want, wide = _draws(servers, logits, 200, 5.0, 1.0, 0)
    assert wide == want and len(wide) > 2, (wide, want)


def test_top_k_and_greedy(servers):
    jsrv, tsrv = servers
    logits = np.array([3.0, 2.9, 2.8, -9.0], np.float32)
    want, draws = _draws(servers, logits, 100, 2.0, 1.0, 2)
    assert draws == want == {0, 1}, (draws, want)        # top-k=2 support
    jtok, jlogp = jsrv._sample_first(jnp.asarray(logits), jax.random.PRNGKey(0),
                                     jnp.float32(0.0), jnp.float32(1.0), jnp.int32(0))
    tok, logp = tsrv._sample_first(torch.from_numpy(logits), 0.0, 1.0, 0, logprobs=True)
    assert tok == int(jtok) == 0                          # temperature 0: argmax
    # the logprob is the raw distribution's log-softmax of the chosen token
    assert abs(logp - float(torch.log_softmax(torch.from_numpy(logits), -1)[0])) < 1e-5
    assert abs(logp - float(jlogp)) < 1e-5


def test_generate_returns_logprobs(servers):
    jsrv, tsrv = servers
    want = _run(jsrv.generate([5, 6, 7], max_tokens=6, logprobs=True))
    out = _run(tsrv.generate([5, 6, 7], max_tokens=6, logprobs=True))
    assert len(out["logprobs"]) == len(out["tokens"]) == 6
    assert all(lp <= 0.0 for lp in out["logprobs"])
    assert out["tokens"] == want["tokens"]
    np.testing.assert_allclose(out["logprobs"], want["logprobs"], atol=1e-4)


def test_per_request_params_mix(servers):
    """Greedy and hot-temperature requests share the batch: greedy stays
    deterministic while its neighbour samples, and equals JAX's greedy ids
    in the same mix."""
    async def go(server):
        a, b = await asyncio.gather(
            server.generate([1, 2, 3, 4], max_tokens=8, temperature=0.0),
            server.generate([1, 2, 3, 4], max_tokens=8, temperature=3.0, top_p=0.95))
        c = await server.generate([1, 2, 3, 4], max_tokens=8, temperature=0.0)
        return a, b, c

    jsrv, tsrv = servers
    ja, _, _ = _run(go(jsrv))
    a, b, c = _run(go(tsrv))
    assert a["tokens"] == c["tokens"] == ja["tokens"]
    assert len(b["tokens"]) == 8


def _paged_pair(prefix_cache=True, **kw):
    return _pair(max_seq_len=256, paged=True, page_size=16, prefix_cache=prefix_cache,
                 **kw)


def _prefix_stats(server):
    s = server.stats()
    return s["prefix_hit_tokens"], s["prefix_cached_pages"]


def test_prefix_cache_hits_and_matches_uncached():
    """A second request with the same prompt skips its full prompt pages
    and gives IDENTICAL greedy output; ids and hit tallies equal JAX's at
    every step."""
    prompt = list(range(40))  # 2.5 pages of 16: 2 full pages cacheable
    outs = []
    for srv in _paged_pair():
        out1 = _run(srv.generate(prompt, max_tokens=8))
        s1 = _prefix_stats(srv)
        out2 = _run(srv.generate(prompt, max_tokens=8))
        s2 = _prefix_stats(srv)
        out3 = _run(srv.generate([99, 98, 97], max_tokens=4))
        assert s1 == (0, 2)
        assert s2[0] == 32
        assert out2["tokens"] == out1["tokens"]
        assert len(out3["tokens"]) == 4
        outs.append((out1["tokens"], out3["tokens"], s1, s2, _prefix_stats(srv)))
    assert outs[1] == outs[0]


def test_prefix_cache_shared_prefix_divergent_tails():
    """Requests sharing only a prefix reuse exactly the shared full pages;
    divergent tails do not cross-contaminate (outputs equal a no-cache
    server's, and JAX's)."""
    base = list(range(32))
    p1 = base + [70, 71, 72]
    p2 = base + [80, 81]
    got = []
    for srv in _paged_pair(prefix_cache=True):
        a1 = _run(srv.generate(p1, max_tokens=6))
        a2 = _run(srv.generate(p2, max_tokens=6))
        assert srv.stats()["prefix_hit_tokens"] == 32
        got.append((a1["tokens"], a2["tokens"]))
    assert got[1] == got[0]
    _, ref = _paged_pair(prefix_cache=False)   # the same weights, no cache
    assert got[1][0] == _run(ref.generate(p1, max_tokens=6))["tokens"]
    assert got[1][1] == _run(ref.generate(p2, max_tokens=6))["tokens"]


class _Managers:
    """JAX's PageManager and the port's, driven by the same calls: every
    call returns the same value (page rows, hits) from both and leaves the
    same `cached_pages`."""

    def __init__(self, **kw):
        self.mgrs = (jpa.PageManager(**kw), tpa.PageManager(**kw))

    def __getattr__(self, op):
        def call(*args):
            want, got = (getattr(m, op)(*args) for m in self.mgrs)
            assert got == want, (op, args, got, want)
            assert self.mgrs[1].cached_pages == self.mgrs[0].cached_pages, (op, args)
            return got
        return call

    @property
    def cached_pages(self):
        return self.mgrs[1].cached_pages


def test_prefix_cache_eviction_under_pressure():
    """A small pool evicts LRU refcount-0 cached pages instead of failing
    admission."""
    mgr = _Managers(num_pages=9, page_size=4, batch_slots=2, max_pages_per_seq=8,
                    prefix_cache=True)
    prompt = list(range(13))  # 3 full pages and one token
    row, cached = mgr.allocate_prefix(0, prompt, 16)
    assert cached == 0
    mgr.register_prefix(0, prompt)
    assert mgr.cached_pages == 3
    mgr.free(0)
    assert mgr.cached_pages == 3  # parked in the LRU, not freed
    row, cached = mgr.allocate_prefix(0, prompt, 16)
    assert cached == 12
    mgr.free(0)
    # pool pressure: a big unrelated request evicts cached pages
    row2, cached2 = mgr.allocate_prefix(1, list(range(100, 128)), 32)
    assert cached2 == 0
    assert mgr.cached_pages < 3
    mgr.free(1)


def test_prefix_cache_never_shares_partial_pages():
    mgr = _Managers(num_pages=16, page_size=8, batch_slots=2, max_pages_per_seq=8,
                    prefix_cache=True)
    mgr.allocate_prefix(0, list(range(8)), 16)
    mgr.register_prefix(0, list(range(8)))
    assert mgr.cached_pages == 1
    # full coverage would leave no token to prefill
    _, cached2 = mgr.allocate_prefix(1, list(range(8)), 16)
    assert cached2 == 0
    mgr.free(0)
    mgr.free(1)


def test_paged_multichunk_prefill_matches_dense():
    """Paged prefill chunks after the first read the earlier chunks' pages:
    a 3-chunk prompt decodes as on the dense cache, and as JAX's paged
    server."""
    prompt = [(7 * i + 3) % 250 for i in range(90)]  # 3 chunks of 32
    jpaged, paged = _pair(max_seq_len=256, paged=True, page_size=16, prefill_chunk=32,
                          prefix_cache=False)
    _, dense = _pair(max_seq_len=256, prefill_chunk=32)
    a = _run(paged.generate(prompt, max_tokens=8))
    b = _run(dense.generate(prompt, max_tokens=8))
    want = _run(jpaged.generate(prompt, max_tokens=8))
    assert a["tokens"] == b["tokens"] == want["tokens"], (a, b, want)


def test_prefix_pages_survive_concurrent_decode():
    """While another request decodes, a prefix-hit admission must not let
    the per-tick KV write land garbage in a SHARED page: the slot's length
    points past the cached prefix from admission on. Ids equal JAX's under
    the same traffic."""
    prompt = list(range(40))

    async def go(srv):
        async def busy_stream():
            return [t async for t in srv.generate_stream(list(range(200, 230)),
                                                         max_tokens=60)]

        ta = asyncio.create_task(busy_stream())
        await asyncio.sleep(0.2)          # the stream is decoding
        out1 = await srv.generate(prompt, max_tokens=6)   # registers pages
        out2 = await srv.generate(prompt, max_tokens=6)   # prefix hit, mid-decode
        return out1, out2, await ta

    got = []
    for srv in _paged_pair():
        out1, out2, stream = _run(go(srv))
        assert srv.stats()["prefix_hit_tokens"] >= 32
        assert out2["tokens"] == out1["tokens"]
        assert _run(srv.generate(prompt, max_tokens=6))["tokens"] == out1["tokens"]
        got.append((out1["tokens"], stream))
    assert got[1] == got[0]


def test_lru_eviction_spares_borrowed_prefix_pages():
    """Under pool pressure the LRU evicts parked (refcount-0) pages only;
    prefix pages a live slot borrowed are pinned and survive intact."""
    mgr = _Managers(num_pages=11, page_size=4, batch_slots=3, max_pages_per_seq=8,
                    prefix_cache=True)
    a = list(range(9))             # 2 full pages registerable
    b = list(range(50, 59))
    for slot, p in ((0, a), (1, b)):
        _, cached = mgr.allocate_prefix(slot, p, 9)
        assert cached == 0
        mgr.register_prefix(slot, p)
        mgr.free(slot)
    assert mgr.cached_pages == 4

    _, cached = mgr.allocate_prefix(0, a, 12)
    assert cached == 8
    assert mgr.shared_page_count(0) == 2
    assert len(mgr.table_slice(0, 0, 3)) == 3  # the PD extraction unit
    for m in mgr.mgrs:
        with pytest.raises(IndexError):
            m.table_slice(0, 2, 5)   # past the allocation

    # 10 usable pages: slot 0 holds A's 2 borrowed + 1 fresh, B's 2 are
    # parked, 5 free; a 7-page request evicts both of B's, never A's
    _, cached2 = mgr.allocate_prefix(1, list(range(100, 128)), 28)
    assert cached2 == 0
    assert mgr.cached_pages == 2
    mgr.free(1)
    mgr.free(0)

    _, hit = mgr.allocate_prefix(0, a, 9)
    assert hit == 8
    mgr.free(0)
    _, miss = mgr.allocate_prefix(1, b, 9)
    assert miss == 0
    mgr.free(1)
