"""Prompt-lookup speculative decoding in ray_tpu_torch.serve.llm
(`speculate=K`, dense cache) against ray_tpu.serve.llm on the CPU: the
tiny preset in f32 on the JAX server's own weights (models/convert.py).

Greedy ids must equal the JAX spec server's and the port's plain greedy
decode exactly (acceptance means draft == argmax target, so any
divergence is a fault); the acceptance accounting equals JAX's on the same
requests; logprobs within 1e-4 of plain decode. The counterparts of the
ten cases of tests/test_llm_speculative.py."""

import asyncio
import random

import jax
import numpy as np
import pytest

from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.serve import llm as tllm

_WEIGHTS = {}
_JAX = {}


def _cfg(mod, speculate, **kw):
    return mod.LLMConfig(preset="tiny", max_batch_slots=2, max_seq_len=128,
                         speculate=speculate, param_dtype="float32", dtype="float32", **kw)


def _weights():
    if not _WEIGHTS:
        srv = jllm.LLMServer(_cfg(jllm, 0))
        _WEIGHTS["jax"] = srv.params
        _WEIGHTS["torch"] = flax_to_state_dict(jax.device_get(srv.params))
    return _WEIGHTS


def _port(speculate, **kw):
    return tllm.LLMServer(_cfg(tllm, speculate, device="cpu", **kw),
                          params=_weights()["torch"])


def _jax(speculate, fresh=False, **kw):
    """Memoized (greedy decode never consumes the sample key); `fresh` for
    a server whose stats start at zero."""
    key = (speculate, tuple(sorted(kw.items())))
    if fresh or key not in _JAX:
        srv = jllm.LLMServer(_cfg(jllm, speculate, **kw), params=_weights()["jax"])
        if fresh:
            return srv
        _JAX[key] = srv
    return _JAX[key]


def _run(coro):
    return asyncio.run(coro)


def test_lookup_draft():
    ctx = [1, 2, 3, 9, 9, 1, 2, 3]
    assert tllm.LLMServer._lookup_draft(ctx, 2, 3) == [9, 9]
    assert tllm.LLMServer._lookup_draft(ctx, 4, 3) == [9, 9, 1, 2]
    assert tllm.LLMServer._lookup_draft([1, 2, 3], 2, 3) == []
    assert tllm.LLMServer._lookup_draft([4, 5, 6, 7], 2, 3) == []


def test_speculative_matches_plain_greedy_and_jax():
    prompt = [5, 6, 7, 8] * 3
    plain = _run(_port(0).generate(prompt, max_tokens=24))["tokens"]
    spec = _port(4)
    got = _run(spec.generate(prompt, max_tokens=24))["tokens"]
    assert got == plain
    assert got == _run(_jax(4).generate(prompt, max_tokens=24))["tokens"]
    st = spec.stats()["speculation"]
    assert st["spec_ticks"] + st["decode_ticks"] > 0


def test_speculative_accounting_matches_jax():
    """Same requests, same drafts, same acceptances as the JAX engine."""
    prompt = [3, 4, 3, 4, 3, 4, 3, 4]
    spec, jspec = _port(4), _jax(4, fresh=True)
    out = _run(spec.generate(prompt, max_tokens=30))
    want = _run(jspec.generate(prompt, max_tokens=30))
    assert out["tokens"] == want["tokens"] and len(out["tokens"]) == 30
    st = spec.stats()["speculation"]
    assert st == jspec.stats()["speculation"]
    assert 0 <= st["accepted"] <= st["drafted"]
    assert spec.stats()["decode"]["host_syncs"] == jspec.stats()["decode"]["host_syncs"]


def test_speculative_logprobs_match_plain():
    prompt = [5, 6, 7, 8] * 2
    a = _run(_port(0).generate(prompt, max_tokens=12, logprobs=True))
    b = _run(_port(4).generate(prompt, max_tokens=12, logprobs=True))
    assert b["tokens"] == a["tokens"]
    np.testing.assert_allclose(b["logprobs"], a["logprobs"], atol=1e-4)


def test_speculative_sampled_slots_advance_one_per_tick():
    prompt = [5, 6, 7, 8] * 2
    spec = _port(4)

    async def both():
        return await asyncio.gather(spec.generate(prompt, max_tokens=10),
                                    spec.generate(prompt, max_tokens=10, temperature=1.0))
    out_g, out_s = _run(both())
    assert len(out_g["tokens"]) == len(out_s["tokens"]) == 10
    assert out_g["tokens"] == _run(_port(0).generate(prompt, max_tokens=10))["tokens"]
    assert all(0 <= t < 256 for t in out_s["tokens"])


def test_speculative_rejects_paged():
    with pytest.raises(ValueError, match="speculate"):
        tllm.LLMServer(tllm.LLMConfig(preset="tiny", paged=True, speculate=4,
                                      device="cpu"))


def test_speculative_eos_mid_window():
    """An eos accepted inside the window ends the request at the eos."""
    prompt = [5, 6, 7, 8] * 2
    ref = _run(_port(0).generate(prompt, max_tokens=24))["tokens"]
    eos = ref[len(ref) // 2]
    out = _run(_port(4).generate(prompt, max_tokens=24, eos_id=eos))
    assert out["tokens"] == ref[:ref.index(eos)]
    assert out["tokens"] == _run(_jax(4).generate(prompt, max_tokens=24,
                                                 eos_id=eos))["tokens"]


def test_incremental_index_matches_reference_lookup():
    """The engine's per-slot n-gram index, kept by `_emit_one`, agrees with
    `_lookup_draft` on every prefix of a random sequence."""
    srv = _port(4)
    n, K = srv.config.spec_ngram, srv.config.speculate
    rng = random.Random(0)
    seq = [rng.randrange(5) for _ in range(300)]
    slot = srv._make_slot(n + 1, 10 ** 6, None, False, 0.0, None, None, False,
                          prompt_ids=seq[:n + 1])
    slot.ctx = list(seq[:n + 1])
    slot.spec_index = {tuple(slot.ctx[e - n:e]): e for e in range(n, len(slot.ctx))}
    for tok in seq[n + 1:]:
        srv._emit_one(slot, tok, 0.0)
        ctx = slot.ctx
        pos = slot.spec_index.get(tuple(ctx[-n:]))
        via_index = ctx[pos:pos + K] if pos is not None else []
        assert via_index == tllm.LLMServer._lookup_draft(ctx, K, n)


def test_spec_skipped_while_prefill_row_near_cap():
    """The verify forward writes K+1 entries on EVERY row, mid-prefill ones
    included: a prefilling row within K+1 of max_seq_len forces a plain
    tick (the dense write would clamp and overwrite valid KV)."""
    spec = _port(4)
    slot = spec._make_slot(8, 4, None, False, 0.0, None, None, False,
                           prompt_ids=[5, 6, 7, 8] * 2)
    slot.generated = [5, 6]
    spec._active[0] = slot
    assert spec._spec_drafts() is not None
    stuck = spec._make_slot(126, 4, None, False, 0.0, None, None, False)
    spec._prefill_q.append(tllm._PrefillJob(slot_idx=1, slot=stuck,
                                            prompt=np.arange(126, dtype=np.int32),
                                            pos=126 - 1))
    assert spec._spec_drafts() is None
    spec._prefill_q.clear()
    spec._active.clear()


def test_accept_rate_never_exceeds_one():
    prompt = [3, 4] * 8
    spec = _port(4, spec_ngram=2)
    out = _run(spec.generate(prompt, max_tokens=40))
    st = spec.stats()["speculation"]
    assert 0.0 <= st["accept_rate"] <= 1.0
    assert st["accepted"] <= st["drafted"]
    assert out["tokens"] == _run(_jax(4, spec_ngram=2).generate(prompt,
                                                                max_tokens=40))["tokens"]
