"""ray_tpu_torch.models.llama against ray_tpu.models.llama on the CPU, on
the JAX tiny preset's own params carried across by models/convert.py:
logits with no cache (plain and flash attention), with the dense KVCache,
and with the paged cache (chunk-local first chunk, continuation chunk,
decode step). f32 throughout, atol 1e-4 on logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.ops import paged_attention as jpa
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import flax_to_state_dict, init_params
from ray_tpu_torch.ops import paged_attention as tpa

ATOL = 1e-4
_PARAMS = {}


def _pair(attn_impl="auto", **kw):
    """(jax model, jax params, port model) on one set of f32 weights."""
    jcfg = jllama.LlamaConfig.tiny(param_dtype=jnp.float32, dtype=jnp.float32,
                                   attn_impl=attn_impl, **kw)
    jm = jllama.Llama(jcfg)
    key = tuple(sorted(kw.items()))
    if key not in _PARAMS:  # the tree does not depend on attn_impl
        _PARAMS[key] = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = _PARAMS[key]
    tcfg = tllama.LlamaConfig.tiny(param_dtype=torch.float32, dtype=torch.float32,
                                   attn_impl=attn_impl, **kw)
    tm = tllama.Llama(tcfg, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    tm.requires_grad_(False)
    return jm, params, tm


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_logits_no_cache(attn_impl):
    jm, params, tm = _pair(attn_impl)
    toks = _tokens(0, 2, 12)
    want, _ = jm.apply(params, jnp.asarray(toks))
    got, cache = tm(torch.from_numpy(toks))
    assert cache is None and got.dtype == torch.float32
    _close(got, want)


def test_tied_head_and_return_hidden():
    jm, params, tm = _pair(tie_embeddings=True)
    assert not hasattr(tm, "lm_head")
    toks = _tokens(1, 1, 9)
    want, _ = jm.apply(params, jnp.asarray(toks))
    _close(tm(torch.from_numpy(toks))[0], want)
    want_h, _ = jm.apply(params, jnp.asarray(toks), return_hidden=True)
    got_h, _ = tm(torch.from_numpy(toks), return_hidden=True)
    assert got_h.shape == (1, 9, 64)
    _close(got_h, want_h)


def test_dense_kv_cache_prefill_then_decode():
    jm, params, tm = _pair()
    jcfg = jm.cfg
    toks = _tokens(2, 2, 7)
    jc = jllama.KVCache.init(jcfg, 2, 32)
    tc = tllama.KVCache.init(tm.cfg, 2, 32, device="cpu")
    want, jc = jm.apply(params, jnp.asarray(toks), cache=jc)
    got, tc = tm(torch.from_numpy(toks), cache=tc)
    _close(got, want)
    nxt = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)[:, None]
    want, jc = jm.apply(params, jnp.asarray(nxt), cache=jc)
    got, tc = tm(torch.from_numpy(nxt), cache=tc)
    _close(got, want)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    _close(tc.k[1], jc.k[1])


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_paged_cache_chunks_and_decode(attn_impl):
    """Chunk-local first chunk (Pallas flash in interpret mode on the JAX
    side when attn_impl="flash"), a continuation chunk that gathers the
    row's pages, then a decode step through the paged decode path."""
    jm, params, tm = _pair(attn_impl)
    cfg = tm.cfg
    tables = np.array([[3, 1, 4, 0]], np.int32)
    jc = jpa.PagedKVCache.init(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 6, 8, 1, 4,
                               dtype=jnp.float32).replace(block_tables=jnp.asarray(tables))
    tc = tpa.PagedKVCache.init(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 6, 8, 1, 4,
                               dtype=torch.float32, device="cpu")
    tc.block_tables[:] = torch.from_numpy(tables)
    toks = _tokens(3, 1, 20)
    steps = [(toks[:, :12], True), (toks[:, 12:], False)]
    for chunk, local in steps:
        want, jc = jm.apply(params, jnp.asarray(chunk), cache=jc, paged_chunk_local=local)
        got, tc = tm(torch.from_numpy(chunk), cache=tc, paged_chunk_local=local)
        _close(got, want)
    nxt = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)[:, None]
    want, jc = jm.apply(params, jnp.asarray(nxt), cache=jc)
    got, tc = tm(torch.from_numpy(nxt), cache=tc)
    _close(got, want)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    _close(tc.k_pages, jc.k_pages)


def test_convert_keys_layout_and_bf16_bits():
    jcfg = jllama.LlamaConfig.tiny(param_dtype=jnp.bfloat16)
    params = jllama.Llama(jcfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    sd = flax_to_state_dict(jax.device_get(params))
    tm = tllama.Llama(tllama.LlamaConfig.tiny(param_dtype=torch.bfloat16), device="cpu")
    assert set(sd) == set(tm.state_dict())
    wq = np.asarray(params["params"]["layers_0"]["attn"]["wq"]["kernel"])
    assert sd["layers_0.attn.wq.weight"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["layers_0.attn.wq.weight"].float().numpy(),
                                  wq.astype(np.float32).T)
    np.testing.assert_array_equal(sd["embed.embedding"].float().numpy(),
                                  np.asarray(params["params"]["embed"]["embedding"],
                                             np.float32))
    tm.load_state_dict(sd)


def test_seeded_init():
    cfg = tllama.LlamaConfig.tiny()
    a = init_params(tllama.Llama(cfg, device="cpu"), torch.Generator().manual_seed(3))
    b = init_params(tllama.Llama(cfg, device="cpu"), torch.Generator().manual_seed(3))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert torch.equal(a.final_norm.scale, torch.ones(64))
    assert abs(a.embed.embedding.std().item() - 0.02) < 2e-3


@pytest.mark.parametrize("preset", ["tiny", "llama_125m", "llama_1b", "llama_8b",
                                    "llama_70b", "mixtral_8x7b"])
def test_param_count_and_flops(preset):
    jcfg = getattr(jllama.LlamaConfig, preset)()
    tcfg = getattr(tllama.LlamaConfig, preset)()
    assert dataclasses.asdict(tcfg).keys() == dataclasses.asdict(jcfg).keys()
    assert tllama.llama_param_count(tcfg) == jllama.llama_param_count(jcfg)
    assert (tllama.llama_compute_flops(tcfg, 4, 512)
            == jllama.llama_compute_flops(jcfg, 4, 512))


def test_later_slices_raise():
    with pytest.raises(NotImplementedError):
        tllama.Llama(tllama.LlamaConfig.tiny(attn_impl="ring"), device="cpu")
