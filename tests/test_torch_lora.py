"""ray_tpu_torch.models.lora against ray_tpu.models.lora on the CPU (tiny
preset, f32): the targets, the exact no-op at init, adapter-only training
with the base frozen, merge for serving, orphan factors raising, and the
scale kept out of the optimizer. A JAX adapter carried across by
`flax_lora_to_port` merges into the weights JAX's `merge_lora` gives
(1e-6 absolute), and the merged model serves with JAX's greedy ids. The
counterparts of tests/test_lora.py:27-131,173-200."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from ray_tpu.models import llama as jllama
from ray_tpu.models import lora as jlora
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import lora as tlora
from ray_tpu_torch.models.convert import flax_lora_to_port, flax_to_state_dict
from ray_tpu_torch.serve import llm as tllm

_BASE = {}


def _base():
    """(jax model, jax params, port model, port state_dict, tokens), f32."""
    if not _BASE:
        jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32,
                                       attn_impl="xla")
        jm = jllama.Llama(jcfg)
        tokens = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
        tm = tllama.Llama(tllama.LlamaConfig.tiny(dtype=torch.float32,
                                                  param_dtype=torch.float32,
                                                  attn_impl="xla"), device="cpu")
        sd = flax_to_state_dict(jax.device_get(params))
        tm.load_state_dict(sd)
        tm.requires_grad_(False)
        _BASE.update(jm=jm, params=params, tm=tm, sd=tm.state_dict(),
                     tokens=torch.from_numpy(tokens).long())
    return _BASE


def _lora(rank=4, seed=1, **kw):
    return tlora.init_lora(torch.Generator().manual_seed(seed), _base()["sd"], rank=rank, **kw)


def _logits(sd, tokens):
    return functional_call(_base()["tm"], sd, (tokens,))[0]


def test_targets_cover_attn_and_ffn_as_jax():
    b = _base()
    targets = tlora.lora_targets(b["sd"])
    assert any(t.endswith("wq.weight") for t in targets)
    assert any(t.endswith("w_down.weight") for t in targets)
    assert not any("embed" in t or "norm" in t or "lm_head" in t for t in targets)
    want = [p[len("params/"):-len("/kernel")].replace("/", ".") + ".weight"
            for p in jlora.lora_targets(b["params"])]
    assert sorted(targets) == sorted(want)


def test_moe_banks_and_router_are_not_targets():
    m = tllama.Llama(tllama.LlamaConfig.moe_tiny(), device="meta")
    targets = tlora.lora_targets(m.state_dict())
    assert targets and not any(".moe." in t for t in targets)


def test_init_is_exact_noop():
    b = _base()
    eff = tlora.apply_lora(b["sd"], _lora())
    assert torch.equal(_logits(eff, b["tokens"]), _logits(b["sd"], b["tokens"]))


def test_adapter_is_tiny():
    n_base = sum(v.numel() for v in _base()["sd"].values())
    assert tlora.lora_param_count(_lora()) < n_base / 5


def _lm_loss(sd, tokens):
    logits = _logits(sd, tokens[:, :-1])
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             tokens[:, 1:].reshape(-1))


def test_train_adapter_base_frozen():
    """Gradients flow through apply_lora into the factors only; the loss
    falls while the base never changes."""
    b = _base()
    base_snapshot = {k: v.clone() for k, v in b["sd"].items()}
    lora = _lora(rank=8, alpha=16.0)
    opt = torch.optim.Adam(tlora.lora_parameters(lora), lr=1e-2)
    losses = []
    for _ in range(12):
        loss = _lm_loss(tlora.apply_lora(b["sd"], lora), b["tokens"])
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.05, losses
    for k, v in b["sd"].items():
        assert torch.equal(v, base_snapshot[k]), k
    assert next(iter(lora["factors"].values()))["b"].abs().sum() > 0


def test_merge_equals_functional():
    b = _base()
    lora = _lora(seed=2)
    with torch.no_grad():
        for f in tlora.lora_parameters(lora):
            f.add_(0.01)
    merged = tlora.merge_lora(b["sd"], lora)
    with torch.no_grad():
        out_f = _logits(tlora.apply_lora(b["sd"], lora), b["tokens"])
        out_m = _logits(merged, b["tokens"])
        out_b = _logits(b["sd"], b["tokens"])
    np.testing.assert_allclose(out_f.numpy(), out_m.numpy(), atol=1e-6)
    assert not np.allclose(out_b.numpy(), out_m.numpy())
    assert all(not v.requires_grad for v in merged.values())


def test_mismatched_adapter_raises():
    lora = _lora()
    lora["factors"] = {"wrong.root." + k: v for k, v in lora["factors"].items()}
    with pytest.raises(ValueError, match="no param path"):
        tlora.apply_lora(_base()["sd"], lora)


def test_scale_is_not_a_trainable_tensor():
    """AdamW's decoupled weight decay shrinks every tensor it is given; the
    optimizer gets lora_parameters, so scale stays fixed while the factors
    move."""
    b = _base()
    lora = _lora(alpha=16.0)
    before = lora["scale"].item()
    assert not any(t is lora["scale"] for t in tlora.lora_parameters(lora))
    opt = torch.optim.AdamW(tlora.lora_parameters(lora), lr=1e-2, weight_decay=0.1)
    a0 = next(iter(lora["factors"].values()))["a"].detach().clone()
    for _ in range(3):
        loss = _logits(tlora.apply_lora(b["sd"], lora), b["tokens"]).square().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert lora["scale"].item() == before == 4.0
    assert not torch.equal(next(iter(lora["factors"].values()))["a"], a0)


def _jax_adapter():
    """A JAX adapter with real content (b moved off zero)."""
    b = _base()
    lora = jlora.init_lora(jax.random.PRNGKey(3), b["params"], rank=4)
    lora["factors"] = jax.tree_util.tree_map(lambda x: x + 0.01, lora["factors"])
    return lora


def test_jax_adapter_merges_to_jax_weights():
    b = _base()
    jl = _jax_adapter()
    want = flax_to_state_dict(jax.device_get(jlora.merge_lora(b["params"], jl)))
    got = tlora.merge_lora(b["sd"], flax_lora_to_port(jax.device_get(jl)))
    assert got.keys() == want.keys()
    n_changed = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-6, err_msg=k)
        n_changed += not torch.equal(w, b["sd"][k])
    assert n_changed == len(jl["factors"])


def test_merged_jax_adapter_serves_like_jax():
    """JAX's merged tree served by the JAX engine, and the port's merge of
    the same adapter served by the port's: identical greedy ids."""
    b = _base()
    jl = _jax_adapter()
    cfg = dict(preset="tiny", max_batch_slots=2, max_seq_len=64, param_dtype="float32",
               dtype="float32")
    jsrv = jllm.LLMServer(jllm.LLMConfig(**cfg), params=jlora.merge_lora(b["params"], jl))
    tsrv = tllm.LLMServer(tllm.LLMConfig(device="cpu", **cfg),
                          params=tlora.merge_lora(b["sd"], flax_lora_to_port(
                              jax.device_get(jl))))
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5, 4]]

    async def serve(srv):
        return await asyncio.gather(*[srv.generate(p, max_tokens=8) for p in prompts])
    want = [r["tokens"] for r in asyncio.run(serve(jsrv))]
    got = [r["tokens"] for r in asyncio.run(serve(tsrv))]
    assert got == want
    base = tllm.LLMServer(tllm.LLMConfig(device="cpu", **cfg), params=b["sd"])
    assert [r["tokens"] for r in asyncio.run(serve(base))] != got
