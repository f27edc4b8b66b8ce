"""ray_tpu_torch.models.moe and the MoE Llama against ray_tpu's on the CPU,
on flax params carried across by models/convert.py (f32 throughout).

Tolerances: the MoEMLP output and aux loss 1e-5 relative (to the largest
|output|), expert ids equal (a routing flip is an O(1) change, so ids are
compared first, with their own message); model logits ATOL 1e-4 as in
test_torch_llama.py; dropless and permutation checks 1e-6 / 1e-5 absolute.
Also here: the MoE serving engine's greedy ids against the JAX server's,
dense and paged, decode_chunk 1 and 8. The counterparts of
tests/test_moe.py:30-137,178-202."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import flax_to_state_dict, init_params
from ray_tpu_torch.serve import llm as tllm

RTOL = 1e-5
ATOL = 1e-4


def _cfgs(**kw):
    """(jax cfg, port cfg) of the moe_tiny preset in f32 with `kw` over it."""
    jcfg = jllama.LlamaConfig.moe_tiny(dtype=jnp.float32, param_dtype=jnp.float32,
                                       attn_impl="xla", **kw)
    tcfg = tllama.LlamaConfig.moe_tiny(dtype=torch.float32, param_dtype=torch.float32,
                                       attn_impl="xla", **kw)
    return jcfg, tcfg


def _mlp_pair(E=4, K=2, cf=8.0, D=16, F=32, S=8, seed=2):
    """(jax MoEMLP, its params, port MoEMLP on the same weights, x [1,S,D])."""
    kw = dict(d_model=D, ffn_dim=F, n_experts=E, moe_top_k=K, capacity_factor=cf)
    jcfg, tcfg = _cfgs(**kw)
    jm = jmoe.MoEMLP(jcfg)
    x = np.random.default_rng(seed).standard_normal((1, S, D)).astype(np.float32)
    params = {"params": jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]}
    tm = tmoe.MoEMLP(tcfg, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    tm.requires_grad_(False)
    return jm, params, tm, x


def _jax_route(jm, params, x):
    """JAX output, aux loss and top-k expert ids (from the router's captured
    logits, through the same softmax and lax.top_k as moe.py)."""
    y, state = jm.apply(params, jnp.asarray(x), capture_intermediates=True,
                        mutable=["intermediates", "losses"])
    logits = state["intermediates"]["router"]["__call__"][0]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jm.cfg.moe_top_k)
    return np.asarray(y), float(state["losses"]["moe_aux"][0]), np.asarray(idx)


def _port_route(tm, x):
    y = tm(torch.from_numpy(x))
    return y.numpy(), float(tm.aux_loss), tm.last_gate_idx.numpy()


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("E,K,cf,S", [(4, 2, 8.0, 8), (8, 2, 4.0, 24), (4, 1, 2.0, 16)],
                         ids=["e4k2", "e8k2-dropless", "e4k1"])
def test_moe_mlp_matches_jax(E, K, cf, S):
    jm, params, tm, x = _mlp_pair(E=E, K=K, cf=cf, S=S)
    jy, jaux, jidx = _jax_route(jm, params, x)
    ty, taux, tidx = _port_route(tm, x)
    assert np.array_equal(tidx, jidx), f"routing flip: port {tidx.tolist()} jax {jidx.tolist()}"
    assert _rel(ty, jy) <= RTOL
    assert abs(taux - jaux) <= RTOL * abs(jaux)


def test_capacity_drops_match_jax():
    """Training-style capacity (cf 0.25: C = 2 slots per expert for 32
    (token, choice) pairs): the dropped pairs and the zero rows agree with
    JAX."""
    jm, params, tm, x = _mlp_pair(E=4, K=2, cf=0.25, S=16)
    jy, _, jidx = _jax_route(jm, params, x)
    ty, _, tidx = _port_route(tm, x)
    assert np.array_equal(tidx, jidx), "routing flip"
    assert _rel(ty, jy) <= RTOL
    zero_t = np.abs(ty[0]).sum(-1) == 0
    assert np.array_equal(zero_t, np.abs(jy[0]).sum(-1) == 0)
    assert zero_t.any()                      # some token lost both choices
    # the keep mask differs from dropless: drops happened
    _, _, tm_free, _ = _mlp_pair(E=4, K=2, cf=8.0, S=16)
    assert not np.allclose(ty, tm_free(torch.from_numpy(x)).numpy(), atol=1e-6)


def test_single_expert_equals_dense_swiglu():
    _, _, tm, x = _mlp_pair(E=1, K=1, cf=4.0)
    y = tm(torch.from_numpy(x))[0]
    xf = torch.from_numpy(x)[0]
    want = (torch.nn.functional.silu(xf @ tm.w_gate[0]) * (xf @ tm.w_up[0])) @ tm.w_down[0]
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-5)


def test_permutation_equivariance():
    _, _, tm, x = _mlp_pair()
    perm = np.random.default_rng(4).permutation(x.shape[1])
    y = tm(torch.from_numpy(x)).numpy()
    y_perm = tm(torch.from_numpy(np.ascontiguousarray(x[:, perm]))).numpy()
    np.testing.assert_allclose(y[:, perm], y_perm, atol=1e-5)


def test_dropless_token_output_independent_of_batch():
    """Serving capacity (cf = E/K, so C = S): a token's output is the same
    alone or co-batched with 15 others."""
    _, _, tm, x = _mlp_pair(E=4, K=2, cf=2.0, S=16)
    together = tm(torch.from_numpy(x)).numpy()[0]
    for i in (0, 7, 15):
        alone = tm(torch.from_numpy(np.ascontiguousarray(x[:, i:i + 1]))).numpy()[0, 0]
        np.testing.assert_allclose(alone, together[i], atol=1e-6)


@pytest.mark.parametrize("E,K", [(8, 2), (4, 2), (4, 1), (6, 4), (7, 3), (16, 4)])
def test_dropless_capacity_covers_every_token(E, K):
    """C = ceil((E/K) K S / E) must reach S: a float rounding down would drop
    tokens (rounding up to S+1 is harmless). Exact where E/K is."""
    cf = E / K
    for S in range(1, 4097):
        C = tmoe.expert_capacity(cf, K, S, E)
        assert C >= S
        if (E % K == 0) or (2 * E) % K == 0:
            assert C == S, (E, K, S, C)


def test_top_k_ties_go_to_the_lower_index():
    """Experts 1 and 3 get identical router rows (the largest logits), so
    their probs tie exactly; the port's top-2 is [1, 3], as lax.top_k's."""
    _, _, tm, x = _mlp_pair(E=4, K=2, S=8)
    w = torch.zeros(4, 16)
    w[1] = w[3] = torch.from_numpy(np.abs(x[0]).mean(0))
    w[0] = w[2] = -w[1]
    tm.router.weight.data.copy_(w)
    _, _, idx = _port_route(tm, np.abs(x))
    assert (idx == np.array([1, 3])).all(), idx.tolist()
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    _, t_idx = tmoe.top_k_lower_first(probs, 3)
    _, j_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert t_idx.tolist() == np.asarray(j_idx).tolist() == [[0, 1, 2], [1, 3, 0]]


def test_router_stays_f32_under_bf16_params():
    cfg = tllama.LlamaConfig.moe_tiny(param_dtype=torch.bfloat16)
    model = init_params(tllama.Llama(cfg, device="cpu"), torch.Generator().manual_seed(0))
    moe = model.layers_0.moe
    assert moe.router.weight.dtype == torch.float32
    assert moe.w_gate.dtype == torch.bfloat16
    assert abs(moe.router.weight.std().item() - 0.02) < 5e-3


_PAIRS = {}


def _model_pair():
    """(jax Llama, params, port Llama, tokens) of moe_tiny, built once."""
    if not _PAIRS:
        _PAIRS["moe_tiny"] = _build_model_pair()
    return _PAIRS["moe_tiny"]


def _build_model_pair():
    jcfg, tcfg = _cfgs()
    jm = jllama.Llama(jcfg)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    params = {"params": jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]}
    tm = tllama.Llama(tcfg, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params["params"])))
    tm.requires_grad_(False)
    return jm, params, tm, tokens


def test_flax_tree_converts_with_no_moe_case():
    """flax_to_state_dict carries the MoE tree across unchanged in kind: the
    router kernel transposed, the banks in their own layout."""
    jm, params, tm, tokens = _model_pair()
    sd = flax_to_state_dict(jax.device_get(params["params"]))
    want = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    p = params["params"]["layers_0"]["moe"]
    np.testing.assert_array_equal(sd["layers_0.moe.router.weight"].numpy(),
                                  np.asarray(p["router"]["kernel"]).T)
    np.testing.assert_array_equal(sd["layers_0.moe.w_down"].numpy(), np.asarray(p["w_down"]))
    assert "layers_0.mlp.w_gate.weight" not in sd


def test_moe_llama_logits_and_aux_match_jax():
    jm, params, tm, tokens = _model_pair()
    (want, _), state = jm.apply(params, jnp.asarray(tokens), mutable=["losses"])
    got, _ = tm(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    j_aux = float(jmoe.moe_aux_loss(state["losses"], 0.01))
    assert abs(float(tmoe.moe_aux_loss(tm, 0.01)) - j_aux) <= RTOL * j_aux


def test_aux_loss_trains_the_router():
    _, tcfg = _cfgs()
    tm = init_params(tllama.Llama(tcfg, device="cpu"), torch.Generator().manual_seed(0))
    tm(torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 16))))
    aux = tmoe.moe_aux_loss(tm, 1.0)
    assert aux.item() > 0
    aux.backward()
    assert tm.layers_0.moe.router.weight.grad.abs().sum() > 0
    dense = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu")
    assert float(tmoe.moe_aux_loss(dense, 0.01)) == 0.0


def test_decode_matches_prefill():
    _, tcfg = _cfgs(capacity_factor=8.0)
    tm = init_params(tllama.Llama(tcfg, device="cpu"), torch.Generator().manual_seed(0))
    tm.requires_grad_(False)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 12)))
    want, _ = tm(tokens)
    cache = tllama.KVCache.init(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    steps = []
    for t in range(tokens.shape[1]):
        logits, cache = tm(tokens[:, t:t + 1], cache=cache)
        steps.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), want.numpy(), atol=ATOL)


def test_moe_every_interleaves():
    _, tcfg = _cfgs(n_layers=4, moe_every=2)
    tm = tllama.Llama(tcfg, device="cpu")
    keys = tm.state_dict().keys()
    assert "layers_0.moe.w_gate" in keys and "layers_2.moe.w_gate" in keys
    assert "layers_1.mlp.w_gate.weight" in keys and "layers_3.mlp.w_gate.weight" in keys


@pytest.mark.parametrize("preset", ["moe_tiny", "mixtral_8x7b"])
def test_param_count(preset):
    """The count the port's Llama allocates equals llama_param_count (the
    Mixtral check runs on the meta device: no memory)."""
    cfg = getattr(tllama.LlamaConfig, preset)(n_layers=2)
    tm = tllama.Llama(cfg, device="meta")
    assert sum(p.numel() for p in tm.parameters()) == tllama.llama_param_count(cfg)


# ---- serving
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14]]
LONG = [int(x) for x in np.random.default_rng(0).integers(1, 256, 70)]
WAVES = [PROMPTS + [LONG], [LONG[:40] + [9, 8, 7, 6, 5], [42] * 20]]
_WEIGHTS = {}


def _serve_cfg(mod, chunk, paged, **kw):
    cfg = dict(preset="moe_tiny", max_batch_slots=4, max_seq_len=256, prefill_chunk=32,
               decode_chunk=chunk, seed=0, param_dtype="float32", dtype="float32", **kw)
    if paged:
        cfg.update(paged=True, page_size=16)
    return mod.LLMConfig(**cfg)


def _serve(srv, waves, **kw):
    async def go():
        out = []
        for wave in waves:
            out += await asyncio.gather(*[srv.generate(list(p), **kw) for p in wave])
        return out
    return asyncio.run(go())


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_moe_server_greedy_parity_with_jax(paged, chunk):
    if not _WEIGHTS:
        srv = jllm.LLMServer(_serve_cfg(jllm, 1, False))
        _WEIGHTS["jax"] = srv.params
        _WEIGHTS["torch"] = flax_to_state_dict(jax.device_get(srv.params))
    jsrv = jllm.LLMServer(_serve_cfg(jllm, chunk, paged), params=_WEIGHTS["jax"])
    tsrv = tllm.LLMServer(_serve_cfg(tllm, chunk, paged, device="cpu"),
                          params=_WEIGHTS["torch"])
    mc = tsrv.model_cfg
    assert mc.capacity_factor == mc.n_experts / mc.moe_top_k == jsrv.model_cfg.capacity_factor
    want = _serve(jsrv, WAVES, max_tokens=10, logprobs=True)
    got = _serve(tsrv, WAVES, max_tokens=10, logprobs=True)
    for a, b in zip(want, got):
        assert b["tokens"] == a["tokens"]
        np.testing.assert_allclose(b["logprobs"], a["logprobs"], atol=1e-4)
    assert tsrv.stats()["decode"]["chunk_sizes"] == jsrv.stats()["decode"]["chunk_sizes"]
